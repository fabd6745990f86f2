"""The tracked ADMM's share of its roofline, in %: the sum over the traced
calls of ``proposed_admm`` and ``proposed_admm_angles`` (the ``tracked_admm``
spans) of each call's least time (``perfbench/roofline_tracked.py``, from
its shapes, the SVT on the thin side) over the sum of their CUDA-event
times."""
from perfbench import roofline_tracked


def read(record):
    calls = [s for s in record.spans if s.name == "tracked_admm"]
    spent = sum(s.seconds for s in calls)
    if not calls or spent <= 0:
        return None
    return 100.0 * roofline_tracked.sweep_bound_s([s.attrs for s in calls]) / spent
