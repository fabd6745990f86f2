"""The fused ADMM's share of its roofline, in %: the sum over the traced
calls of ``fused_tracked_admm`` of each call's least time
(``perfbench/roofline.py``, from its shapes) over the sum of their CUDA-event
times."""
from perfbench import roofline


def read(record):
    calls = [s for s in record.spans if s.name == "fused_admm"]
    spent = sum(s.seconds for s in calls)
    if not calls or spent <= 0:
        return None
    return 100.0 * roofline.sweep_bound_s([s.attrs for s in calls]) / spent
