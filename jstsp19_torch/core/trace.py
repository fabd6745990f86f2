"""Spans of the port's layers, kept in memory while :func:`recording` is open.

``with span("frontend"):`` marks the work of one layer.  Outside
:func:`recording` (the default) :func:`span` returns one shared object that
does nothing: it reads no clock, allocates nothing and makes no CUDA call.
Inside, each span records a :class:`Span`: its name, its id, its parent's
id, the id of the ``point`` span it lies in (every span of one
``harness.runner.run_point`` call shares it), its start and end on the
host's ``time.perf_counter_ns()`` and its attributes.  While a profiler
records, it also opens ``torch.profiler.record_function("jstsp19.<name>")``,
so that the span is a ``user_annotation`` event on the trace's own clock,
beside the kernels and runtime calls it caused; without one it leaves the
range out, which would cost more than the rest of the span.

The spans of a fused point (``run_point``'s route 'fused'): ``point``
(attributes ``sweep_index``, ``n_mc``, ``route``, and at its end
``realizations``, ``launches``, the change of ``kernels.launch_counts()``
over the point, ``captures`` and ``replays``, the change of
``harness.frontend_graph.problem``'s CUDA-graph counts, and
``transposed``, the change of ``solvers.admm_transposed.solve.calls``)
holds ``frontend``, per method ``solve`` (``pack`` and ``launch`` on the
card; ``launch``'s attribute ``threads`` is the kernel's block size, whose
512-thread launches the ``launches`` counter also reads as
``fused_tracked_admm_512``) and ``nmse``, and ``to_host``.  ``frontend`` holds ``draws``, ``oracle_rank`` and
``dictionaries`` where the front end runs eagerly (and, on the card, at a
shape's first two points: the second captures them), ``replay`` (the CUDA
graph of that work) where it replays, and either way ``hyperparams`` (ρ's
eigenvalues; τ_Y, τ_S and the Gram before them are ``frontend``'s own
eagerly and in the graph when replayed).

The spans of a tracked point (route 'tracked', where N = Mr_e > M = T·Nt or
where ``svt_method`` names it; ``harness.pipeline.realization_errors``) use
the same names: ``point`` holds ``draws`` (``point_draws``), ``frontend``
(``_proposed_frontend``, which holds ``dictionaries`` and
``hyperparams``), per proposed method ``solve`` (``method``, ``route``, B,
N, M, Gr, K, Imax; ``proposed_admm`` or ``proposed_admm_angles``) and
``nmse``, and ``to_host``.  On the card an N > M solve with the
kernels in float32 is one ``fused_tracked_admm`` launch on the transpose
(``solvers/admm_transposed.py``): ``solve`` holds ``pack`` and
``launch``, and the ``launches`` counter reads ``fused_tracked_admm`` once
a solve and ``transposed`` one a solve.  Another tracked solve runs
eagerly, and its ``launches`` counter shows the unfused route's kernels:
``dict_correlation`` and ``soft_threshold`` launch once an iteration each,
Imax times a solve.  One thread records: the recorder is the process's, as
the profiler is.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, List, Optional

import torch

PREFIX = "jstsp19."  # the profiler range of span ``name`` is ``PREFIX + name``
POINT = "point"


@dataclasses.dataclass
class Span:
    name: str
    id: int
    parent: Optional[int]  # the id of the span open when this one opened
    point: Optional[int]  # the id of the ``point`` span this one lies in (its own, for a point)
    start_ns: int
    end_ns: int
    attrs: Dict[str, object]

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Off:
    """The span outside :func:`recording`: it enters, exits and takes
    attributes, and does nothing."""

    __slots__ = ()
    on = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Recorder:
    def __init__(self):
        self.spans: List[Span] = []  # finished, in the order they ended
        self.open: List[Span] = []
        self.next_id = 0


class _On:
    """A span inside :func:`recording`."""

    __slots__ = ("_recorder", "_span", "_range")
    on = True

    def __init__(self, recorder: _Recorder, name: str, attrs: Dict[str, object]):
        parent = recorder.open[-1] if recorder.open else None
        sid = recorder.next_id
        recorder.next_id += 1
        point = sid if name == POINT else (parent.point if parent else None)
        self._recorder = recorder
        self._span = Span(name, sid, parent.id if parent else None, point, 0, 0, attrs)
        self._range = torch.profiler.record_function(PREFIX + name) if torch.autograd._profiler_enabled() else None

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        self._recorder.open.append(self._span)
        self._span.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._span.end_ns = time.perf_counter_ns()
        self._recorder.open.pop()
        self._recorder.spans.append(self._span)
        if self._range is not None:
            self._range.__exit__(*exc)
        return None

    def set(self, **attrs) -> None:
        """Add attributes, such as counts known only at the span's end."""
        self._span.attrs.update(attrs)


_RECORDER: Optional[_Recorder] = None


def span(name: str, **attrs):
    """A context manager that records the block as span ``name`` while
    :func:`recording` is open, and does nothing otherwise.  What it returns
    has ``on`` (whether it records) and ``set(**attrs)``."""
    recorder = _RECORDER
    if recorder is None:
        return _OFF
    return _On(recorder, name, attrs)


@contextlib.contextmanager
def recording() -> Iterator[List[Span]]:
    """Record every span opened inside the block; yields the list of
    finished spans, complete when the block ends."""
    global _RECORDER
    outer, _RECORDER = _RECORDER, _Recorder()
    spans = _RECORDER.spans
    try:
        yield spans
    finally:
        _RECORDER = outer
