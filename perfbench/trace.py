"""What a ``--trace 1`` run reads: the benchmark's own spans, and the device trace.

:func:`spans` wraps, for as long as it is open, the calls that a point
makes into its layers on the fused and on the tracked route, as module
attributes of the program, so that ``run_point`` goes through the wrappers,
and restores them on exit:

- the front end, a host-clock span between two synchronisations: on the
  fused route ``harness.pipeline.proposed_problem``, named ``frontend``; on
  the tracked route ``harness.pipeline.point_draws``, named ``draws``, and
  then ``harness.pipeline._proposed_frontend`` (the dictionaries and the
  hyper-parameters of the draws), named ``frontend``.  A wrapped call made
  inside another one (the fused front end's own draws, where it runs
  eagerly) is the outer span's;
- the solve, two CUDA events around the call and the shapes it was given
  (B, N, M, Gr, K, Imax and whether it takes the oracle support ``rank``):
  ``kernels.admm_fused.fused_tracked_admm``, named ``fused_admm``, and on
  the tracked route ``harness.pipeline.proposed_admm`` and
  ``proposed_admm_angles``, named ``tracked_admm``.  A timed call made
  inside another (the tracked solve's launch of the fused kernel on the
  transpose) is the outer span's;
- the baselines' solves, two CUDA events around each call and its batch B:
  ``harness.pipeline.ls_estimate``, ``vamp_mmwave`` and ``omp_mmv``, each
  named after its function; their branch's draws (``point_draws`` in
  ``realization_errors``) are a ``draws`` span on either route.

On a fused point the tracked route's three record nothing, and on a
tracked point the fused route's two are not called; a point of the
proposed pair alone calls none of the baselines'.

:func:`device_stretch` runs a stretch of points under ``torch.profiler`` and
reduces its trace to the union of the device's kernel, copy and set
intervals within the stretch, the kernels that took most time, and the
longest idle gaps by the host operation that was running when each began.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import inspect
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
STRETCH = "perfbench.stretch"
TOP = 10  # entries in each list of the breakdown
NAME_CHARS = 120


@dataclasses.dataclass
class Span:
    name: str
    seconds: float
    attrs: Dict[str, object]


@contextlib.contextmanager
def spans(out: List[Span]):
    """Record the layer spans of every point run inside the block into ``out``."""
    from jstsp19_torch.harness import pipeline
    from jstsp19_torch.kernels import admm_fused

    pending: List[Tuple[str, torch.cuda.Event, torch.cuda.Event, Dict[str, object]]] = []
    depth = [0]  # host spans open: a call inside another host span's call is the outer one's
    timing = [0]  # timed spans open, the same for them

    def host(name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if depth[0]:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                result = fn(*args, **kwargs)
            finally:
                depth[0] -= 1
            torch.cuda.synchronize()
            out.append(Span(name, time.perf_counter() - t0, {}))
            return result
        return wrapper

    def timed(name, fn, shapes):
        """CUDA events around each call of ``fn``; ``shapes(args)``: the
        call's attributes, from its arguments by name."""
        signature = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if timing[0]:
                return fn(*args, **kwargs)
            bound = signature.bind(*args, **kwargs)
            bound.apply_defaults()
            attrs = shapes(bound.arguments)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            timing[0] += 1
            try:
                result = fn(*args, **kwargs)
            finally:
                timing[0] -= 1
            end.record()
            pending.append((name, start, end, attrs))
            return result
        return wrapper

    def solve(ranked):
        """The solve's shapes; ``ranked(args)``: whether it takes the oracle support."""
        def shapes(a):
            Bt, N, M = a["subY"].shape
            return dict(B=Bt, N=N, M=M, Gr=a["A"].shape[-1], K=a["B"].shape[-2], Imax=a["Imax"], rank=ranked(a))
        return shapes

    def batch(arg):
        return lambda a: dict(B=a[arg].shape[0])

    def given(a):
        return a["support_rank"] is not None

    wrappers = {
        (pipeline, "proposed_problem"): host("frontend", pipeline.proposed_problem),
        (pipeline, "point_draws"): host("draws", pipeline.point_draws),
        (pipeline, "_proposed_frontend"): host("frontend", pipeline._proposed_frontend),
        (admm_fused, "fused_tracked_admm"): timed("fused_admm", admm_fused.fused_tracked_admm, solve(given)),
        (pipeline, "proposed_admm"): timed("tracked_admm", pipeline.proposed_admm, solve(given)),
        (pipeline, "proposed_admm_angles"): timed("tracked_admm", pipeline.proposed_admm_angles,
                                                  solve(lambda a: True)),
        (pipeline, "ls_estimate"): timed("ls_estimate", pipeline.ls_estimate, batch("Y")),
        (pipeline, "vamp_mmwave"): timed("vamp_mmwave", pipeline.vamp_mmwave, batch("Y_hbf")),
        (pipeline, "omp_mmv"): timed("omp_mmv", pipeline.omp_mmv, batch("A")),
    }
    for (module, name), wrapper in wrappers.items():
        setattr(module, name, wrapper)
    try:
        yield
    finally:
        for (module, name), wrapper in wrappers.items():
            fn = wrapper.__wrapped__
            setattr(module, name, fn)
            # a function that counts on the name it is bound to (``fused_tracked_admm.launches``) counted on the
            # wrapper while it was
            fn.__dict__.update((k, v) for k, v in wrapper.__dict__.items() if k != "__wrapped__")
        torch.cuda.synchronize()
        out.extend(Span(name, s.elapsed_time(e) / 1e3, attrs) for name, s, e, attrs in pending)


@dataclasses.dataclass
class DeviceTrace:
    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _host_label(ops: List[Tuple[float, float, str]], starts: List[float], t: float) -> str:
    """The innermost host operation running at time ``t``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 400, -1), -1):
        a, b, name = ops[j]
        if a <= t < b:
            return name
    return "host, between operations"


def reduce_trace(events: List[dict]) -> Optional[DeviceTrace]:
    """The device's activity within the stretch of a chrome trace's events,
    or None where the trace holds no stretch or no device activity in it."""
    stretch = [e for e in events if e.get("ph") == "X" and e.get("name") == STRETCH
               and e.get("cat") == "user_annotation"]
    if not stretch:
        return None
    t0, t1 = stretch[0]["ts"], stretch[0]["ts"] + stretch[0]["dur"]
    device, by_name = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if b > a:
            device.append((a, b))
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) / 1e6
    if not device:
        return None
    busy = _union(device)
    ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver"))
    starts = [a for a, _, _ in ops]
    gaps: Dict[str, float] = {}
    edges = [t0] + [x for interval in busy for x in interval] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            label = _host_label(ops, starts, a)
            gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6

    def top(d):
        return [[name[:NAME_CHARS], s] for name, s in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return DeviceTrace(busy_s=sum(b - a for a, b in busy) / 1e6, window_s=(t1 - t0) / 1e6,
                       device_ops=top(by_name), idle_gaps=top(gaps))


def device_stretch(run: Callable[[], None]) -> DeviceTrace:
    """Run ``run()`` under ``torch.profiler`` and reduce its trace; raises
    where the profiler delivered no device activity."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            run()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    reduced = reduce_trace(events)
    if reduced is None:
        raise RuntimeError("torch.profiler delivered no device activity in the traced stretch")
    return reduced
