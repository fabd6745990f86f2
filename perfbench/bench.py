"""One run of one cell: set-up, the measured window or the traced stretches, the check.

:func:`run_cell` does everything but look for the chip, so that a test can
drive a whole run on the CPU at a small size.  The window runs points back
to back, one client, each a call of the program's ``run_point`` that ends
with its NMSE on the host, until ``seconds`` have passed; a rate is taken
over all the points and all the time of the window.  A traced run runs,
instead, a stretch of whole sweep passes under ``torch.profiler`` (the
device's busy share) and then passes under the layer spans until
``seconds`` have passed in all.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench import cells, check, trace
from perfbench.traffic import Point, Schedule

PROFILED_SECONDS = 0.5  # the profiled stretch: whole passes until this long


@dataclasses.dataclass
class PointTime:
    k: int
    position: int
    seconds: float
    realizations: int


@dataclasses.dataclass
class Record:
    """What the metric readers read."""

    setup_s: float
    window_s: float  # the measured window, or the span stretch of a traced run
    points: List[PointTime]
    spans: List[trace.Span]
    device: Optional[trace.DeviceTrace]


def _run_points(system, points, seconds: float, whole_passes: bool, size: int
                ) -> Tuple[List[Tuple[Point, Dict[str, np.ndarray]]], List[PointTime], float]:
    """Run points back to back until ``seconds`` have passed (and, with
    ``whole_passes``, the sweep's pass is complete)."""
    done, times = [], []
    start = time.perf_counter()
    for pt in points:
        t0 = time.perf_counter()
        answers = system.run_point(pt)
        t1 = time.perf_counter()
        done.append((pt, answers))
        times.append(PointTime(pt.k, pt.position, t1 - t0, pt.n_mc))
        if t1 - start >= seconds and (not whole_passes or pt.position == size - 1):
            return done, times, t1 - start


def run_cell(cell: cells.Cell, system, seed: int, seconds: float, traced: bool, t0: float) -> dict:
    """One run; returns the result line's content.  ``t0``: the process's
    start on ``time.time()``'s clock."""
    cuda = system.device.type == "cuda"
    schedule = Schedule(cell.config, cell.traffic)
    warmups = schedule.warmups()
    check.follows(system, warmups, schedule.svt_method)
    for pt in warmups:
        system.run_point(pt)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - t0

    points = schedule.window()
    device_trace, spans = None, []
    if traced:
        profiled: list = []

        def stretch():
            profiled.extend(_run_points(system, points, PROFILED_SECONDS, True, schedule.size)[0])

        t_start = time.perf_counter()
        device_trace = trace.device_stretch(stretch)
        with trace.spans(spans):
            done, times, window_s = _run_points(system, points, seconds - (time.perf_counter() - t_start), True,
                                                schedule.size)
        done = profiled + done
    else:
        done, times, window_s = _run_points(system, points, seconds, False, schedule.size)

    memory_peak = torch.cuda.max_memory_allocated(system.device) if cuda else 0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    correct, checks = check.run(system, done, seed, cell.limits)

    record = Record(setup_s, window_s, times, spans, device_trace)
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = cells.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = sum(pt.n_mc for pt, _ in done)
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": sum(check.answer_faults(pt, a)[1] for pt, a in done),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else system.device.type,
            "kind": torch.cuda.get_device_name(system.device) if cuda else system.device.type,
            "count": cell.chips,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if device_trace is not None:
        result["device"]["busy_s"] = device_trace.busy_s
        result["device"]["window_s"] = device_trace.window_s
        result["breakdown"] = {"device_ops": device_trace.device_ops, "idle_gaps": device_trace.idle_gaps}
    result["checks"] = checks
    return result
