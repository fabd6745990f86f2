"""The port's own spans on the profiler's clock: a stretch of points, and its trace reduced by span.

    python3 -m perfbench.program_trace --workload <name> --seed <n> [--turns 2] [--seconds 5]

:func:`program_stretch` runs a stretch of points under ``torch.profiler`` and
the port's ``jstsp19_torch.core.trace.recording()`` together, so that each
span of the port (``point``, ``frontend``, ``solve``, ...) is a ``jstsp19.*``
user annotation on the trace's own clock.  :func:`reduce_program` reduces
the stretch's chrome trace by span:

- nesting: the annotations give the span tree, and each runtime or driver
  call is placed in the innermost span open when it began;
- launches: each call is matched by ``args.correlation`` to the device work
  it enqueued; a call matched to a kernel is a launch, and the device time
  of its work goes to the call's span;
- synchronisations: the calls of ``SYNC_CALLS``, which block the host until
  the device has done its work;
- idle gaps: as ``perfbench/trace.py::reduce_trace`` takes them (the gaps in
  the union of the device's kernel, copy and set intervals within the
  stretch), each put down to the innermost span open on the host when it
  began, or to ``OUTSIDE``.

:meth:`ProgramTrace.per_point` gives, per point of the stretch, the five
numbers of the layers that the trace tells apart: ``frontend_launches``,
``frontend_idle_ms``, ``pipeline_idle_ms``, ``host_syncs`` and
``solve_pack_ms``.

Run as a tool, on the card, it warms the cell up as a run does, runs a
stretch of whole passes (``bench.PROFILED_SECONDS``) under both recorders,
prints the ``[trace]`` table on standard error (one row per span, each value
per point), then times windows of ``--seconds`` with the port's recording
off and on in turns (off, on, on, off, ``--turns`` times), checks the
answers computed with recording on against the plain reference, and prints
one JSON line.  Without a card it exits 2.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import json
import os
import statistics
import sys
import tempfile
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from perfbench import bench, cells, check
from perfbench.trace import DEVICE_CATEGORIES, _union
from perfbench.traffic import Point, Schedule

PREFIX = "jstsp19."  # the port's annotations: ``jstsp19_torch/core/trace.py::PREFIX``
STRETCH = "perfbench.program"
OUTSIDE = "(outside a point)"
HOST_CALLS = ("cuda_runtime", "cuda_driver")
SYNC_CALLS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize",
})


@dataclasses.dataclass
class Totals:
    count: int = 0  # spans of this name
    host_self_s: float = 0.0  # their host time less their child spans'
    launches: int = 0  # kernel launches made inside them
    device_s: float = 0.0  # device time of the work those calls enqueued
    syncs: int = 0  # calls that blocked the host on the device
    sync_s: float = 0.0  # host time inside those calls
    idle_s: float = 0.0  # device idle time in gaps that began inside them

    def add(self, other: "Totals") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))


@dataclasses.dataclass
class ProgramTrace:
    window_s: float
    idle_s: float  # the stretch's idle time, from the union of device intervals
    launches: int  # the stretch's kernel launches
    unmatched_kernels: int  # kernels of the stretch that no host call of the stretch launched
    points: int  # whole ``point`` spans in the stretch
    own: Dict[str, Totals]  # by span name, and OUTSIDE: each call and gap in its innermost span
    inclusive: Dict[str, Totals]  # by span name: with the span's children
    recorded: list = dataclasses.field(default_factory=list)  # the port's own records of the stretch's spans

    def per_point(self) -> Dict[str, Optional[float]]:
        """The five numbers of the layers, each per point of the stretch; None
        where the stretch holds no point (or, for ``solve_pack_ms``, the
        port's records no ``pack`` span)."""
        names = ("frontend_launches", "frontend_idle_ms", "pipeline_idle_ms", "host_syncs", "solve_pack_ms")
        point, frontend = self.inclusive.get("point"), self.inclusive.get("frontend", Totals())
        if not self.points or point is None:
            return dict.fromkeys(names)
        n = self.points
        packs = [s.seconds for s in self.recorded if s.name == "pack"]
        recorded_points = sum(s.name == "point" for s in self.recorded)
        return dict(
            frontend_launches=frontend.launches / n,
            frontend_idle_ms=1e3 * frontend.idle_s / n,
            pipeline_idle_ms=1e3 * (point.idle_s - frontend.idle_s) / n,
            host_syncs=point.syncs / n,
            solve_pack_ms=1e3 * sum(packs) / recorded_points if packs and recorded_points else None,
        )


    def counters(self) -> Dict[str, object]:
        """The port's own counters of its ``point`` spans, per point: the
        realizations solved and each hand-written kernel's launches."""
        points = [s.attrs for s in self.recorded if s.name == "point"]
        if not points:
            return {}
        kernels = sorted({k for a in points for k in a.get("launches", {})})
        return dict(realizations=sum(a.get("realizations", 0) for a in points) / len(points),
                    launches={k: sum(a.get("launches", {}).get(k, 0) for a in points) / len(points) for k in kernels})


def _tree(events: List[dict], t0: float, t1: float) -> Tuple[List[Tuple[float, float, str]], List[int]]:
    """The program's spans within [t0, t1] in the order they began, and the
    index of each one's parent (-1 for none)."""
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(PREFIX) and t0 <= e["ts"] and e["ts"] + e["dur"] <= t1),
                   key=lambda s: (s[0], -s[1]))
    parents: List[int] = []
    open_: List[int] = []
    for i, (a, _, _) in enumerate(spans):
        while open_ and spans[open_[-1]][1] <= a:
            open_.pop()
        parents.append(open_[-1] if open_ else -1)
        open_.append(i)
    return spans, parents


def _innermost(spans, parents, starts: List[float], t: float) -> int:
    """The index of the innermost span open at time ``t``, or -1."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and not spans[i][0] <= t < spans[i][1]:
        i = parents[i]
    return i


def reduce_program(events: List[dict]) -> Optional[ProgramTrace]:
    """The program stretch of a chrome trace's events reduced by span, or
    None where the trace holds no stretch or no program span in it."""
    stretch = [e for e in events if e.get("ph") == "X" and e.get("name") == STRETCH
               and e.get("cat") == "user_annotation"]
    if not stretch:
        return None
    t0, t1 = stretch[0]["ts"], stretch[0]["ts"] + stretch[0]["dur"]
    spans, parents = _tree(events, t0, t1)
    if not spans:
        return None
    starts = [a for a, _, _ in spans]
    own = [Totals() for _ in range(len(spans) + 1)]  # the last: outside every span

    device, work = [], {}  # work: correlation -> [kernel?, device seconds]
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            w = work.setdefault(corr, [False, 0.0])
            w[0] |= e["cat"] == "kernel"
            w[1] += e["dur"] / 1e6
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if b > a:
            device.append((a, b))
    launched = set()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in HOST_CALLS or not t0 <= e["ts"] < t1:
            continue
        slot = own[_innermost(spans, parents, starts, e["ts"])]
        corr = e.get("args", {}).get("correlation")
        if corr in work:
            launched.add(corr)
            slot.launches += int(work[corr][0])
            slot.device_s += work[corr][1]
        if e["name"] in SYNC_CALLS:
            slot.syncs += 1
            slot.sync_s += e["dur"] / 1e6
    unmatched = sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "kernel" and t0 <= e["ts"] < t1
                    and e.get("args", {}).get("correlation") not in launched)

    busy = _union(device)
    edges = [t0] + [x for interval in busy for x in interval] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            own[_innermost(spans, parents, starts, a)].idle_s += (b - a) / 1e6

    for i, (a, b, _) in enumerate(spans):
        own[i].count = 1
        own[i].host_self_s += (b - a) / 1e6
        if parents[i] >= 0:
            own[parents[i]].host_self_s -= (b - a) / 1e6
    inclusive = [dataclasses.replace(t) for t in own]
    for i in range(len(spans) - 1, -1, -1):  # children begin after their parents
        if parents[i] >= 0:
            inclusive[parents[i]].add(inclusive[i])

    by_own: Dict[str, Totals] = {}
    by_inclusive: Dict[str, Totals] = {}
    for i, (_, _, name) in enumerate(spans):
        by_own.setdefault(name, Totals()).add(own[i])
        j = parents[i]
        while j >= 0 and spans[j][2] != name:
            j = parents[j]
        if j < 0:  # no enclosing span of the same name, whose total holds this one already
            by_inclusive.setdefault(name, Totals()).add(inclusive[i])
    by_own[OUTSIDE] = own[-1]
    return ProgramTrace(
        window_s=(t1 - t0) / 1e6,
        idle_s=(t1 - t0 - sum(b - a for a, b in busy)) / 1e6,
        launches=sum(1 for corr in launched if work[corr][0]),
        unmatched_kernels=unmatched,
        points=sum(1 for _, _, name in spans if name == "point"),
        own=by_own,
        inclusive=by_inclusive,
    )


def program_stretch(run: Callable[[], None]) -> Optional[ProgramTrace]:
    """Run ``run()`` under ``torch.profiler`` and the port's span recorder
    and reduce its trace; None where the port has no span recorder."""
    try:
        from jstsp19_torch.core import trace as program
    except ImportError:
        return None
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with program.recording() as recorded:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(STRETCH):
                run()
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench-program-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    reduced = reduce_program(events)
    if reduced is not None:
        reduced.recorded = list(recorded)
    return reduced


COLUMNS = ("count", "host self ms", "launches", "device ms", "syncs", "sync ms", "idle ms")


def table(program: ProgramTrace) -> List[Tuple[str, Tuple[float, ...]]]:
    """One row a span name, and OUTSIDE: each of ``COLUMNS`` per point, the
    span's own (its children's apart); by idle time, the largest first."""
    n = max(program.points, 1)
    rows = [(name, (t.count / n, 1e3 * t.host_self_s / n, t.launches / n, 1e3 * t.device_s / n, t.syncs / n,
                    1e3 * t.sync_s / n, 1e3 * t.idle_s / n)) for name, t in program.own.items()]
    return sorted(rows, key=lambda row: -row[1][-1])


def trace_cell(system, schedule: Schedule, points: Iterator[Point]) -> Tuple[ProgramTrace, list]:
    """Warm ``schedule``'s shapes up on ``system`` and run a program stretch
    of whole passes of ``points``; returns the reduction and the stretch's
    (point, answers) pairs."""
    for pt in schedule.warmups():
        system.run_point(pt)
    torch.cuda.synchronize()
    done: list = []

    def stretch():
        done.extend(bench._run_points(system, points, bench.PROFILED_SECONDS, True, schedule.size)[0])

    program = program_stretch(stretch)
    if program is None:
        raise RuntimeError("the port has no span recorder (jstsp19_torch/core/trace.py)")
    return program, done


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--turns", type=int, default=2, help="rounds of (off, on, on, off) windows")
    p.add_argument("--seconds", type=float, default=5.0, help="each window's seconds")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("program_trace: no CUDA device; the tool measures the card only", file=sys.stderr)
        return 2
    from jstsp19_torch.core import trace as program_spans
    from perfbench.run import card_line
    from perfbench.system import Port

    cell = cells.load(args.workload)
    card = card_line()
    system = Port("cuda", args.seed)
    schedule = Schedule(cell.config, cell.traffic)
    points = schedule.window()
    program, done = trace_cell(system, schedule, points)
    n = program.points
    print(f"[trace] {cell.name} (seed {args.seed}; {card}): {n} points in {program.window_s:.4f} s, device idle "
          f"{program.idle_s:.4f} s ({100 * program.idle_s / program.window_s:.1f}%), {program.launches} launches, "
          f"{program.unmatched_kernels} kernels unmatched; per point:", file=sys.stderr)
    print("[trace] " + f"{'span':<20}" + "".join(f"{c:>14}" for c in COLUMNS), file=sys.stderr)
    rows = table(program)
    for name, values in rows:
        print("[trace] " + f"{name:<20}" + "".join(f"{v:>14.4f}" for v in values), file=sys.stderr)
    idle_put = sum(t.idle_s for t in program.own.values())
    launches_put = sum(t.launches for t in program.own.values())
    print(f"[trace] put down: idle {idle_put:.6f} s of the stretch's {program.idle_s:.6f} s; launches "
          f"{launches_put} of {program.launches}", file=sys.stderr)
    per_point = program.per_point()
    print(f"[trace] per point: {json.dumps(per_point)}; the port's counters: {json.dumps(program.counters())}",
          file=sys.stderr)

    rates: Dict[str, List[float]] = {"off": [], "on": []}
    on_done = list(done)
    for side in ("off", "on", "on", "off") * args.turns:
        with program_spans.recording() if side == "on" else contextlib.nullcontext():
            got, times, window_s = bench._run_points(system, points, args.seconds, False, schedule.size)
        if side == "on":
            on_done.extend(got)
        rates[side].append(sum(t.realizations for t in times) / window_s)
        print(f"[trace] recording {side}: {rates[side][-1]:.1f} realizations/s", file=sys.stderr)
    off, on = statistics.median(rates["off"]), statistics.median(rates["on"])
    correct, checks = check.run(system, on_done, args.seed, cell.limits)
    result = {
        "workload": cell.name, "seed": args.seed, "card": card, "correct": correct,
        "stretch": {"window_s": program.window_s, "idle_s": program.idle_s, "idle_put_s": idle_put,
                    "launches": program.launches, "launches_put": launches_put,
                    "unmatched_kernels": program.unmatched_kernels, "points": n},
        "per_point": per_point,
        "counters": program.counters(),
        "table": {"columns": COLUMNS, "rows": {name: values for name, values in rows}},
        "cost": {"realizations_per_s": rates, "median_off": off, "median_on": on, "on_over_off": on / off - 1.0},
        "checks": checks,
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
