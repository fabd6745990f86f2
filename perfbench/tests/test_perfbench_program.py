"""The program stretch's reduction by span (``perfbench/program_trace.py``):
on a synthetic chrome trace here, and on the card a stretch of the tiny
cell, whose five numbers a point are finite and whose answers are correct."""
import math

import pytest
import torch

from perfbench import check, program_trace
from perfbench.program_trace import OUTSIDE, STRETCH, reduce_program

SEED = 2**31 + 12345


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": program_trace.PREFIX + name, "ts": ts, "dur": dur}


def _call(name, ts, dur, corr=None):
    e = {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _device(cat, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": f"{cat}{corr}", "ts": ts, "dur": dur, "args": {"correlation": corr}}


EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": STRETCH, "ts": 0.0, "dur": 1000.0},
    _span("point", 10, 890), _span("frontend", 20, 280), _span("draws", 30, 70), _span("solve", 400, 300),
    _span("pack", 410, 40), _span("launch", 460, 10), _span("to_host", 800, 90),
    _call("cudaLaunchKernel", 40, 3, corr=1), _device("kernel", 45, 15, 1),  # in draws
    _call("cudaLaunchKernel", 200, 3, corr=2), _device("kernel", 210, 40, 2),  # in frontend, after draws
    _call("cudaMemcpyAsync", 420, 5, corr=3), _device("gpu_memcpy", 425, 5, 3),  # a copy: no launch
    _call("cudaStreamSynchronize", 432, 10),  # in pack
    _call("cudaLaunchKernel", 462, 3, corr=4), _device("kernel", 470, 310, 4),  # in launch
    _call("cudaMemcpyAsync", 810, 2, corr=5), _device("gpu_memcpy", 812, 3, 5),
    _call("cudaStreamSynchronize", 816, 5),  # in to_host
    _call("cudaLaunchKernel", 950, 3, corr=6), _device("kernel", 955, 5, 6),  # outside the point
    _device("kernel", 970, 5, 99),  # no host call of the stretch launched it
    {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 205, "dur": 1},
]


def test_launches_syncs_and_idle_gaps_are_put_down_to_their_innermost_span():
    got = reduce_program(EVENTS)
    own, inc = got.own, got.inclusive
    assert got.points == 1 and got.window_s == pytest.approx(1e-3)
    # the launch at 40 lies in draws, the one at 200 in frontend itself, the one at 462 in launch
    assert {name: t.launches for name, t in own.items()} == {
        "point": 0, "frontend": 1, "draws": 1, "solve": 0, "pack": 0, "launch": 1, "to_host": 0, OUTSIDE: 1}
    assert got.launches == 4 and got.unmatched_kernels == 1
    assert own["launch"].device_s == pytest.approx(310e-6) and own["pack"].device_s == pytest.approx(5e-6)
    assert {name: t.syncs for name, t in own.items() if t.syncs} == {"pack": 1, "to_host": 1}
    assert own["pack"].sync_s == pytest.approx(10e-6)
    # each gap goes to the span open on the host when it began
    idle = {name: t.idle_s * 1e6 for name, t in own.items()}
    assert idle == pytest.approx({"point": 32, "frontend": 175, "draws": 150, "solve": 0, "pack": 40, "launch": 0,
                                  "to_host": 140, OUTSIDE: 80})
    assert sum(t.idle_s for t in own.values()) == pytest.approx(got.idle_s) == pytest.approx(617e-6)
    assert sum(t.launches for t in own.values()) == got.launches
    assert own["point"].host_self_s == pytest.approx(220e-6) and own["solve"].host_self_s == pytest.approx(250e-6)
    assert inc["frontend"].launches == 2 and inc["frontend"].idle_s == pytest.approx(325e-6)
    assert inc["point"].launches == 3 and inc["point"].syncs == 2 and inc["point"].idle_s == pytest.approx(537e-6)
    assert inc["point"].host_self_s == pytest.approx(890e-6)


def test_the_five_numbers_a_point():
    from jstsp19_torch.core.trace import Span

    got = reduce_program(EVENTS)
    assert got.per_point()["solve_pack_ms"] is None  # no record of the port's own
    assert got.counters() == {}
    got.recorded = [Span("pack", 1, 0, 0, 0, 40_000, {}),
                    Span("point", 0, None, 0, 0, 890_000, dict(realizations=4, launches={"fused_tracked_admm": 2}))]
    assert got.per_point() == pytest.approx(dict(frontend_launches=2, frontend_idle_ms=0.325,
                                                 pipeline_idle_ms=0.212, host_syncs=2, solve_pack_ms=0.04))
    assert got.counters() == {"realizations": 4, "launches": {"fused_tracked_admm": 2}}


def test_a_trace_without_program_spans_or_stretch_gives_none():
    assert reduce_program([e for e in EVENTS if not e["name"].startswith(program_trace.PREFIX)]) is None
    assert reduce_program([e for e in EVENTS if e["name"] != STRETCH]) is None


def test_the_table_has_a_row_a_span_and_outside_by_idle_time():
    rows = program_trace.table(reduce_program(EVENTS))
    assert [name for name, _ in rows][:3] == ["frontend", "draws", "to_host"]
    assert len(rows) == 8 and all(len(values) == len(program_trace.COLUMNS) for _, values in rows)


@pytest.mark.cuda
def test_a_stretch_of_the_tiny_cell_on_the_card(tiny_cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from perfbench.system import Port
    from perfbench.traffic import Schedule

    system = Port("cuda", SEED)
    schedule = Schedule(tiny_cell.config, tiny_cell.traffic)
    got, done = program_trace.trace_cell(system, schedule, schedule.window())
    numbers = got.per_point()
    assert all(v is not None and math.isfinite(v) for v in numbers.values()), numbers
    assert numbers["frontend_launches"] > 0 and numbers["host_syncs"] >= 1 and numbers["solve_pack_ms"] > 0
    assert got.points == len(done) and got.points % schedule.size == 0
    assert sum(t.idle_s for t in got.own.values()) == pytest.approx(got.idle_s, rel=1e-6)
    assert sum(t.launches for t in got.own.values()) == got.launches
    assert got.own["launch"].launches == 2 * got.points  # the fused kernel, once a method
    assert got.counters()["launches"]["fused_tracked_admm"] == 2
    assert got.counters()["realizations"] == tiny_cell.traffic["n_mc"]
    correct, checks = check.run(system, done, SEED, tiny_cell.limits)
    assert correct, checks
