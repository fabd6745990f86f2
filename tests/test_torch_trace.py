"""The port's span recorder (``jstsp19_torch/core/trace.py``) and the spans of
a fused point (``harness/runner.py::run_point`` on the route 'fused') and of
a tracked one (the route 'tracked', where N > M sends every point), on the
CPU: the span tree, its ids and intervals, the point's counters, nothing
recorded with tracing off, answers bit-equal with it on and off, and the
spans as ``user_annotation`` ranges under ``torch.profiler``."""
import json

import numpy as np
import pytest
import torch

from jstsp19_torch.core import trace
from jstsp19_torch.harness import pipeline, runner
from jstsp19_torch.harness.pipeline import PointConfig
from jstsp19_torch.kernels import admm_fused, launch_counts

TINY = dict(Nt=2, Nr=8, Mr_e=8, Mr=4, Gr=8, Gt=2, L=2, n_clusters=1, n_rays=2, T=6, Imax=12)
N_MC = 4
FRONTEND = ("draws", "dictionaries", "hyperparams", "oracle_rank")
POINT = ("frontend", "solve", "nmse", "to_host")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny batches: one intra-op thread, so that the suite's parallel workers
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _point(svt_method="fused", rows=None, **fields):
    pc = PointConfig(methods=("proposed", "proposed_angles"), svt_method=svt_method, **dict(TINY, **fields))
    return runner.run_point(pc, 0.5, N_MC, seed=2**31 + 7, sweep_index=3, device="cpu", rows=rows)


# (the route asked for, T): at T = 3, N = Mr_e = 8 > M = T·Nt = 6, so the fused route falls back to the tracked one;
# at T = 6 the tracked route is asked for at N < M
TRACKED = [("fused", 3), ("tracked", 3), ("tracked", 6)]
TRACKED_IDS = ["fused_n_over_m", "tracked_n_over_m", "tracked_n_under_m"]
TRACKED_CHILDREN = ("draws", "frontend", "solve", "nmse", "solve", "nmse", "to_host")


@pytest.mark.parametrize("rows", [None, slice(1, 3)], ids=["whole", "rows"])
def test_a_fused_point_records_its_span_tree(rows):
    with trace.recording() as spans:
        _point(rows=rows)
    by_id = {s.id: s for s in spans}
    (point,) = [s for s in spans if s.name == "point"]
    names = sorted(s.name for s in spans)
    # the plain solve on the CPU has no operand packing and no launch
    assert names == sorted(("point", "to_host") + FRONTEND + ("frontend",) + ("solve", "nmse") * 2)
    for s in spans:
        assert s.point == point.id
        assert s.start_ns <= s.end_ns
        if s is not point:
            parent = by_id[s.parent]
            assert parent.name == ("frontend" if s.name in FRONTEND else "point")
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    assert point.parent is None
    assert len(by_id) == len(spans)
    assert point.attrs["sweep_index"] == 3 and point.attrs["n_mc"] == N_MC and point.attrs["route"] == "fused"
    assert point.attrs["realizations"] == (N_MC if rows is None else 2)
    assert point.attrs["launches"] == dict.fromkeys(launch_counts(), 0)
    assert point.attrs["captures"] == point.attrs["replays"] == 0  # the CPU runs the front end eagerly
    solves = [s.attrs for s in spans if s.name == "solve"]
    assert [a["method"] for a in solves] == ["proposed", "proposed_angles"]
    assert solves[0] == dict(solves[1], method="proposed")
    assert {k: solves[0][k] for k in ("B", "N", "M", "Gr", "K", "Imax")} == dict(
        B=N_MC if rows is None else 2, N=TINY["Mr_e"], M=TINY["T"] * TINY["Nt"], Gr=TINY["Gr"],
        K=TINY["L"] * TINY["Gt"], Imax=TINY["Imax"])
    assert [s.attrs for s in spans if s.name == "nmse"] == [{"method": "proposed"}, {"method": "proposed_angles"}]


def test_each_point_has_its_own_id():
    with trace.recording() as spans:
        _point()
        _point()
    points = [s.id for s in spans if s.name == "point"]
    assert len(points) == 2
    assert sorted({s.point for s in spans}) == sorted(points)
    assert sum(s.point == points[0] for s in spans) == sum(s.point == points[1] for s in spans)


def test_the_tracked_route_records_its_point_and_copy_to_the_host():
    """The tracked route records ``point`` and ``to_host``, and between them
    its layers under the fused route's names."""
    with trace.recording() as spans:
        _point(svt_method="tracked")
    names = {s.name for s in spans}
    assert names == {"point", "to_host", "draws", "frontend", "dictionaries", "hyperparams", "solve", "nmse"}
    (point,) = [s for s in spans if s.name == "point"]
    assert point.attrs["route"] == "tracked"


@pytest.mark.parametrize("rows", [None, slice(1, 3)], ids=["whole", "rows"])
@pytest.mark.parametrize("svt_method,T", TRACKED, ids=TRACKED_IDS)
def test_a_tracked_point_records_its_span_tree(svt_method, T, rows):
    """``point`` ⊃ ``draws``, ``frontend`` ⊃ {``dictionaries``,
    ``hyperparams``}, ``solve`` and ``nmse`` for each method in turn, then
    ``to_host``."""
    with trace.recording() as spans:
        _point(svt_method=svt_method, rows=rows, T=T)
    by_id = {s.id: s for s in spans}
    (point,) = [s for s in spans if s.name == "point"]
    assert point.parent is None and point.attrs["route"] == "tracked"
    assert point.attrs["realizations"] == (N_MC if rows is None else 2)
    assert point.attrs["launches"] == dict.fromkeys(launch_counts(), 0)  # the CPU launches no kernel
    children = sorted((s for s in spans if s.parent == point.id), key=lambda s: s.start_ns)
    assert tuple(s.name for s in children) == TRACKED_CHILDREN
    for a, b in zip(children, children[1:]):
        assert a.end_ns <= b.start_ns
    (frontend,) = [s for s in children if s.name == "frontend"]
    assert sorted(s.name for s in spans if s.parent == frontend.id) == ["dictionaries", "hyperparams"]
    assert len(spans) == len(children) + 3 and len(by_id) == len(spans)
    for s in spans:
        assert s.point == point.id and s.start_ns <= s.end_ns
        if s is not point:
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    shapes = dict(route="tracked", B=N_MC if rows is None else 2, N=TINY["Mr_e"], M=T * TINY["Nt"], Gr=TINY["Gr"],
                  K=TINY["L"] * TINY["Gt"], Imax=TINY["Imax"])
    assert [s.attrs for s in children if s.name == "solve"] == [dict(shapes, method="proposed"),
                                                                dict(shapes, method="proposed_angles")]
    assert [s.attrs for s in children if s.name == "nmse"] == [{"method": "proposed"}, {"method": "proposed_angles"}]


@pytest.mark.parametrize("svt_method,T", TRACKED, ids=TRACKED_IDS)
def test_with_tracing_off_a_tracked_point_records_nothing(svt_method, T):
    with trace.recording() as spans:
        pass
    assert trace.span("solve", method="proposed", route="tracked") is trace.span("draws")
    _point(svt_method=svt_method, T=T)
    assert spans == [] and trace._RECORDER is None


@pytest.mark.parametrize("svt_method,T", TRACKED, ids=TRACKED_IDS)
def test_a_tracked_points_answers_are_bit_equal_with_tracing_on_and_off(svt_method, T):
    off = _point(svt_method=svt_method, T=T)
    with trace.recording() as spans:
        on = _point(svt_method=svt_method, T=T)
    assert spans and set(on) == set(off) == {"proposed", "proposed_angles"}
    for m in off:
        np.testing.assert_array_equal(on[m], off[m])


def test_with_tracing_off_nothing_is_recorded():
    with trace.recording() as spans:
        pass
    off = trace.span("point", n_mc=1)
    assert off is trace.span("frontend") and not off.on
    with off as entered:
        entered.set(realizations=1)
    _point()
    assert spans == [] and trace._RECORDER is None


def test_answers_are_bit_equal_with_tracing_on_and_off():
    off = _point()
    with trace.recording():
        on = _point()
    assert set(on) == set(off) == {"proposed", "proposed_angles"}
    for m in off:
        np.testing.assert_array_equal(on[m], off[m])


def test_a_span_closes_when_its_block_raises_and_recording_nests():
    with trace.recording() as outer:
        with pytest.raises(ValueError):
            with trace.span("point"):
                with trace.span("solve", method="x"):
                    raise ValueError("inside")
        with trace.recording() as inner:
            with trace.span("nmse"):
                pass
        with trace.span("to_host"):
            pass
    assert [s.name for s in outer] == ["solve", "point", "to_host"]
    assert outer[0].parent == outer[1].id and outer[0].point == outer[1].id
    assert outer[2].parent is None and outer[2].point is None
    assert [s.name for s in inner] == ["nmse"]
    assert trace._RECORDER is None


def test_the_fused_point_calls_its_layers_through_their_module_attributes(monkeypatch):
    """The benchmark's outside spans wrap ``pipeline.proposed_problem`` and
    ``admm_fused.fused_tracked_admm``: a fused point has to reach both."""
    calls = []

    def wrap(module, name):
        inner = getattr(module, name)

        def wrapper(*args, **kwargs):
            calls.append(name)
            return inner(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)

    wrap(pipeline, "proposed_problem")
    wrap(admm_fused, "fused_tracked_admm")
    _point()
    assert calls == ["proposed_problem", "fused_tracked_admm", "fused_tracked_admm"]


@pytest.mark.parametrize("svt_method,T", TRACKED, ids=TRACKED_IDS)
def test_the_tracked_point_calls_its_layers_through_their_module_attributes(monkeypatch, svt_method, T):
    """The benchmark's outside spans wrap ``pipeline.point_draws``,
    ``_proposed_frontend``, ``proposed_admm`` and ``proposed_admm_angles``:
    a tracked point has to reach each of them, and the fused kernel never."""
    calls = []

    def wrap(module, name):
        inner = getattr(module, name)

        def wrapper(*args, **kwargs):
            calls.append(name)
            return inner(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)

    for name in ("proposed_problem", "point_draws", "_proposed_frontend", "proposed_admm", "proposed_admm_angles"):
        wrap(pipeline, name)
    wrap(admm_fused, "fused_tracked_admm")
    _point(svt_method=svt_method, T=T)
    assert calls == ["point_draws", "_proposed_frontend", "proposed_admm", "proposed_admm_angles"]


def test_the_profiler_sees_each_span_as_a_user_annotation(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with trace.recording() as spans:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _point()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation" and e.get("name", "").startswith(trace.PREFIX)]
    assert sorted(e["name"] for e in ranges) == sorted(trace.PREFIX + s.name for s in spans)
    (point,) = [e for e in ranges if e["name"] == trace.PREFIX + "point"]
    for e in ranges:
        assert point["ts"] <= e["ts"] and e["ts"] + e["dur"] <= point["ts"] + point["dur"]
