"""Whole runs of a small cell on each route: a sound run is correct, the
control and each fault the cell can have are not, a traced run records the
route's spans, a cell the reference cannot check is refused before any point
runs, and a run without a card prints nothing."""
import collections
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from perfbench import bench, cells, trace
from perfbench.system import Control, Port
from perfbench.traffic import Schedule

ROOT = pathlib.Path(__file__).resolve().parents[2]
SEED = 2**31 + 12345


def run(cell, system_cls, device="cpu", seconds=0.3):
    return bench.run_cell(cell, system_cls(device, SEED), SEED, seconds, False, time.time())


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "snr_fused_b256", "--seed", str(SEED),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert not any(line.lstrip().startswith("{") for line in out.stdout.splitlines())


def test_a_sound_run_is_correct(tiny_cell):
    result = run(tiny_cell, Port)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] % tiny_cell.traffic["n_mc"] == 0
    assert set(result["metrics"]) == {"realizations_per_s", "point_ms_p95", "setup_s"}
    assert list(result)[-1] == "checks"


def test_the_control_is_not_correct(tiny_cell):
    """The reference with TF32 products in the program's place."""
    result = run(tiny_cell, Control)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
def test_the_control_is_not_correct_on_the_card(tiny_cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert run(tiny_cell, Port, "cuda")["correct"]
    assert not run(tiny_cell, Control, "cuda")["correct"]


def _state_unchanged(monkeypatch):
    """The solve returns its starting state: S = 0."""
    from jstsp19_torch.kernels import admm_fused

    def solve(subY, Omega, A, B, *args, **kwargs):
        return torch.zeros(subY.shape[0], A.shape[-1], B.shape[-2], dtype=subY.dtype), subY

    monkeypatch.setattr(admm_fused, "fused_tracked_admm", solve)


def _half_the_batch(monkeypatch):
    """Each point solves half of its realizations and answers for those."""
    from jstsp19_torch.harness import runner

    whole = runner.fused_point_errors
    monkeypatch.setattr(runner, "fused_point_errors",
                        lambda gens, pc, nv, batch, rows=None: whole(gens, pc, nv, batch, rows=slice(0, batch // 2)))


def _answer_altered(monkeypatch):
    """One realization's NMSE is altered by 1% where it is computed."""
    from jstsp19_torch.harness import pipeline

    exact = pipeline.clamped_nmse

    def altered(est, ref):
        out = exact(est, ref).clone()
        out[-1] = out[-1] * 0.99
        return out

    monkeypatch.setattr(pipeline, "clamped_nmse", altered)


# The exchange between chips is not a fault these cells can have: a point runs whole on one card.
@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch, _answer_altered])
def test_a_fault_makes_the_run_not_correct(tiny_cell, monkeypatch, fault):
    fault(monkeypatch)
    result = run(tiny_cell, Port)
    assert not result["correct"], result["checks"]


def test_a_sound_run_on_the_tracked_route_is_correct(tiny_tracked_cell):
    """N > M: the window, the program's side of the check and the reference
    all take the tracked route, the SVT on the transpose."""
    schedule = Schedule(tiny_tracked_cell.config, tiny_tracked_cell.traffic)
    assert {Port("cpu", SEED).route(pt) for pt in schedule.warmups()} == {"tracked"}
    result = run(tiny_tracked_cell, Port)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] % tiny_tracked_cell.traffic["n_mc"] == 0


def test_the_control_is_not_correct_on_the_tracked_route(tiny_tracked_cell):
    result = run(tiny_tracked_cell, Control)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
def test_a_traced_run_on_the_tracked_route_on_the_card(tiny_tracked_cell):
    """The tracked route's kernels on the card: correct, its spans read, the fused kernel's roofline silent, and
    the control not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result = bench.run_cell(tiny_tracked_cell, Port("cuda", SEED), SEED, 0.3, True, time.time())
    assert result["correct"], result["checks"]
    assert {"frontend_ms", "device_idle_pct"} <= set(result["metrics"])
    assert "fused_admm_roofline" not in result["metrics"]
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert not run(tiny_tracked_cell, Control, "cuda")["correct"]


def _tracked_state_unchanged(monkeypatch):
    """The tracked solve returns its starting state: S = 0."""
    from jstsp19_torch.harness import pipeline
    from jstsp19_torch.solvers.admm import AdmmResult

    def unchanged(at):  # where A lies among the arguments after subY
        def solve(subY, *args, **kwargs):
            A, B = args[at], args[at + 1]
            S = torch.zeros(subY.shape[0], A.shape[-1], B.shape[-2], dtype=subY.dtype)
            return AdmmResult(S=S, Y=subY, convergence=None)
        return solve

    monkeypatch.setattr(pipeline, "proposed_admm", unchanged(1))
    monkeypatch.setattr(pipeline, "proposed_admm_angles", unchanged(2))


def _tracked_half_the_batch(monkeypatch):
    """Each tracked point solves half of its realizations and answers for those."""
    from jstsp19_torch.harness import runner

    whole = runner.realization_errors

    def half(gens, pc, nv, batch, H_ext=None, rows=None, **kwargs):
        return whole(gens, pc, nv, batch, H_ext=H_ext, rows=slice(0, batch // 2), **kwargs)

    monkeypatch.setattr(runner, "realization_errors", half)


@pytest.mark.parametrize("fault", [_tracked_state_unchanged, _tracked_half_the_batch, _answer_altered])
def test_a_fault_on_the_tracked_route_makes_the_run_not_correct(tiny_tracked_cell, monkeypatch, fault):
    fault(monkeypatch)
    result = run(tiny_tracked_cell, Port)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("change", [{"methods": ["proposed", "omp_td"]}, {"methods": ["proposed", "svt"]},
                                    {"methods": ["proposed", "tssr"]}, {"svt_method": "eigh"}])
def test_a_cell_the_reference_cannot_check_is_refused_before_any_point_runs(tiny_tracked_cell, monkeypatch,
                                                                            change):
    ran = []
    monkeypatch.setattr(Port, "run_point", lambda self, pt: ran.append(pt))
    tiny_tracked_cell.traffic.update(change)
    with pytest.raises(ValueError, match="perfbench/reference/ has no code for"):
        run(tiny_tracked_cell, Port)
    assert ran == []


class _HostEvent:
    """``torch.cuda.Event`` on the host's clock, for a traced stretch on the CPU."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


SOLVES = ("fused_admm", "tracked_admm")


@pytest.mark.parametrize("cell,names", [
    ("tiny_cell", {"frontend": 2, "fused_admm": 4}),
    ("tiny_tracked_cell", {"draws": 2, "frontend": 2, "tracked_admm": 4}),
])
def test_spans_follow_the_route_and_restore_the_program(request, monkeypatch, cell, names):
    """Two points under ``trace.spans``, with the card's synchronisation and
    events on the host: each route records its own spans, the shapes of each
    solve, and leaves the program's functions as it found them."""
    from jstsp19_torch.harness import pipeline
    from jstsp19_torch.kernels import admm_fused

    cell = request.getfixturevalue(cell)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    wrapped = [(pipeline, name) for name in ("proposed_problem", "point_draws", "_proposed_frontend",
                                             "proposed_admm", "proposed_admm_angles")]
    wrapped.append((admm_fused, "fused_tracked_admm"))
    before = [getattr(module, name) for module, name in wrapped]
    schedule = Schedule(cell.config, cell.traffic)
    port, spans = Port("cpu", SEED), []
    with trace.spans(spans):
        for pt, _ in zip(schedule.window(), range(2)):
            port.run_point(pt)
    assert [getattr(module, name) for module, name in wrapped] == before
    assert collections.Counter(s.name for s in spans) == names
    p = cell.config["point"]
    shapes = dict(B=cell.traffic["n_mc"], N=p["Mr_e"], M=p["T"] * p["Nt"], Gr=p["Gr"], K=p["L"] * p["Gt"],
                  Imax=p["Imax"])
    solves = [s.attrs for s in spans if s.name in SOLVES]
    assert solves == [dict(shapes, rank=False), dict(shapes, rank=True)] * 2
    record = bench.Record(0.0, 1.0, [], spans, None)
    assert cells.reader("frontend_ms")(record) > 0
    assert (cells.reader("fused_admm_roofline")(record) is None) == ("fused_admm" not in names)


def test_reduce_trace_takes_the_union_of_device_intervals_within_the_stretch():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": trace.STRETCH, "ts": 100.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 90.0, "dur": 20.0},  # 100-110 inside
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 105.0, "dur": 10.0},  # overlaps k1: 110-115 new
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 150.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 195.0, "dur": 20.0},  # 195-200 inside
        {"ph": "X", "cat": "cpu_op", "name": "aten::linalg_eigvalsh", "ts": 112.0, "dur": 30.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 112.5, "dur": 2.0},
    ]
    got = trace.reduce_trace(events)
    assert got.window_s == pytest.approx(100e-6) and got.busy_s == pytest.approx(30e-6)
    assert got.device_ops[0] == ["k1", pytest.approx(15e-6)]
    assert dict(map(tuple, got.idle_gaps)) == {"aten::linalg_eigvalsh": pytest.approx(35e-6),
                                              "host, between operations": pytest.approx(35e-6)}
    assert trace.reduce_trace([e for e in events if e["cat"] != "kernel" and e["cat"] != "gpu_memcpy"]) is None


@pytest.mark.cuda
def test_spans_restore_the_program_and_keep_its_launch_count(tiny_cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from jstsp19_torch.harness import pipeline
    from jstsp19_torch.kernels import admm_fused

    before = (pipeline.proposed_problem, admm_fused.fused_tracked_admm, admm_fused.fused_tracked_admm.launches)
    result = bench.run_cell(tiny_cell, Port("cuda", SEED), SEED, 0.3, True, time.time())
    assert (pipeline.proposed_problem, admm_fused.fused_tracked_admm) == before[:2]
    assert admm_fused.fused_tracked_admm.launches > before[2]
    assert {"frontend_ms", "fused_admm_roofline", "device_idle_pct"} <= set(result["metrics"])
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    json.dumps(result)
    assert np.isfinite(result["metrics"]["fused_admm_roofline"]["value"])
