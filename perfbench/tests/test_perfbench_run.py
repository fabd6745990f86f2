"""Whole runs of a small cell: a sound run is correct, the control and each
fault the cell can have are not, and a run without a card prints nothing."""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from perfbench import bench, trace
from perfbench.system import Control, Port

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
