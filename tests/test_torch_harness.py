"""The port's second slice end to end on the CPU: the combiner drawn per
realization, the conventional branch against the JAX package's on the same
draws, the runner's routes, the experiment CLI, and the errorVSnrf sweep held
to the JAX run in ``results/error_vs_nrf.json`` by ensemble."""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.core import prng as jprng  # noqa: E402
from jstsp19_tpu.frontend import hbf as jhbf  # noqa: E402
from jstsp19_tpu.harness import experiments as jexp  # noqa: E402
from jstsp19_tpu.harness import pipeline as jpipe  # noqa: E402
from jstsp19_torch import interop  # noqa: E402
from jstsp19_torch.__main__ import main  # noqa: E402
from jstsp19_torch.core import prng  # noqa: E402
from jstsp19_torch.frontend import create_beamformer  # noqa: E402
from jstsp19_torch.frontend.measurement import hbf  # noqa: E402
from jstsp19_torch.harness import pipeline, runner  # noqa: E402
from jstsp19_torch.harness.experiments import EXPERIMENTS  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These batches are small: one intra-op thread each, so that the suite's
    parallel workers do not oversubscribe the cores (OpenMP threads spinning
    on small linear-algebra calls made these tests 100 times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NV_5DB = 10 ** (-0.5)


@pytest.mark.parametrize("kind", ["rand", "rand_ps"])
def test_random_combiner_is_drawn_per_realization(kind):
    """As the JAX package draws one combiner per realization key, the port
    draws one (Nr, Nr) combiner per realization of the batch for the random
    kinds: the four W, and with them the four A_p, differ."""
    pc = pipeline.PointConfig(beamformer=kind, Mr=16, T=5, methods=("proposed",), Imax=2)
    _, _, _, W = pipeline._system_realization(prng.realization_generators(0, 0, "cpu"), pc, 1.0, 4)
    assert W.shape == (4, 32, 32)
    prob = pipeline.proposed_problem(prng.realization_generators(0, 0, "cpu"), pc, 1.0, 4)
    for i in range(1, 4):
        assert not torch.equal(W[0], W[i])
        assert not torch.equal(prob["A"][0], prob["A"][i])
    torch.testing.assert_close((W.abs() ** 2).sum(dim=-2), torch.ones(4, 32))  # unit-norm columns


def test_deterministic_combiner_stays_shared():
    """'ZC' is one shared matrix: equal A_p across the batch."""
    pc = pipeline.PointConfig(Mr=16, T=5, methods=("proposed",), Imax=2)
    _, _, _, W = pipeline._system_realization(prng.realization_generators(0, 0, "cpu"), pc, 1.0, 4)
    assert W.shape == (32, 32)
    torch.testing.assert_close(W, create_beamformer(32, "ZC", batch=(4,)))
    A = pipeline.proposed_problem(prng.realization_generators(0, 0, "cpu"), pc, 1.0, 4)["A"]
    assert A.shape == (4, 32, 32) and all(torch.equal(A[0], A[i]) for i in range(4))


def test_conventional_frontend_matches_jax_on_the_same_draws():
    """Given JAX's channel, training, noise and combiner for the errorVSnrf
    point Mr=4 (T_hbf = 4), the port's hbf and dictionaries rebuild JAX's
    Y_c, A_c and B_c: rtol 1e-5, atol 1e-5·max (measured ≤ 1.2e-7·max)."""
    pc_j = jpipe.PointConfig(Mr=4, T=5)
    key = jprng.realization_keys(jprng.experiment_key(8), 0, 1)[0]
    ch_j, Psi_j, N_j, W_j = jpipe._system_realization(key, pc_j, NV_5DB)
    Th = pc_j.T_hbf
    Y_j, W_cj = jhbf(ch_j.H, N_j[:, :Th], Psi_j[:, :, :Th], pc_j.Nr, W_j)
    A_j, B_j = jpipe._dictionaries(ch_j, W_cj, Psi_j[:, :, :Th])

    ch = interop.channel_to_torch(ch_j)
    Psi, N, W = interop.to_torch(Psi_j), interop.to_torch(N_j), interop.to_torch(W_j)
    assert pipeline.PointConfig(Mr=4, T=5).T_hbf == Th == 4
    Y_c, W_c = hbf(ch.H, N[..., :Th], Psi[..., :Th], 32, W)
    A_c, B_c = pipeline._dictionaries(ch, W_c, Psi[..., :Th])
    for got, want in ((Y_c, Y_j), (A_c, A_j), (B_c, B_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_run_point_routes():
    """'fused' with N > M (errorVSnrf: Mr_e=32 > T·Nt=20) falls back to
    'tracked' for every method; with N ≤ M the proposed methods go on the
    fused route and the rest on 'tracked', on the same realizations."""
    nrf = pipeline.PointConfig(Mr=16, T=5, Imax=10, vamp_nit=10, svt_method="fused")
    got = runner.run_point(nrf, NV_5DB, 4, seed=1, device="cpu")
    want = runner.run_point(dataclasses.replace(nrf, svt_method="tracked"), NV_5DB, 4, seed=1, device="cpu")
    assert set(got) == set(nrf.methods) == set(pipeline.DEFAULT_METHODS)
    for m in got:
        np.testing.assert_array_equal(got[m], want[m])
        assert got[m].shape == (4,) and isinstance(got[m], np.ndarray)
    snr = pipeline.PointConfig(methods=("ls", "proposed"), Imax=10, svt_method="fused")
    got = runner.run_point(snr, 1.0, 3, device="cpu")
    ref = pipeline.realization_errors(prng.realization_generators(0, 0, "cpu"),
                                      dataclasses.replace(snr, svt_method="tracked"), 1.0, 3)
    for m in ("ls", "proposed"):
        np.testing.assert_allclose(got[m], ref[m].numpy(), rtol=1e-6)


# PointConfig fields of one sweep point for each of the 12 distinct shapes
# the fused route reaches in the seven recipes (as in chip_smoke.py [13])
SWEEP_POINTS = (
    {}, dict(Nt=8, Gt=8, T=5, beamformer="fft"), dict(Nt=8, Gt=8, T=15, beamformer="fft"),
    dict(Nt=8, Gt=8, T=25, beamformer="fft"), dict(Nt=8, Gt=8, T=35, beamformer="fft"),
    dict(L=4, T=10), dict(L=6, T=15), dict(L=8, T=20), dict(L=10, T=25),
    dict(Nt=6, Gt=6, beamformer="fft"), dict(Nt=12, Gt=12, beamformer="fft"),
    dict(Nt=16, Gt=16, T=25, beamformer="fft"),
)


def test_fused_route_takes_tracked_where_the_kernel_cannot_hold_the_shapes():
    """``admm_fused.fits`` is False at the three shapes whose layout passes
    the 232,448 B a block may use, True at all 12 fused-route sweep shapes,
    and ``run_point`` routes a point the kernel cannot hold to 'tracked',
    decided from the shapes alone."""
    from jstsp19_torch.kernels import admm_fused

    for N, M, Gr, K, smem in ((64, 140, 64, 16, 255_296), (32, 400, 32, 80, 237_312), (70, 140, 32, 16, 237_680)):
        assert not admm_fused.fits(N, M, Gr, K)
        with pytest.raises(ValueError, match=f"need {smem} B"):
            admm_fused.plan(N, M, Gr, K)
    shapes = set()
    for changes in SWEEP_POINTS:
        pc = pipeline.PointConfig(svt_method="fused", **changes)
        N, M, K = pc.Mr_e, pc.T * pc.Nt, pc.L * pc.Gt
        assert admm_fused.fits(N, M, pc.Gr, K) and runner.svt_route(pc) == "fused"
        shapes.add((N, M, pc.Gr, K))
    assert len(shapes) == 12
    big = pipeline.PointConfig(Nr=64, Mr_e=64, Gr=64, svt_method="fused")
    assert runner.svt_route(big) == "tracked"
    assert runner.svt_route(pipeline.PointConfig(Nt=8, Gt=8, L=10, T=50, svt_method="fused")) == "tracked"
    assert runner.svt_route(pipeline.PointConfig(Mr=16, T=5, svt_method="fused")) == "tracked"  # N > M
    assert runner.svt_route(dataclasses.replace(big, svt_method="eigh")) == "eigh"


def test_unported_parts_raise_and_name_their_roadmap_item(capsys):
    gens = prng.realization_generators(0, 0, "cpu")
    # omp_td, svt and tssr are ported: they run and give one NMSE a realization
    for m in ("omp_td", "svt", "tssr"):
        out = pipeline.realization_errors(gens, pipeline.PointConfig(methods=(m,), Imax=2), 1.0, 1)
        assert set(out) == {m} and out[m].shape == (1,)
    with pytest.raises(ValueError, match="unknown method"):
        pipeline.realization_errors(gens, pipeline.PointConfig(methods=("nope",)), 1.0, 1)
    # demo lists the 21 worked examples (ROADMAP.md Queue 1, item 7f, done)
    capsys.readouterr()
    assert main(["demo"]) == 0
    listed = capsys.readouterr().out.splitlines()[1:]
    assert len(listed) == 21 and all(line.startswith("  ") for line in listed)
    # the JAX registry, time_comparisons included
    assert set(EXPERIMENTS) == set(jexp.EXPERIMENTS)
    assert len(EXPERIMENTS) == 19
    jdef, tdef = jpipe.PointConfig(), pipeline.PointConfig()
    for f in ("methods", "num_nonzero", "vamp_nit", "vamp_true_noise", "vamp_damp", "vamp_normal_eq"):
        assert getattr(tdef, f) == getattr(jdef, f)


def test_cli_list_errors_and_checkpoint_resume(tmp_path, capsys):
    assert main(["list"]) == 0
    assert "error_vs_nrf" in capsys.readouterr().out
    assert main(["run", "nope", "--cpu"]) == 1
    args = ["run", "error_vs_snr", "--cpu", "--n-mc", "2", "--no-plot", "--methods", "ls",
            "--out", str(tmp_path / "a"), "--checkpoint-dir", str(tmp_path / "ck")]
    try:
        assert main(args) == 0
        first = json.loads((tmp_path / "a" / "error_vs_snr.json").read_text())
        assert set(first["curves"]) == {"ls"} and len(first["raw"]["ls"]) == 11
        assert len(list((tmp_path / "ck").glob("error_vs_snr.snr_db.*.json"))) == 11
        args[args.index(str(tmp_path / "a"))] = str(tmp_path / "b")
        assert main(args) == 0  # every point from the journal: no raw
        second = json.loads((tmp_path / "b" / "error_vs_snr.json").read_text())
        assert second["curves"] == first["curves"] and "raw" not in second
    finally:
        runner.set_default_checkpoint(None)


def test_cli_needs_cuda_without_cpu_flag(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "jstsp19_torch", "run", "error_vs_nrf", "--n-mc", "2", "--no-plot",
         "--out", str(tmp_path)], cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 1 and "CUDA" in proc.stderr
    assert not (tmp_path / "error_vs_nrf.json").exists()


def test_entry_points_need_a_device_name_without_cuda(monkeypatch):
    """run_point, run_sweep, every recipe and hadamard_cs_torch run on the
    card unless named; without a card and without a name they raise, naming
    device="cpu", before any work is done on the CPU."""
    from jstsp19_torch.harness import hadamard_cs as hcs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pc = pipeline.PointConfig(methods=("ls",), Imax=2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        runner.run_point(pc, 1.0, 1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        runner.run_sweep("x", "s", [0], point_fn=lambda v: pc, noise_fn=lambda v: 1.0, n_mc=1, verbose=False)
    for name, recipe in sorted(EXPERIMENTS.items()):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            recipe(n_mc=1)
    prob = hcs.hadamard_cs_problem(batch=1, n=16)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        hcs.hadamard_cs_torch(prob)
    assert hcs.hadamard_cs_torch(prob, "cpu")[1].y.device.type == "cpu"


def test_error_vs_nrf_slice_matches_jax_reference(tmp_path):
    """``python -m jstsp19_torch run error_vs_nrf --cpu --n-mc 8 --no-plot``
    in-process: the JSON has the JAX artifact's schema, every curve value is
    finite and in [0, 1], and each of the five methods at each Mr lies within
    4 combined standard errors of the JAX run (results/error_vs_nrf.json,
    n_mc=50); measured |z| ≤ 3.01 with seed 0."""
    assert main(["run", "error_vs_nrf", "--cpu", "--n-mc", "8", "--no-plot", "--out", str(tmp_path)]) == 0
    got = json.loads((tmp_path / "error_vs_nrf.json").read_text())
    ref = json.loads((ROOT / "results" / "error_vs_nrf.json").read_text())
    assert set(got) == set(ref) and got["sweep"] == ref["sweep"] and got["n_mc"] == 8
    assert set(got["curves"]) == set(ref["curves"]) == set(got["raw"])
    back = interop.sweep_result_from_json(json.dumps(got))
    assert json.loads(back.to_json()) == got
    for m, curve in got["curves"].items():
        assert all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in curve)
        for i, v in enumerate(curve):
            g, r = np.asarray(got["raw"][m][i]), np.asarray(ref["raw"][m][i])
            assert len(g) == 8 and v == pytest.approx(g.mean())
            se = math.sqrt(g.var(ddof=1) / g.size + r.var(ddof=1) / r.size)
            assert abs(g.mean() - r.mean()) <= 4 * se, (m, i, g.mean(), r.mean(), se)
