"""Slice 10 of the port on the CPU: ``track_precision`` in the tracked chain
against the JAX chain, the artifacts' tables against JAX's,
``run --distributed 2 --cpu`` against the single-process run per
realization, the launcher flags' stripping, the runner's row cuts, ``panel``
against ``run_point`` and the ``orbax`` (npz) checkpoint resume."""
import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_torch import __main__ as cli  # noqa: E402
from jstsp19_torch.harness import artifacts, pipeline, runner  # noqa: E402
from jstsp19_torch.ops import tracked  # noqa: E402
from jstsp19_torch.parallel.distributed import ENV_PID  # noqa: E402
from jstsp19_tpu.harness import artifacts as jartifacts  # noqa: E402
from jstsp19_tpu.harness import pipeline as jpipe  # noqa: E402
from jstsp19_tpu.ops.tracked import make_tracked_svt as jmake_tracked_svt  # noqa: E402


def test_artifact_tables_equal_jax():
    assert artifacts._LOG_EXPERIMENTS == jartifacts._LOG_EXPERIMENTS
    assert artifacts._YLABELS == jartifacts._YLABELS


@pytest.mark.parametrize("precision", ["highest", "high", "default", "tensorfloat32"])
@pytest.mark.parametrize("N,M", [(8, 20), (20, 8)])
def test_tracked_chain_at_each_precision_matches_jax(precision, N, M):
    """Five steps of the chain at each setting on the same numpy inputs:
    the port on the CPU (float32 at every setting) against JAX's chain on the
    CPU (float32 at every setting), both sides of the N > M flip; 2e-5 of
    max|X| (float32 products in another order)."""
    rng = np.random.default_rng(3)
    W = (rng.standard_normal((5, N, M)) + 1j * rng.standard_normal((5, N, M))).astype(np.complex64)
    tau = np.float32(0.3)
    U_t, step_t = tracked.make_tracked_svt(N, M, torch.complex64, 1, precision)
    U_j, step_j = jmake_tracked_svt(N, M, jnp.complex64, 1, precision)
    for i in range(5):
        X_t, U_t = step_t(torch.from_numpy(W[i]), tau, U_t, i)
        X_j, U_j = step_j(jnp.asarray(W[i]), tau, U_j, i)
        X_j = np.asarray(X_j)
        assert np.abs(X_t.numpy() - X_j).max() <= 2e-5 * np.abs(X_j).max(), (precision, i)
    with pytest.raises(ValueError, match="unknown precision"):
        tracked.make_tracked_svt(N, M, torch.complex64, 1, "bfloat16")


def test_run_point_rows_equal_the_whole_batch():
    """A slice of the point's realizations, on the whole point's draws, is
    that slice of the whole point's errors, on the fused route (plain
    version here) and the unfused one."""
    for svt in ("fused", "eigh"):
        pc = pipeline.PointConfig(methods=("ls", "proposed"), svt_method=svt, Imax=4)
        whole = runner.run_point(pc, 1.0, 6, seed=2, sweep_index=1, device="cpu")
        part = runner.run_point(pc, 1.0, 6, seed=2, sweep_index=1, device="cpu", rows=slice(2, 5))
        for m in pc.methods:
            np.testing.assert_allclose(part[m], whole[m][2:5], rtol=1e-6, atol=1e-7)


def test_strip_launcher_flags_takes_both_forms():
    argv = ["run", "error_vs_nrf", "--distributed", "2", "--n-mc", "4", "--distributed=2", "--dist-timeout=9",
            "--dist-timeout", "9", "--cpu"]
    assert cli.strip_launcher_flags(argv) == ["run", "error_vs_nrf", "--n-mc", "4", "--cpu"]


def test_a_rank_refuses_the_launcher_flags(monkeypatch, capsys):
    monkeypatch.setenv(ENV_PID, "0")
    assert cli.main(["run", "error_vs_snr", "--cpu", "--distributed=2"]) == 2
    assert "must not reach the ranks" in capsys.readouterr().err


def test_run_distributed_2_equals_the_single_process_run(tmp_path, monkeypatch):
    """``run error_vs_snr --distributed=2 --cpu`` (the ``=`` form, which a
    rank refuses, so it must be stripped) against the same run in one
    process: every realization of every point within 1e-6 (the iterative
    solvers' row cuts: test_run_point_rows_equal_the_whole_batch).  One
    intra-op thread a rank: the suite's other workers hold the cores."""
    args = ["run", "error_vs_snr", "--cpu", "--n-mc", "4", "--no-plot", "--methods", "ls,omp_mmv"]
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert cli.main(args + ["--out", str(tmp_path / "d"), "--distributed=2", "--dist-timeout", "60"]) == 0
    assert cli.main(args + ["--out", str(tmp_path / "s")]) == 0
    d = json.loads((tmp_path / "d" / "error_vs_snr.json").read_text())
    s = json.loads((tmp_path / "s" / "error_vs_snr.json").read_text())
    assert set(d["raw"]) == set(s["raw"]) == {"ls", "omp_mmv"}
    for m in s["raw"]:
        np.testing.assert_allclose(np.asarray(d["raw"][m]), np.asarray(s["raw"][m]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(d["curves"][m], s["curves"][m], rtol=0, atol=1e-6)
    assert cli.main(args[:-2] + ["--out", str(tmp_path / "x"), "--distributed", "3"]) == 1  # 4 over 3 ranks


def test_panel_batch_equals_run_point_and_its_fields_are_jax(capsys):
    assert [(f.name, f.default) for f in dataclasses.fields(pipeline.PointConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jpipe.PointConfig)]
    assert cli.main(["panel", "--batch", "--cpu", "--n-mc", "4", "--snr-db", "5", "--set", "methods=ls,proposed",
                     "--set", "Imax=10"]) == 0
    out = capsys.readouterr().out
    means = {ln.split()[0]: float(ln.split("mean NMSE ")[1].split()[0]) for ln in out.splitlines()
             if "mean NMSE" in ln}
    pc = pipeline.PointConfig(methods=("ls", "proposed"), Imax=10)
    ref = runner.run_point(pc, float(10 ** -0.5), 4, device="cpu")
    assert means == {m: float(np.mean(ref[m])) for m in ref}
    assert cli.main(["panel", "--batch", "--cpu", "--set", "nope=1"]) == 1


def test_orbax_npz_resume_is_bit_exact(tmp_path, capsys):
    args = ["run", "error_vs_snr", "--cpu", "--n-mc", "3", "--no-plot", "--methods", "ls", "--checkpoint-dir",
            str(tmp_path / "ck"), "--checkpoint-backend", "orbax"]
    try:
        assert cli.main(args + ["--out", str(tmp_path / "a")]) == 0
        first = json.loads((tmp_path / "a" / "error_vs_snr.json").read_text())
        files = sorted((tmp_path / "ck").glob("error_vs_snr.snr_db.*.npz"))
        assert len(files) == 11
        with np.load(tmp_path / "ck" / "error_vs_snr.snr_db.4.npz") as z:
            assert z.files == ["ls"] and z["ls"].dtype == np.float32
            assert z["ls"].tolist() == first["raw"]["ls"][4]
        assert cli.main(args + ["--out", str(tmp_path / "b")]) == 0  # every point from the checkpoints
        second = json.loads((tmp_path / "b" / "error_vs_snr.json").read_text())
        assert second["curves"] == first["curves"] and "raw" not in second
    finally:
        runner.set_default_checkpoint(None)
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        runner.set_default_checkpoint(str(tmp_path), "pickle")
