"""The specialized recipes end to end on the CPU: the approximate-frontend
driver's deterministic core against JAX's on the same problem, the runner
with external taps against JAX's on the same taps, and every recipe through
the CLI, held to the schema of its JAX artifact in ``results/`` and, where
cheap, to the JAX reference run in ``results/torch_specialized_jax.json``
within 4 combined standard errors."""
import dataclasses
import functools
import json
import math
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.channel import nyu as jnyu  # noqa: E402
from jstsp19_tpu.channel import wideband_mmwave_channel as jchannel  # noqa: E402
from jstsp19_tpu.core import prng as jprng  # noqa: E402
from jstsp19_tpu.frontend import comm_system_training as jcomm  # noqa: E402
from jstsp19_tpu.harness import experiments as jexp  # noqa: E402
from jstsp19_tpu.harness import pipeline as jpipe  # noqa: E402
from jstsp19_tpu.harness import runner as jrunner  # noqa: E402
from jstsp19_torch import interop  # noqa: E402
from jstsp19_torch.__main__ import main  # noqa: E402
from jstsp19_torch.harness import experiments, pipeline, runner  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = json.loads((ROOT / "results" / "torch_specialized_jax.json").read_text())["recipes"]
NEW_RECIPES = ("rate_vs_framelength", "error_vs_snr_approx", "error_vs_zy", "error_vs_admmiters", "capacity",
               "energy_efficiency", "rank_r", "rank_r_quirks", "error_vs_snr_nyuwireless", "channel_correlation",
               "bar3_beamspace")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These batches are small: one intra-op thread each, so that the suite's
    parallel workers do not oversubscribe the cores (OpenMP threads spinning
    on small linear-algebra calls made these tests 100 times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_approx_problem(n, nv, seed=5):
    """JAX's approximate-frontend problem for n realization keys, as
    ``jstsp19_tpu.harness.experiments._approx_realization`` builds it."""
    keys = jprng.realization_keys(jprng.experiment_key(seed), 0, n)

    def one(key):
        ch = jchannel(jprng.role_key(key, jprng.ROLE_CHANNEL), 4, 32, 4, 2, 3, 32, 4)
        Yp, _, W, Omega, _, Psi = jcomm(key, ch.H, 70, nv, 0.75)
        A = W.conj().T @ ch.Dr
        B = jnp.einsum("gn,lnt->lgt", ch.Dt.conj().T, Psi).reshape(16, 70)
        return Yp, Omega, A, B, ch.Zbar

    return keys, [np.asarray(x) for x in jax.vmap(one)(keys)]


def test_approx_driver_core_matches_jax_on_the_same_problem():
    """Given JAX's Y_p, Ω, A and B (4 realizations, 0 dB), the port's τ_X,
    τ_S and ρ equal JAX's formulas at rtol 1e-5, and the NMSE after
    ``proposed_admm`` + ``ls_estimate`` equals JAX's ``_approx_realization``
    per realization at Imax=10 in both modes within the ADMM guard (rtol 2e-3,
    atol 2e-4; tests/test_fused_admm.py:90-92)."""
    nv = 1.0
    keys, (Yp, Omega, A, B, Zbar) = _jax_approx_problem(4, nv)
    tau_X, tau_S, rho = experiments._approx_hyperparams(interop.to_torch(Yp))
    jt = 1.0 / np.sum(np.abs(Yp.astype(np.complex128)) ** 2, axis=(-2, -1))
    ev = np.linalg.eigvalsh(np.asarray(jnp.asarray(Yp) @ jnp.swapaxes(jnp.asarray(Yp).conj(), -2, -1)))
    jrho = np.sqrt(np.maximum(ev[:, -6], 0.0) * (jt + jt / 2) / 2)
    np.testing.assert_allclose(tau_X.numpy(), jt, rtol=1e-5)
    np.testing.assert_allclose(tau_S.numpy(), jt / 2, rtol=1e-5)
    np.testing.assert_allclose(rho.numpy(), jrho, rtol=1e-5)
    assert np.all(np.abs(A - A[0]) == 0)  # the FFT combiner: one shared A
    args = [interop.to_torch(x) for x in (Yp, Omega, A[0], B, Zbar)]
    for mode in ("exact", "approximate"):
        got = experiments._approx_errors(*args, 10, mode).numpy()
        want = np.asarray(jax.vmap(lambda k: jexp._approx_realization(
            k, jnp.float32(nv), T=70, sub_ratio=0.75, Imax=10, mode=mode))(keys))
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


@functools.lru_cache(maxsize=None)
def _synthetic_jax_taps(n):
    """The JAX NYU recipe's synthetic taps: n canonical channels, each tap
    normalized."""
    keys = jprng.realization_keys(jprng.experiment_key(0), 9999, n)
    H = jax.vmap(lambda k: jchannel(jprng.role_key(k, jprng.ROLE_CHANNEL), 4, 32, 4, 2, 3, 32, 4).H)(keys)
    return np.asarray(jnyu.normalize_taps(H))


def test_run_point_with_taps_checks_the_batch_and_routes_fused_to_tracked():
    taps = interop.taps_to_torch(_synthetic_jax_taps(48)[:3])
    pc = pipeline.PointConfig(methods=("ls", "proposed"), Imax=5, svt_method="fused")
    with pytest.raises(ValueError, match="taps batch 3 != n_mc 4"):
        runner.run_point(pc, 1.0, 4, device="cpu", taps=taps)
    assert runner.svt_route(pc, with_taps=True) == "tracked" and runner.svt_route(pc) == "fused"
    got = runner.run_point(pc, 1.0, 3, device="cpu", taps=taps)
    want = runner.run_point(dataclasses.replace(pc, svt_method="tracked"), 1.0, 3, device="cpu", taps=taps)
    for m in ("ls", "proposed"):
        np.testing.assert_array_equal(got[m], want[m])
    # the taps are the channel (LS is clamped at 1 at this point either way)
    base = runner.run_point(dataclasses.replace(pc, svt_method="eigh"), 1.0, 3, device="cpu")
    assert not np.array_equal(base["proposed"], got["proposed"])


def test_run_point_on_jax_taps_matches_jax_by_ensemble():
    """The same 48 normalized taps through both runners (LS and the
    proposed ADMM, Imax=20, 0 dB): each method's mean NMSE within 4 combined
    standard errors (training, noise and masks differ: each package draws
    its own); measured |z| ≤ 1.3."""
    n = 48
    taps = _synthetic_jax_taps(n)
    pc = dict(methods=("ls", "proposed"), Imax=20)
    got = runner.run_point(pipeline.PointConfig(**pc), 1.0, n, seed=2, device="cpu", taps=interop.taps_to_torch(taps))
    want = jrunner.run_point(jpipe.PointConfig(**pc), 1.0, n, seed=2, taps=jnp.asarray(taps))
    for m in ("ls", "proposed"):
        g, w = got[m], np.asarray(want[m])
        se = math.sqrt(g.var(ddof=1) / n + w.var(ddof=1) / n)
        assert abs(g.mean() - w.mean()) <= 4 * se, (m, g.mean(), w.mean(), se)


def test_registry_is_the_jax_one_less_time_comparisons():
    # time_comparisons is ported too now: the registry is the JAX one
    assert set(experiments.EXPERIMENTS) == set(jexp.EXPERIMENTS)
    assert set(NEW_RECIPES) <= set(experiments.EXPERIMENTS)


def _z(mean, sd, n, ref, i, floor=0.0):
    """z of a port mean (sd, n realizations) against the reference point i,
    with ``floor``, the metric's numerical resolution, added in quadrature."""
    se = math.sqrt(ref["sd"][i] ** 2 / ref["n"][i] + sd**2 / n + floor**2)
    return (mean - ref["mean"][i]) / se if se > 0 else (0.0 if mean == ref["mean"][i] else math.inf)


def _floor(name, ref_curve):
    """A float32 Gram's eigenvalues are resolved to about Mr_e·eps of the
    largest, so the rank recipes' singular values to sqrt(Mr_e·eps) of the
    largest: the null space's values are roundoff in both packages."""
    if name.startswith("rank_r"):
        return math.sqrt(len(ref_curve["mean"]) * float(np.finfo(np.float32).eps)) * max(ref_curve["mean"])
    return 0.0


# n_mc each recipe runs at here, and whether its curves are held to the JAX
# reference within 4 SE (the cheap ones); measured |z| ≤ 3.2 over them
CLI_CASES = {
    "rate_vs_framelength": (8, True),
    "error_vs_snr_approx": (2, False),
    "error_vs_zy": (4, False),
    "error_vs_admmiters": (4, False),
    "capacity": (128, True),
    "energy_efficiency": (128, True),
    "rank_r": (32, True),
    "rank_r_quirks": (32, True),
    "error_vs_snr_nyuwireless": (2, False),
    "channel_correlation": (1, False),
    "bar3_beamspace": (1, False),
}


@pytest.mark.parametrize("name", NEW_RECIPES)
def test_recipe_through_the_cli_has_the_jax_schema(name, tmp_path):
    """``python -m jstsp19_torch run <name> --cpu --n-mc N --no-plot``
    in-process: the JSON's keys, sweep values and curve names are those of
    ``results/<name>.json``, every value is finite, and the cheap recipes'
    every point lies within 4 combined SE of the JAX reference."""
    n_mc, held = CLI_CASES[name]
    kept = {}
    recipe = experiments.EXPERIMENTS[name]
    # the CLI calls the registry's recipe: keep its SweepResult for the per-point sd
    experiments.EXPERIMENTS[name] = lambda **kw: kept.setdefault("res", recipe(**kw))
    try:
        assert main(["run", name, "--cpu", "--n-mc", str(n_mc), "--no-plot", "--out", str(tmp_path)]) == 0
    finally:
        experiments.EXPERIMENTS[name] = recipe
    got = json.loads((tmp_path / f"{name}.json").read_text())
    art = json.loads((ROOT / "results" / f"{name}.json").read_text())
    assert set(got) == set(art) and got["sweep"] == art["sweep"] and set(got["curves"]) == set(art["curves"])
    assert got["n_mc"] == n_mc and got["experiment"] == name
    for k in set(got) - {"experiment", "sweep", "n_mc", "curves", "seconds"}:
        assert type(got[k]) is type(art[k]), k
    for curve in got["curves"].values():
        assert all(math.isfinite(v) for v in curve)
    if name in ("rank_r", "rank_r_quirks"):
        assert got["rank_marker"] == art["rank_marker"]
    ref = REFERENCE[name]
    assert ref["sweep"] == got["sweep"] and set(ref["curves"]) == set(got["curves"])
    if held:
        sd = kept["res"].sd
        worst = max(abs(_z(v, sd[m][i], n_mc, ref["curves"][m], i, _floor(name, ref["curves"][m])))
                    for m, c in got["curves"].items() for i, v in enumerate(c))
        assert worst <= 4, worst


def test_nyu_recipe_reads_taps_from_a_mat_file(tmp_path):
    """``--mat-path``: the recipe takes its shapes from the file (3
    realizations of 2 taps, 16×2 antennas: Gr = Mr_e = 16, Mr = 2, Gt = 2)
    and runs at most as many realizations as the file holds."""
    import scipy.io

    rng = np.random.default_rng(9)
    cells = np.empty((3, 2), dtype=object)
    for idx in np.ndindex(3, 2):
        cells[idx] = rng.standard_normal((16, 2)) + 1j * rng.standard_normal((16, 2))
    path = tmp_path / "nyu.mat"
    scipy.io.savemat(path, {"Hf": cells})
    kept = {}
    recipe = experiments.EXPERIMENTS["error_vs_snr_nyuwireless"]
    experiments.EXPERIMENTS["error_vs_snr_nyuwireless"] = lambda **kw: kept.setdefault("kw", kw) and recipe(**kw)
    try:
        assert main(["run", "error_vs_snr_nyuwireless", "--cpu", "--n-mc", "8", "--no-plot", "--mat-path", str(path),
                     "--out", str(tmp_path / "out")]) == 0
    finally:
        experiments.EXPERIMENTS["error_vs_snr_nyuwireless"] = recipe
    assert kept["kw"]["mat_path"] == str(path)
    got = json.loads((tmp_path / "out" / "error_vs_snr_nyuwireless.json").read_text())
    assert got["n_mc"] == 3 and all(len(p) == 3 for p in got["raw"]["ls"])
    assert all(math.isfinite(v) for c in got["curves"].values() for v in c)


@pytest.mark.parametrize("name", ["channel_correlation", "bar3_beamspace"])
def test_single_channel_recipes_match_jax_over_seeds(name):
    """One channel a seed: over seeds 0-63 each point's mean lies within 4
    combined SE (each side's own sd) of the JAX reference over 64 seeds
    (the maxima are heavy-tailed: 8 seeds were too few for a normal z);
    measured |z| ≤ 2.4."""
    runs = [experiments.EXPERIMENTS[name](seed=s, device="cpu") for s in range(64)]
    ref = REFERENCE[name]["curves"]
    for m in ref:
        v = np.stack([np.asarray(r.curves[m]) for r in runs])
        mean, sd = v.mean(axis=0), v.std(axis=0, ddof=1)
        se = np.sqrt(sd**2 / 8 + np.asarray(ref[m]["sd"]) ** 2 / np.asarray(ref[m]["n"]))
        assert np.all(np.abs(mean - np.asarray(ref[m]["mean"])) <= 4 * se), m
