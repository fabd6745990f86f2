"""The slice as a whole: the port's errorVSsnr pipeline against the JAX
package's, on the same problem (carried across as numpy) and by ensemble."""
import dataclasses
import json
import math
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.core import prng as jprng  # noqa: E402
from jstsp19_tpu.harness import pipeline as jpipe  # noqa: E402
from jstsp19_torch import interop  # noqa: E402
from jstsp19_torch.core import prng  # noqa: E402
from jstsp19_torch.core.metrics import clamped_nmse  # noqa: E402
from jstsp19_torch.harness import pipeline  # noqa: E402
from jstsp19_torch.kernels.admm_fused import fused_tracked_admm  # noqa: E402

IMAX = 25
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


def test_slice_matches_jax_fused_point_errors():
    """JAX proposed_problem (vmapped) → interop → the port's
    fused_tracked_admm + clamped_nmse equals JAX fused_point_errors in
    interpret mode at rtol 2e-3, atol 2e-4 (tests/test_fused_admm.py:90-92)."""
    pc_j = jpipe.PointConfig(methods=("proposed", "proposed_angles"), Imax=IMAX, svt_method="tracked")
    keys = jprng.realization_keys(jprng.experiment_key(3), 0, 2)
    nv = jnp.asarray(1.0, jnp.float32)
    prob_j = jax.vmap(lambda k: jpipe.proposed_problem(k, pc_j, nv))(keys)
    ref = jpipe.fused_point_errors(keys, pc_j, nv, interpret=True)
    prob = interop.problem_to_torch({k: np.asarray(v) for k, v in prob_j.items()})
    args = [prob[k] for k in ("subY", "Omega", "A", "B", "tau_Y", "tau_S", "rho")]
    for method, rank in (("proposed", None), ("proposed_angles", prob["rank"])):
        S, _ = fused_tracked_admm(*args, Imax=IMAX, support_rank=rank)
        got = clamped_nmse(S, prob["Zbar"]).numpy()
        np.testing.assert_allclose(got, np.asarray(ref[method]), rtol=2e-3, atol=2e-4)
    back = interop.problem_to_numpy(prob)
    np.testing.assert_array_equal(back["subY"], np.asarray(prob_j["subY"]))


def test_port_problem_matches_jax_frontend_on_the_same_draws():
    """Given one realization's channel, training, noise and mask drawn by
    JAX, the port's frontend stages (dictionaries, observation,
    hyper-parameters, support rank) rebuild JAX's problem tuple."""
    from jstsp19_torch.frontend import create_beamformer
    from jstsp19_torch.frontend.measurement import received_frame
    from jstsp19_torch.solvers.admm import admm_hyperparams, support_rank_from_order

    pc_j = jpipe.PointConfig(methods=("proposed",), Imax=IMAX)
    key = jprng.realization_keys(jprng.experiment_key(4), 0, 1)[0]
    nv = jnp.asarray(1.0, jnp.float32)
    ch_j, Psi_j, N_j, W_j = jpipe._system_realization(key, pc_j, nv)
    _, obs_j, A_j, B_j, tY, tS, rh = jpipe._proposed_frontend(key, pc_j, nv)
    prob_j = jpipe.proposed_problem(key, pc_j, nv)

    ch = interop.channel_to_torch(ch_j)
    Psi, N = interop.to_torch(Psi_j), interop.to_torch(N_j)
    W = create_beamformer(32, "ZC")
    np.testing.assert_allclose(W.numpy(), np.asarray(W_j), rtol=1e-5)
    Omega = interop.to_torch(obs_j.Omega)
    Y = Omega * (W.mH @ received_frame(ch.H, Psi, N))
    np.testing.assert_allclose(Y.numpy(), np.asarray(obs_j.Y), rtol=1e-5)
    A, B = pipeline._dictionaries(ch, W, Psi)
    # entries that cancel to near zero in a 32-term sum: atol relative to the scale
    for got, want in ((A, A_j), (B, B_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    hp = admm_hyperparams(Y, ch.Zbar)
    for g, w in zip(hp, (tY, tS, rh)):  # eigh-based ρ: 1e-4 (two float32 eigensolvers)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4)
    rank = support_rank_from_order(pipeline._oracle_order(ch.Zbar), 512).reshape(32, 16)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(prob_j["rank"]))


def test_fused_route_equals_tracked_route_on_cpu():
    """On CPU generators both routes run the same plain solve on the same draws."""
    pc = pipeline.PointConfig(methods=("proposed", "proposed_angles"), Imax=IMAX, svt_method="fused")
    out = pipeline.fused_point_errors(prng.realization_generators(1, 0, "cpu"), pc, 1.0, 4)
    ref = pipeline.realization_errors(
        prng.realization_generators(1, 0, "cpu"), dataclasses.replace(pc, svt_method="tracked"), 1.0, 4)
    for m in pc.methods:
        torch.testing.assert_close(out[m], ref[m])
        assert out[m].shape == (4,)
    raw = pipeline.realization_errors(
        prng.realization_generators(1, 0, "cpu"), dataclasses.replace(pc, svt_method="tracked"),
        1.0, 4, clamp=False, with_zbar=True)
    assert raw["Zbar"].shape == (4, 32, 16)
    torch.testing.assert_close(torch.clamp(raw["proposed"], max=1.0), ref["proposed"])


def test_unported_methods_and_routes_raise():
    gens = prng.realization_generators(0, 0, "cpu")
    with pytest.raises(ValueError, match="unknown method"):
        pipeline.realization_errors(gens, pipeline.PointConfig(methods=("omp_tdd", "proposed"), Imax=2), 1.0, 1)
    with pytest.raises(ValueError, match="fused_point_errors"):
        pipeline.realization_errors(
            gens, pipeline.PointConfig(methods=("proposed",), svt_method="fused", Imax=2), 1.0, 1)
    with pytest.raises(ValueError, match="approximate"):
        pipeline.fused_point_errors(
            gens, pipeline.PointConfig(methods=("proposed",), admm_mode="exact", Imax=2), 1.0, 1)
    pc = pipeline.PointConfig()
    assert (pc.T_prop, pc.T_hbf) == (jpipe.PointConfig().T_prop, jpipe.PointConfig().T_hbf)


def test_ensemble_mean_nmse_at_0db_matches_reference():
    """The port's own fused_point_errors (CPU: the plain version), B=32,
    Imax=100, 0 dB: the batch mean of 'proposed' lies within 4 combined
    standard errors of the same-ensemble reference run
    (results/error_vs_snr.json, n_mc=64, mean 0.2444, sd 0.107)."""
    d = json.loads((ROOT / "results" / "error_vs_snr.json").read_text())
    raw = np.asarray(d["raw"]["proposed"][d["sweep"]["snr_db"].index(0.0)])
    pc = pipeline.PointConfig(methods=("proposed", "proposed_angles"), svt_method="fused")
    out = pipeline.fused_point_errors(prng.realization_generators(0, 0, "cpu"), pc, 1.0, 32)
    e = out["proposed"].double().numpy()
    assert np.all(np.isfinite(e)) and e.min() >= 0 and e.max() <= 1
    se = math.sqrt(raw.var(ddof=1) / raw.size + e.var(ddof=1) / e.size)
    assert abs(e.mean() - raw.mean()) < 4 * se
    assert out["proposed_angles"].mean() < out["proposed"].mean()  # oracle support helps
