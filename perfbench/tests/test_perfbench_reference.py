"""The plain reference against the port's plain CPU routes (fused, and tracked with N > M), its SVT's transpose
identity, and the TF32 rounding of its control."""
import dataclasses

import numpy as np
import pytest
import torch

from perfbench import reference
from perfbench.reference.frontend import to_tf32

FRONTEND = ("Zbar", "subY", "A", "B", "tau_Y", "tau_S", "rho")


def small_point(beamformer):
    from jstsp19_torch.harness.pipeline import PointConfig

    pc = PointConfig(Nt=2, Nr=16, Mr_e=16, Mr=4, Gr=16, Gt=2, L=3, T=10, Imax=25, beamformer=beamformer,
                     methods=reference.METHODS, svt_method="fused")
    return pc, {f.name: getattr(pc, f.name) for f in dataclasses.fields(pc)}


@pytest.mark.parametrize("beamformer", ["ZC", "fft"])
def test_reference_agrees_with_the_ports_plain_route(beamformer):
    from jstsp19_torch.core import prng
    from jstsp19_torch.harness.pipeline import proposed_problem
    from jstsp19_torch.harness.runner import run_point
    from jstsp19_torch.kernels.admm_fused import fused_tracked_admm

    pc, point = small_point(beamformer)
    seed, k, nv, batch = 2**31 + 99, 7, 10 ** -0.5, 6
    prob = proposed_problem(prng.realization_generators(seed, k, "cpu"), pc, nv, batch)
    ref = reference.problem(point, nv, batch, seed, k, "cpu")
    for key in FRONTEND:
        assert float((prob[key] - ref[key]).abs().max() / ref[key].abs().max()) < 1e-5, key
    assert torch.equal(prob["Omega"], ref["Omega"]) and torch.equal(prob["rank"], ref["rank"])
    args = [prob[key] for key in ("subY", "Omega", "A", "B", "tau_Y", "tau_S", "rho")]
    errs = run_point(pc, nv, batch, seed=seed, sweep_index=k, device="cpu")
    for m in reference.METHODS:
        S, _ = fused_tracked_admm(*args, Imax=pc.Imax, support_rank=prob["rank"] if m == reference.ANGLES else None)
        S_ref = reference.solve(ref, point, m)
        assert float((S - S_ref).abs().max() / S_ref.abs().max()) < 1e-4, m
        nmse = reference.clamped_nmse(S_ref, ref["Zbar"]).numpy()
        np.testing.assert_allclose(errs[m], nmse, rtol=0, atol=1e-5)


def test_reference_agrees_with_the_ports_tracked_route_at_n_above_m():
    """N = Mr_e = 16 > M = T·Nt = 8: ``run_point`` runs the tracked route, its SVT on the transpose with the
    basis of the thin side.  Tolerances, as in the fused case: the front end 1e-5 of its largest entry (float32
    products summed in another order); S 1e-4 of its largest entry (25 iterations of the chain's P-form rotations
    against the reference's dense rotation matrices, both in float32, about 1e-6 apart a step); the NMSE 1e-5
    absolute (that gap in S, squared into a norm ratio that is at most 1)."""
    from jstsp19_torch.core import prng
    from jstsp19_torch.harness import pipeline
    from jstsp19_torch.harness.runner import run_point, svt_route
    from jstsp19_torch.solvers.admm import proposed_admm, proposed_admm_angles

    pc, point = small_point("ZC")
    pc = dataclasses.replace(pc, T=4, svt_method="tracked")
    point.update(T=4, svt_method="tracked")
    assert svt_route(pc) == "tracked" and pc.Mr_e > pc.T * pc.Nt
    seed, k, nv, batch = 2**31 + 77, 5, 10 ** -0.5, 6
    gens = prng.realization_generators(seed, k, "cpu")
    draws = pipeline.point_draws(gens, pc, nv, batch)
    ch, obs, A, B, tau_Y, tau_S, rho = pipeline._proposed_frontend(gens, pc, nv, batch, draws=draws)
    ref = reference.problem(point, nv, batch, seed, k, "cpu")
    got = dict(Zbar=ch.Zbar, subY=obs.Y, A=A, B=B, tau_Y=tau_Y, tau_S=tau_S, rho=rho)
    for key in FRONTEND:
        assert float((got[key] - ref[key]).abs().max() / ref[key].abs().max()) < 1e-5, key
    assert torch.equal(obs.Omega, ref["Omega"])
    errs = run_point(pc, nv, batch, seed=seed, sweep_index=k, device="cpu")
    kw = dict(svt_method="tracked", track_rounds=pc.track_rounds, track_precision=pc.track_precision)
    args = (A, B, pc.Imax, tau_Y, tau_S, rho)
    estimates = {"proposed": proposed_admm(obs.Y, obs.Omega, *args, **kw).S,
                 reference.ANGLES: proposed_admm_angles(obs.Y, obs.Omega, pipeline._oracle_order(ch.Zbar), *args,
                                                        **kw).S}
    for m in reference.METHODS:
        S_ref = reference.solve(ref, point, m)
        assert float((estimates[m] - S_ref).abs().max() / S_ref.abs().max()) < 1e-4, m
        nmse = reference.clamped_nmse(S_ref, ref["Zbar"]).numpy()
        np.testing.assert_allclose(errs[m], nmse, rtol=0, atol=1e-5)


def test_the_references_svt_of_a_tall_matrix_is_the_transpose_of_its_wide_form():
    """SVT(Wᵀ)ᵀ = SVT(W): the tall form (N > M, basis of the thin side M) gives, call by call, what the wide
    form (N <= M) gives on Wᵀ, bit for bit; and once its basis has converged, the exact SVT of W (float32
    rounding, 1e-5 of the largest entry)."""
    from perfbench.reference.admm import round_robin, tracked_svt
    from perfbench.reference.frontend import Products

    gen = torch.Generator().manual_seed(5)
    W = torch.randn((3, 10, 6), dtype=torch.complex64, generator=gen)
    tau = torch.tensor([0.5, 1.0, 2.0])
    rounds, mm = round_robin(6), Products()
    U_tall = U_wide = torch.eye(6, dtype=W.dtype).expand(3, 6, 6)
    for i in range(60):
        Y_tall, U_tall = tracked_svt(W, tau, U_tall, rounds[i % 5], mm)
        Y_wide, U_wide = tracked_svt(W.mT, tau, U_wide, rounds[i % 5], mm)
        assert torch.equal(Y_tall, Y_wide.mT) and torch.equal(U_tall, U_wide)
    u, sig, vh = torch.linalg.svd(W, full_matrices=False)
    exact = u @ (torch.clamp(sig - tau[:, None], min=0.0)[..., None] * vh).to(W.dtype)
    assert float((Y_tall - exact).abs().max() / exact.abs().max()) < 1e-5


def test_tf32_keeps_ten_mantissa_bits_rounded_to_nearest():
    x = torch.randn(1000, dtype=torch.float32) * 1e3
    y = to_tf32(x)
    assert torch.all((y.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((x - y).abs() <= x.abs() * 2.0 ** -11)
    z = torch.complex(x, -x)
    assert torch.equal(to_tf32(z), torch.complex(y, -y))
    assert float(to_tf32(torch.tensor([1.0 + 2.0 ** -12]))) == 1.0
    assert float(to_tf32(torch.tensor([1.0 + 3 * 2.0 ** -12]))) == 1.0 + 2.0 ** -10


def test_round_robin_pairs_every_index_once_a_round_and_every_pair_once():
    from perfbench.reference.admm import round_robin

    rounds = round_robin(8)
    assert len(rounds) == 7
    pairs = set()
    for p, q in rounds:
        assert sorted(p + q) == list(range(8)) and all(a < b for a, b in zip(p, q))
        pairs.update(zip(p, q))
    assert len(pairs) == 28
