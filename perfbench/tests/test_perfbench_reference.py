"""The plain reference against the port's plain CPU route, and the TF32 rounding of its control."""
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
