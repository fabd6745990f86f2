"""Card-only tests of the port's CUDA kernel against its plain version.

The fused ADMM kernel (``jstsp19_torch/kernels/csrc/admm_fused.cu``) has no
CPU mode, so these tests skip where no CUDA device is present.  This file
imports no JAX; on the GPU machine run it alone, without the JAX suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from jstsp19_torch.core import prng
from jstsp19_torch.harness.pipeline import (
    PointConfig,
    fused_point_errors,
    proposed_problem,
    realization_errors,
)
from jstsp19_torch.kernels.admm_fused import fused_tracked_admm, fused_tracked_admm_plain
from jstsp19_torch.solvers.admm import admm_hyperparams

pytestmark = pytest.mark.cuda

Bt, N, M, Gr, K = 8, 32, 140, 32, 16
IMAX = 25


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused ADMM kernel has no CPU mode")
    return torch.device("cuda")


def _problem(device, seed=0):
    """The random problem of tests/test_fused_admm.py at B=8, on ``device``."""
    rng = np.random.default_rng(seed)

    def c(*s):
        return torch.from_numpy(
            (rng.standard_normal(s) + 1j * rng.standard_normal(s)).astype(np.complex64)
        ).to(device)

    Omega = torch.from_numpy((rng.random((Bt, N, M)) < 0.5).astype(np.float32)).to(device)
    subY = c(Bt, N, M) * Omega
    A = c(Bt, N, Gr) / np.sqrt(N)
    B = c(Bt, K, M) / np.sqrt(K)
    tau_Y, tau_S, rho = admm_hyperparams(subY, c(Bt, Gr, K))
    return subY, Omega, A, B, tau_Y, tau_S, rho


@pytest.mark.parametrize("with_rank", [False, True])
def test_kernel_matches_plain(cuda, with_rank):
    """max|ΔS| ≤ 2e-4·max|S| at Imax=25 (tests/test_fused_admm.py:51-53):
    the kernel and its plain version run the same fp32 iteration, with sums
    in another order."""
    args = _problem(cuda, seed=int(with_rank))
    rank = None
    if with_rank:
        rng = np.random.default_rng(7)
        rank = torch.from_numpy(
            np.stack([rng.permutation(Gr * K).reshape(Gr, K) for _ in range(Bt)]).astype(np.int32)
        ).to(cuda)
    before = fused_tracked_admm.launches
    S, Y = fused_tracked_admm(*args, Imax=IMAX, support_rank=rank)
    torch.cuda.synchronize()
    assert fused_tracked_admm.launches == before + 1
    S_ref, _ = fused_tracked_admm_plain(*args, Imax=IMAX, support_rank=rank)
    scale = float(S_ref.abs().max())
    assert float((S - S_ref).abs().max()) <= 2e-4 * scale
    assert Y.shape == (Bt, N, M) and bool(torch.isfinite(torch.view_as_real(Y)).all())


@pytest.mark.parametrize("shape,track_rounds", [((4, 16, 40, 16, 8), 2), ((3, 8, 8, 4, 4), 1)])
def test_kernel_matches_plain_at_other_sizes(cuda, shape, track_rounds):
    """The kernel takes its sizes at run time: smaller problems, square
    N = M, more rounds per iteration; same tolerance as at the canonical size."""
    b, n, m, gr, k = shape
    g = torch.Generator(device=cuda).manual_seed(5)

    def c(*s):
        return torch.randn(*s, generator=g, device=cuda, dtype=torch.complex64)

    Omega = (torch.rand(b, n, m, generator=g, device=cuda) < 0.5).float()
    subY = c(b, n, m) * Omega
    A, B = c(b, n, gr) / n**0.5, c(b, k, m) / k**0.5
    args = (subY, Omega, A, B, *admm_hyperparams(subY, c(b, gr, k)))
    S, Y = fused_tracked_admm(*args, Imax=IMAX, track_rounds=track_rounds)
    S_ref, Y_ref = fused_tracked_admm_plain(*args, Imax=IMAX, track_rounds=track_rounds)
    assert float((S - S_ref).abs().max()) <= 2e-4 * float(S_ref.abs().max())
    assert float((Y - Y_ref).abs().max()) <= 2e-4 * float(Y_ref.abs().max())
    S0, Y0 = fused_tracked_admm(*args, Imax=0)
    assert not S0.abs().any() and not Y0.abs().any()


def test_kernel_is_deterministic(cuda):
    args = _problem(cuda, seed=2)
    S1, Y1 = fused_tracked_admm(*args, Imax=IMAX)
    S2, Y2 = fused_tracked_admm(*args, Imax=IMAX)
    assert torch.equal(S1, S2) and torch.equal(Y1, Y2)


def test_kernel_rejects_what_it_does_not_take(cuda):
    subY, Omega, A, B, tau_Y, tau_S, rho = _problem(cuda, seed=3)
    with pytest.raises(ValueError, match="contiguous"):
        fused_tracked_admm(subY, Omega, A.transpose(1, 2).contiguous().transpose(1, 2), B, tau_Y, tau_S, rho)
    with pytest.raises(ValueError, match="dtype"):
        fused_tracked_admm(subY, Omega.double(), A, B, tau_Y, tau_S, rho)
    with pytest.raises(ValueError, match="device"):
        fused_tracked_admm(subY, Omega.cpu(), A, B, tau_Y, tau_S, rho)
    with pytest.raises(ValueError, match="even N"):
        fused_tracked_admm(subY[:, :31], Omega[:, :31], A[:, :31], B, tau_Y, tau_S, rho)


def test_fused_route_matches_tracked_route_on_card(cuda):
    """The whole slice on the card: fused and plain tracked NMSE on the same
    draws agree at rtol 2e-3, atol 2e-4 (tests/test_fused_admm.py:90-92)."""
    pc = PointConfig(methods=("proposed", "proposed_angles"), Imax=IMAX, svt_method="fused")
    out = fused_point_errors(prng.realization_generators(5, 0, cuda), pc, 1.0, 16)
    ref = realization_errors(
        prng.realization_generators(5, 0, cuda), PointConfig(
            methods=pc.methods, Imax=IMAX, svt_method="tracked"), 1.0, 16
    )
    for m in pc.methods:
        torch.testing.assert_close(out[m], ref[m], rtol=2e-3, atol=2e-4)
    prob = proposed_problem(prng.realization_generators(5, 0, cuda), pc, 1.0, 16)
    assert prob["subY"].is_cuda and prob["rank"].dtype == torch.int32
