"""Card-only tests of the port's CUDA kernels against their plain versions.

The kernels (``jstsp19_torch/kernels/csrc/*.cu``) have no CPU mode, so
these tests skip where no CUDA device is present.  This file
imports no JAX; on the GPU machine run it alone, without the JAX suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from jstsp19_torch.core import prng
from jstsp19_torch.harness import runner
from jstsp19_torch.harness.pipeline import (
    PointConfig,
    fused_point_errors,
    proposed_problem,
    realization_errors,
)
from jstsp19_torch.core.metrics import clamped_nmse
from jstsp19_torch.kernels import admm_fused, dictionary
from jstsp19_torch.kernels.admm_fused import fused_tracked_admm, fused_tracked_admm_plain
from jstsp19_torch.kernels.dictionary import dict_correlation, dict_correlation_plain
from jstsp19_torch.kernels.softthresh import fused_soft_threshold, fused_soft_threshold_plain
from jstsp19_torch.kernels import wht
from jstsp19_torch.kernels.wht import fwht_kernel, fwht_plain, ifwht_plain
from jstsp19_torch.harness import hadamard_cs as hcs
from jstsp19_torch.solvers.admm import admm_hyperparams, proposed_admm
from jstsp19_torch.solvers.gamp_full import GampOptions, gamp_est

pytestmark = pytest.mark.cuda

Bt, N, M, Gr, K = 8, 32, 140, 32, 16
IMAX = 25
# (M, K) of the 12 distinct shapes the fused route reaches in the seven
# sweep recipes (N = Gr = 32; M = T*Nt, K = Gt*L)
SWEEP_MK = ((140, 16), (40, 32), (120, 32), (200, 32), (280, 32), (40, 16), (60, 24), (80, 32),
            (100, 40), (210, 24), (420, 48), (400, 64))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused ADMM kernel has no CPU mode")
    return torch.device("cuda")


def _crandn(device, *shape, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=device, dtype=torch.complex64)


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


@pytest.mark.parametrize("shape,track_rounds", [
    ((4, 16, 40, 16, 8), 2), ((3, 8, 8, 4, 4), 1), ((2, 6, 10, 5, 3), 1), ((2, 40, 90, 36, 12), 1),
    ((2, 66, 80, 34, 6), 1), ((2, 66, 200, 32, 16), 2),
    *(((4, 32, m, 32, k), 1) for m, k in SWEEP_MK),
])
def test_kernel_matches_plain_at_other_sizes(cuda, shape, track_rounds):
    """The kernel takes its sizes at run time: smaller problems, square
    N = M, more rounds per iteration, odd sizes, N > 32 (two and three
    groups of 32 rows), all of them on the instance with sizes at run time,
    and every fused-route sweep shape, several column tiles among them; same
    tolerance as at the canonical size."""
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


@pytest.mark.parametrize("batch", [1, 133])
def test_kernel_at_one_block_and_over_a_wave(cuda, batch):
    """One realization, and 133 (one block more than the card's 132 SMs):
    the batch agrees with the plain version, two runs are bit-equal, and the
    first and last realizations agree with each solved alone (within 1e-5:
    the wrapper's batched A^H A and B B^H may round differently)."""
    g = torch.Generator(device=cuda).manual_seed(batch)

    def c(*s):
        return torch.randn(*s, generator=g, device=cuda, dtype=torch.complex64)

    Omega = (torch.rand(batch, N, M, generator=g, device=cuda) < 0.5).float()
    subY = c(batch, N, M) * Omega
    args = (subY, Omega, c(batch, N, Gr) / N**0.5, c(batch, K, M) / K**0.5, *admm_hyperparams(subY, c(batch, Gr, K)))
    S, Y = fused_tracked_admm(*args, Imax=IMAX)
    S_ref, _ = fused_tracked_admm_plain(*args, Imax=IMAX)
    assert float((S - S_ref).abs().max()) <= 2e-4 * float(S_ref.abs().max())
    S2, Y2 = fused_tracked_admm(*args, Imax=IMAX)
    assert torch.equal(S, S2) and torch.equal(Y, Y2)
    for i in (0, batch - 1):
        S_i, _ = fused_tracked_admm(*(a[i:i + 1] for a in args), Imax=IMAX)
        assert float((S_i[0] - S[i]).abs().max()) <= 1e-5 * float(S[i].abs().max())


def test_plan_matches_the_kernel_layout(cuda):
    """The plan's shared-memory bytes are the kernel's own Layout; each
    kernel instance's registers leave room for the blocks its plan puts on
    an SM, and the card holds them; errorVSnrf's transposed shape runs an
    instance of its own, three blocks an SM."""
    for m, k in SWEEP_MK:
        assert admm_fused.smem_bytes(N, Gr, k) == 4 * admm_fused._layout_floats(N, Gr, k)
    for n, gr, k in ((40, 36, 12), (66, 32, 16), (20, 16, 32)):
        assert admm_fused.smem_bytes(n, gr, k) == 4 * admm_fused._layout_floats(n, gr, k)
    shapes = {  # (N, M, Gr, K): the instance that runs it
        (32, 140, 32, 16): "fused_admm_kernel<32, 32, 1, 0, 2>",
        (66, 200, 32, 16): "fused_admm_kernel<0, 0, 0, 0, 2>",
        (20, 32, 16, 32): "fused_admm_kernel<20, 16, 1, 32, 3>",
    }
    for (n, m, gr, k), name in shapes.items():
        assert admm_fused.instance(n, gr, k) == name
        pl = admm_fused.plan(n, m, gr, k)
        regs = admm_fused._library().fused_tracked_admm_registers(n, gr, k)
        blocks = admm_fused.blocks_per_sm(n, gr, k, pl.smem_bytes)
        assert 0 < regs and blocks * admm_fused.THREADS * regs <= 65536
        assert blocks >= pl.blocks_per_sm
    assert admm_fused.blocks_per_sm(20, 16, 32, admm_fused.smem_bytes(20, 16, 32)) == 3


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


def test_run_point_fused_at_shapes_the_kernel_cannot_hold(cuda):
    """Nr = Mr_e = Gr = 64 needs 255,296 B of shared memory: run_point with
    'fused' takes the tracked route there instead of raising, and its NMSE
    equals the tracked route's at rtol 2e-3, atol 2e-4."""
    pc = PointConfig(Nr=64, Mr_e=64, Gr=64, methods=("proposed", "proposed_angles"), Imax=IMAX)
    before = fused_tracked_admm.launches
    got = runner.run_point(dataclasses.replace(pc, svt_method="fused"), 1.0, 8, seed=3)
    assert fused_tracked_admm.launches == before
    want = runner.run_point(dataclasses.replace(pc, svt_method="tracked"), 1.0, 8, seed=3)
    for m in pc.methods:
        np.testing.assert_allclose(got[m], want[m], rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("shape,shared", [
    ((256, 32, 20, 32, 16), False),   # the errorVSnrf ADMM
    ((256, 4, 16, 32, 16), False),   # VAMP's adjoint at Mr=4
    ((256, 8, 16, 32, 16), False),   # VAMP's adjoint at Mr=8
    ((256, 12, 16, 32, 16), False),  # VAMP's adjoint at Mr=12
    ((256, 16, 16, 32, 16), False),  # VAMP's adjoint at Mr=16
    ((256, 32, 140, 32, 16), True),   # canonical, the TPU signature
    ((256, 32, 140, 32, 16), False),  # canonical, the tracked route
    ((5, 32, 400, 32, 64), False),    # errorVSnt Nt=16: thirteen tiles, two row passes
    ((3, 7, 9, 5, 3), True),          # odd sizes
    ((256, 32, 80, 32, 16), False),   # the errorVSnrf ADMM at Mr=16
    ((1, 32, 20, 32, 16), False),     # batch 1: half a block
    ((255, 32, 140, 32, 16), True),   # a batch that is not a multiple of the realizations a block
    ((257, 4, 16, 32, 16), False),    # ... nor here
])
def test_dict_correlation_kernel_matches_plain(cuda, shape, shared):
    """max|Δ| ≤ 1e-5·max|ref|: the same fp32 contractions in another order."""
    b, N, M, Gr, Kd = shape
    A = _crandn(cuda, *(() if shared else (b,)), N, Gr, seed=1)
    K = _crandn(cuda, b, N, M, seed=2)
    B = _crandn(cuda, *(() if shared else (b,)), Kd, M, seed=3)
    before = dict_correlation.launches
    out = dict_correlation(A, K, B)
    torch.cuda.synchronize()
    assert dict_correlation.launches == before + 1 and out.shape == (b, Gr, Kd)
    ref = dict_correlation_plain(A, K, B)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(out, dict_correlation(A, K, B))  # deterministic


def test_dict_correlation_rejects_what_it_does_not_take(cuda):
    A, K, B = _crandn(cuda, 4, 32, 32), _crandn(cuda, 4, 32, 20), _crandn(cuda, 4, 16, 20)
    with pytest.raises(ValueError, match="contiguous"):
        dict_correlation(A, K.transpose(1, 2).contiguous().transpose(1, 2), B)
    with pytest.raises(ValueError, match="dtype"):
        dict_correlation(A, K.to(torch.complex128), B)
    with pytest.raises(ValueError, match="shape"):
        dict_correlation(A[:3], K, B)
    with pytest.raises(ValueError, match="shared memory"):  # A alone is 256 KB
        dict_correlation(_crandn(cuda, 256, 128), _crandn(cuda, 1, 256, 50), _crandn(cuda, 16, 50))


def test_dict_correlation_takes_views_off_a_16_byte_boundary(cuda):
    """K, A and B each a view that starts 8 bytes past a 16-byte boundary
    (a storage offset of one complex entry): the kernel takes them with
    8-byte copies, max|Δ| ≤ 1e-5·max|ref|; so does an odd M."""
    b, N, M, Gr, Kd = 64, 32, 20, 32, 16

    def shifted(*shape, seed):
        flat = _crandn(cuda, 1 + int(np.prod(shape)), seed=seed)
        return flat[1:].view(*shape)

    for A, K, B in ((shifted(b, N, Gr, seed=1), shifted(b, N, M, seed=2), shifted(b, Kd, M, seed=3)),
                    (_crandn(cuda, b, N, Gr, seed=1), _crandn(cuda, b, N, M + 1, seed=2),
                     _crandn(cuda, b, Kd, M + 1, seed=3))):
        assert K.data_ptr() % 16 == 8 or K.shape[-1] % 2 == 1
        before = dict_correlation.launches
        out = dict_correlation(A, K, B)
        torch.cuda.synchronize()
        assert dict_correlation.launches == before + 1
        ref = dict_correlation_plain(A, K, B)
        assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_dict_plan_matches_the_library(cuda):
    """kernels/dictionary.py::plan's shared memory is the library's count at
    every shape the port launches; a plan the kernel cannot run (a tile
    that is not a multiple of 4 columns, more threads than a block) is
    refused by the library without a launch."""
    lib = dictionary._library()
    for N, M, Gr, Kd in [(32, m, 32, 16) for m in (20, 40, 60, 80, 140)] + [
            (mr, 16, 32, 16) for mr in (4, 8, 12, 16)] + [(32, 400, 32, 64), (7, 9, 5, 3)]:
        p = dictionary.plan(N, M, Gr, Kd)
        assert lib.dict_correlation_smem_bytes(N, Gr, p.rpb, p.tk, p.mt) == p.smem_bytes, (N, M, Gr, Kd)
    A, K, B = _crandn(cuda, 2, 32, 32), _crandn(cuda, 2, 32, 20), _crandn(cuda, 2, 16, 20)
    out = torch.empty(2, 32, 16, dtype=torch.complex64, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for rpb, tk, mt in ((2, 8, 6), (16, 32, 20), (3, 8, 20)):
        args = dictionary.params(2, 32, 20, 32, 16, 32 * 32, 16 * 20, dictionary.DictPlan(rpb, tk, mt, 0))
        rc = lib.dict_correlation_launch(A.data_ptr(), K.data_ptr(), B.data_ptr(), out.data_ptr(),
                                         ctypes.addressof(args), stream)
        assert rc != 0, (rpb, tk, mt)


@pytest.mark.parametrize("per_matrix", [False, True])
def test_soft_threshold_kernel_matches_plain(cuda, per_matrix):
    """max|Δ| ≤ 1e-6 (measured 0: the same float32 operations), NaN
    passed through as the plain version does."""
    v = _crandn(cuda, 256, 32, 16, seed=4) * 0.3
    v[0, 0, 0] = complex(float("nan"), 0.0)
    tau = torch.rand(256, 1, 1, device=cuda) * 0.4 if per_matrix else 0.2
    before = fused_soft_threshold.launches
    out = fused_soft_threshold(v, tau)
    torch.cuda.synchronize()
    assert fused_soft_threshold.launches == before + 1
    ref = fused_soft_threshold_plain(v, tau)
    assert torch.equal(torch.isnan(out.real), torch.isnan(ref.real))
    fin = torch.isfinite(ref.real)
    assert float((out - ref)[fin].abs().max()) <= 1e-6


@pytest.mark.parametrize("case", ["broadcast tau", "odd total", "scalar tau", "0-dim tau",
                                  "v off a 16-byte boundary", "tau over the outer dimension"])
def test_soft_threshold_kernel_tau_layouts(cuda, case):
    """Equal to the plain version (max|Δ| ≤ 1e-6; the same float32
    operations) with a τ broadcast over every matrix (stride 0), an odd
    count of entries a matrix and in all, a number (passed by value), a
    0-dim τ on the card, a v that starts 8 bytes past a 16-byte boundary,
    and a τ (B1, 1, 1, 1) over v (B1, B2, n, m)."""
    shape, tau = (256, 32, 16), None
    if case == "broadcast tau":
        tau = torch.full((1, 1, 1), 0.2, device=cuda).expand(256, 1, 1)
    elif case == "odd total":
        shape, tau = (3, 5, 7), torch.rand(3, 1, 1, device=cuda)
    elif case == "scalar tau":
        shape, tau = (5, 9, 7), 0.25
    elif case == "0-dim tau":
        tau = torch.tensor(0.15, device=cuda)
    elif case == "tau over the outer dimension":
        shape, tau = (4, 8, 32, 16), torch.rand(4, 1, 1, 1, device=cuda) * 0.4
    v = _crandn(cuda, *shape, seed=5) * 0.3
    if case == "v off a 16-byte boundary":
        v = (_crandn(cuda, 1 + v.numel(), seed=5) * 0.3)[1:].view(shape)
        tau = torch.rand(256, 1, 1, device=cuda) * 0.4
        assert v.data_ptr() % 16 == 8
    before = fused_soft_threshold.launches
    out = fused_soft_threshold(v, tau)
    torch.cuda.synchronize()
    assert fused_soft_threshold.launches == before + 1
    assert float((out - fused_soft_threshold_plain(v, tau)).abs().max()) <= 1e-6


def test_soft_threshold_rejects_what_it_does_not_take(cuda):
    v = _crandn(cuda, 4, 32, 16)
    before = fused_soft_threshold.launches
    with pytest.raises(ValueError, match="dtype"):
        fused_soft_threshold(v.to(torch.complex128), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        fused_soft_threshold(v.transpose(1, 2), 0.1)
    with pytest.raises(ValueError, match=r"\(\.\.\., n, m\)"):
        fused_soft_threshold(v.reshape(-1), 0.1)
    with pytest.raises(ValueError, match=r"\(\.\.\., 1, 1\)"):
        fused_soft_threshold(v, torch.full((4,), 0.1, device=cuda))
    assert fused_soft_threshold.launches == before


def test_unfused_solve_runs_the_kernels(cuda):
    """The unfused ADMM at the errorVSnrf shape launches both kernels once
    per iteration with the eigh SVT, and the fused kernel once with the
    tracked one (N > M, on the transpose: solvers/admm_transposed.py); each
    NMSE matches use_kernels=False at rtol 2e-3, atol 2e-4."""
    pc = PointConfig(Mr=16, T=5, methods=("proposed",))
    prob = proposed_problem(prng.realization_generators(2, 3, cuda), pc, 10 ** -0.5, 64)
    args = [prob[k] for k in ("subY", "Omega", "A", "B")] + [IMAX] + [
        prob[k] for k in ("tau_Y", "tau_S", "rho")]
    d0, s0, f0 = dict_correlation.launches, fused_soft_threshold.launches, fused_tracked_admm.launches
    for svt_method in ("eigh", "tracked"):
        S_on = proposed_admm(*args, svt_method=svt_method).S
        S_off = proposed_admm(*args, svt_method=svt_method, use_kernels=False).S
        torch.testing.assert_close(
            clamped_nmse(S_on, prob["Zbar"]), clamped_nmse(S_off, prob["Zbar"]), rtol=2e-3, atol=2e-4)
    assert dict_correlation.launches - d0 == IMAX
    assert fused_soft_threshold.launches - s0 == IMAX
    assert fused_tracked_admm.launches - f0 == 1


@pytest.mark.parametrize("n", [2, 64, 4096, *(1 << k for k in range(14, 21))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_fwht_kernel_matches_plain(cuda, n, dtype):
    """Bit-equal (max|Δ| = 0) in both orders and directions at every
    boundary of ``plan_fwht``: the kernel runs the plain version's additions
    in the same order and divides by the same float32 √n, in one block a
    row up to 128 KB, in a cluster of blocks up to 1 MB, and in two passes
    above."""
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(max(2, min(256, (1 << 21) // n)), n, generator=g, device=cuda, dtype=dtype)
    for ordering in ("natural", "sequency"):
        for inverse in (False, True):
            before = fwht_kernel.launches
            out = fwht_kernel(x, ordering, inverse=inverse)
            torch.cuda.synchronize()
            assert fwht_kernel.launches == before + 1
            ref = (ifwht_plain if inverse else fwht_plain)(x, ordering)
            assert torch.equal(out, ref), (ordering, inverse, float((out - ref).abs().max()))
    # a row that starts off a 16-byte boundary is copied, not read misaligned
    shifted = x.reshape(-1)[1:1 + (x.shape[0] - 1) * n].reshape(-1, n)
    assert shifted.data_ptr() % 16 and torch.equal(fwht_kernel(shifted), fwht_plain(shifted))


def test_fwht_kernel_rejects_a_plan_that_does_not_fit_n(cuda):
    """The library checks the plan against n: a cluster plan with the wrong
    shared memory, a row plan for a row over 128 KB, and a cluster plan for
    a row one block holds all raise instead of launching."""
    x = torch.randn(32, 65536, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    small = torch.randn(32, 4096, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    plan = wht.plan_fwht(65536, 4)
    for x_bad, plan_bad in ((x, plan._replace(smem_bytes=plan.smem_bytes // 2)),
                            (x, wht.FwhtPlan("row", 1, 512, 65536 * 4)),
                            (small, wht.FwhtPlan("cluster", wht.CLUSTER, 32, 4096 * 4 // wht.CLUSTER))):
        with pytest.raises(RuntimeError, match="launch failed"):
            wht._launch(wht._library(), x_bad, "sequency", False, plan_bad)


def test_fwht_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="power of two"):
        fwht_kernel(torch.zeros(2, 48, device=cuda))
    with pytest.raises(ValueError, match="float32 or complex64"):
        fwht_kernel(torch.zeros(2, 64, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="supports n"):
        fwht_kernel(torch.zeros(1, 1 << 25, device=cuda))
    with pytest.raises(ValueError, match="ordering"):
        fwht_kernel(torch.zeros(2, 64, device=cuda), "dyadic")


def test_gamp_est_runs_the_fwht_kernel(cuda):
    """A small partial-Hadamard problem (B=4, n=4096) through gamp_est with
    the kernel on and off: two launches per iteration run, and the same
    estimate (the kernel is bit-equal to its plain version)."""
    prob = hcs.hadamard_cs_problem(seed=1, batch=4, n=4096)
    before = fwht_kernel.launches
    fin_on, _, _ = gamp_est(*hcs.hadamard_cs_torch(prob, cuda), GampOptions(nit=50))
    torch.cuda.synchronize()
    assert fwht_kernel.launches - before == 2 * int(fin_on.nit.max())
    fin_off, _, _ = gamp_est(*hcs.hadamard_cs_torch(prob, cuda, use_kernel=False), GampOptions(nit=50))
    torch.testing.assert_close(fin_on.xhat, fin_off.xhat, rtol=1e-5, atol=1e-6)
    assert np.all(hcs.nmse_db(fin_on.xhat.cpu().numpy(), prob["x"]) < -40)


def test_demean_rc_around_the_fwht_kernel_matches_the_plain_transform(cuda):
    """DemeanRCOp around SubsetOp(FWHTOp(4096)) with one row set per
    realization (B=4): its fields and four maps through the kernel equal
    those through the plain transform (bit-equal transforms; 1e-6 of the
    largest value for sums of other order), with 6 launches for the four
    maps and 2 for demean_rc; mean-removal gamp_est launches 6 an iteration
    + 2 and gives the plain route's estimate."""
    from jstsp19_torch.ops.fourier import FWHTOp
    from jstsp19_torch.ops.structured import SubsetOp, demean_rc

    prob = hcs.hadamard_cs_problem(seed=2, batch=4, n=4096)
    idx = torch.from_numpy(prob["idx"]).to(cuda)
    before = fwht_kernel.launches
    on = demean_rc(SubsetOp(FWHTOp(4096), idx), (4,), cuda)
    off = demean_rc(SubsetOp(FWHTOp(4096, use_kernel=False), idx), (4,), cuda)
    assert fwht_kernel.launches - before == 2
    g = torch.Generator(device=cuda).manual_seed(3)
    xd = torch.randn(4, 4098, generator=g, device=cuda)
    sd = torch.randn(4, 1026, generator=g, device=cuda)
    for f in ("gam", "col", "b12", "b21", "b13", "b31"):
        torch.testing.assert_close(getattr(on, f), getattr(off, f), rtol=1e-6, atol=1e-7)
    before = fwht_kernel.launches
    outs = [(op.mv(xd), op.rmv(sd), op.sq_mv(xd.abs()), op.sq_rmv(sd.abs())) for op in (on, off)]
    torch.cuda.synchronize()
    assert fwht_kernel.launches - before == 6
    for a, b in zip(*outs):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    before = fwht_kernel.launches
    fin_on, _, _ = gamp_est(*hcs.hadamard_cs_torch(prob, cuda), GampOptions(nit=30, remove_mean=True))
    torch.cuda.synchronize()
    assert fwht_kernel.launches - before == 6 * int(fin_on.nit.max()) + 2
    fin_off, _, _ = gamp_est(*hcs.hadamard_cs_torch(prob, cuda, use_kernel=False),
                             GampOptions(nit=30, remove_mean=True))
    torch.testing.assert_close(fin_on.xhat, fin_off.xhat, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["ProbitLikelihood", "NNGMPrior", "TDistLikelihood", "MultiLogitLikelihood",
                                  "MagnitudeLikelihood", "FxnhandlePrior", "ConcatLikelihood", "SoftThreshDMMPrior"])
def test_estimators_on_the_card_match_the_cpu(cuda, name):
    """A handful of the estimators (tails, quadrature, particles, Bessel
    ratios, probes, blocks, per-realization reductions) on the card against
    the CPU on the same inputs (harness/estim_check.py, B=4, n=4096): 1e-5
    of the largest value for closed forms, 1e-4 for the others."""
    from jstsp19_torch.harness.estim_check import compare_devices, estimator_cases

    case = next(c for c in estimator_cases(4, 4096, seed=5) if c.name == name)
    c = compare_devices(case, cuda)
    assert c.ok, c


def test_specialized_recipes_on_the_card(cuda):
    """The approximate front end (n_mc=16) and capacity (n_mc=1000, three
    geometries) on the card: the approximate-mode ADMM launches both per-op
    kernels (K (16, 32, 70) with a shared A and a B per realization), every
    value is finite, and each capacity point lies within 4 combined SE of
    the JAX reference (``results/torch_specialized_jax.json``); at the 0 dB
    point (Imax=50, approximate) the kernels on and off agree per
    realization within rtol 2e-3, atol 2e-4."""
    import json
    import math
    import pathlib

    from jstsp19_torch.harness import experiments

    dict_correlation.launches = fused_soft_threshold.launches = 0
    res = experiments.error_vs_snr_approx(n_mc=16, device=cuda)
    torch.cuda.synchronize()
    assert dict_correlation.launches >= 7 * 90 and fused_soft_threshold.launches >= 2 * 7 * 90
    assert all(math.isfinite(v) and 0.0 <= v <= 1.0 for c in res.curves.values() for v in c)
    errs = [experiments._approx_realization(prng.realization_generators(0, 3, cuda), 1.0, 64, T=70, sub_ratio=0.75,
                                            Imax=50, mode="approximate", use_kernels=flag) for flag in (True, False)]
    torch.testing.assert_close(errs[0], errs[1], rtol=2e-3, atol=2e-4)
    n = 1000
    cap = experiments.capacity(n_mc=n, device=cuda)
    ref = json.loads((pathlib.Path(__file__).resolve().parents[1] / "results" / "torch_specialized_jax.json")
                     .read_text())["recipes"]["capacity"]["curves"]
    for m, curve in cap.curves.items():
        for i, v in enumerate(curve):
            r = ref[m]
            se = r["sd"][i] * math.sqrt(1.0 / r["n"][i] + 1.0 / n)
            assert math.isfinite(v) and abs(v - r["mean"][i]) <= 4 * se, (m, i, v, r["mean"][i], se)


def test_jacobi_route_on_the_card_launches_the_kernels_and_matches_eigh(cuda):
    """proposed_admm(svt_method='jacobi') at the canonical point, B=16,
    Imax=50, 10 dB on the card: both per-op kernels launch every iteration,
    and each realization's NMSE lies within 0.02 of the 'eigh' solve's
    (tests/test_admm.py::test_admm_jacobi_svt_matches_eigh's limit)."""
    pc = PointConfig(methods=("proposed",))
    prob = proposed_problem(prng.realization_generators(0, 0, cuda), pc, 0.1, 16)
    args = [prob[k] for k in ("subY", "Omega", "A", "B")]
    hp = [prob[k] for k in ("tau_Y", "tau_S", "rho")]
    dict_correlation.launches = fused_soft_threshold.launches = 0
    S_j = proposed_admm(*args, 50, *hp, svt_method="jacobi").S
    torch.cuda.synchronize()
    assert dict_correlation.launches >= 50 and fused_soft_threshold.launches >= 50
    S_e = proposed_admm(*args, 50, *hp, svt_method="eigh").S
    e_j, e_e = clamped_nmse(S_j, prob["Zbar"]), clamped_nmse(S_e, prob["Zbar"])
    assert bool(torch.isfinite(e_j).all()) and float((e_j - e_e).abs().max()) < 0.02


def test_new_families_on_the_card_match_the_cpu_on_the_same_inputs(cuda):
    """TD-OMP, the two completions and CoSaMP take the same inputs on the
    card and on the CPU: on planted sparse problems the same supports and x
    within 1e-4·max|x|, mc_svt / mc_admm ('tracked') within 1e-4·max|X|;
    realization_errors runs omp_td, svt and tssr on the card with finite
    values in [0, 1]."""
    from jstsp19_torch.solvers.lowrank import mc_admm, mc_svt
    from jstsp19_torch.solvers.omp import cosamp, omp_td

    gens = prng.realization_generators(0, 0, cuda)
    out = realization_errors(gens, PointConfig(methods=("omp_td", "svt", "tssr"), svt_method="tracked"), 1.0, 16)
    for e in out.values():
        assert e.shape == (16,) and bool(torch.isfinite(e).all()) and 0 <= float(e.min()) <= float(e.max()) <= 1
    g = torch.Generator().manual_seed(3)
    A = torch.randn(8, 12, 8, generator=g, dtype=torch.complex64)
    B = torch.randn(8, 6, 10, generator=g, dtype=torch.complex64)
    S = torch.zeros(8, 8, 6, dtype=torch.complex64)
    S[:, 1, 2], S[:, 5, 0], S[:, 3, 4] = 2.0, -1.5j, 1 + 1j
    r_cpu = omp_td(A, B, A @ S @ B, 3)
    r_gpu = omp_td(A.to(cuda), B.to(cuda), (A @ S @ B).to(cuda), 3)
    assert torch.equal(r_cpu.support, r_gpu.support.cpu())
    assert float((r_cpu.x - r_gpu.x.cpu()).abs().max()) <= 1e-4 * float(r_cpu.x.abs().max())
    prob = proposed_problem(prng.realization_generators(1, 0, "cpu"), PointConfig(), 1.0, 8)
    OH, Om, tau = prob["subY"], prob["Omega"], prob["tau_Y"]
    for fn in (lambda d: mc_svt(OH.to(d), Om.to(d), 30, tau.to(d), 0.1, svt_method="tracked"),
               lambda d: mc_admm(OH.to(d), OH.to(d), Om.to(d), 30, tau.to(d), prob["rho"].to(d),
                                 svt_method="tracked")[0]):
        X_cpu, X_gpu = fn("cpu"), fn(cuda).cpu()
        assert float((X_cpu - X_gpu).abs().max()) <= 1e-4 * float(X_cpu.abs().max())
    Ac = torch.randn(4, 64, 128, generator=g, dtype=torch.complex64)
    Ac = Ac / Ac.abs().pow(2).sum(dim=-2, keepdim=True).sqrt()
    xs = torch.zeros(4, 128, dtype=torch.complex64)
    xs[:, (3, 17, 40, 77, 101)] = 3.0 * torch.randn(4, 5, generator=g, dtype=torch.complex64)
    v = (Ac @ xs[..., None])[..., 0]
    x_cpu, x_gpu = cosamp(Ac, v, 5), cosamp(Ac.to(cuda), v.to(cuda), 5).cpu()
    assert float((x_cpu - x_gpu).abs().max()) <= 1e-4 * float(x_cpu.abs().max())


def test_tracked_chain_precisions_on_the_card(cuda):
    """The chain's two products on the card: 'highest' is the complex64
    product, 3xTF32 is float32-accurate, one TF32 pass differs from float32
    by TF32's rounding, and TF32 is off again after each call."""
    from jstsp19_torch.ops import tracked

    U = torch.linalg.qr(_crandn(cuda, 64, 32, 32, seed=1))[0]
    W = _crandn(cuda, 64, 32, 140, seed=2)
    exact = U.mH.to(torch.complex128) @ W.to(torch.complex128)
    scale = float(exact.abs().max())
    errs = {}
    for mode in ("fp32", "3xtf32", "tf32"):
        got = tracked.chain_product(U.mH, W, mode)
        assert not torch.backends.cuda.matmul.allow_tf32
        errs[mode] = float((got.to(torch.complex128) - exact).abs().max()) / scale
    assert torch.equal(tracked.chain_product(U.mH, W, "fp32"), U.mH @ W)
    assert errs["fp32"] < 1e-5 and errs["3xtf32"] < 1e-5
    assert 1e-5 < errs["tf32"] < 1e-2
    assert tracked.PRODUCTS["default"] == "fp32"  # the eigh-oracle decision (PERF.md §6)
    assert tracked.PRODUCTS["high"] == "fp32"  # the truncating 3xTF32 split biased the mean (PERF.md §6)


def test_dryrun_one_rank_on_nccl(cuda):
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-m", "jstsp19_torch.parallel.dryrun", "1", "--timeout", "300"],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "backend nccl, device cuda:0" in proc.stdout and "dryrun ok: mesh(dp=1,sp=1,tp=1)" in proc.stdout


def test_sparse_admm_launches_both_kernels_and_matches_them_off(cuda):
    """``sparse_admm`` at the canonical point's shapes (32×4) for B=16, Imax
    20: Imax + 1 ``dict_correlation`` and Imax ``soft_threshold`` launches,
    and the kernels on and off give the same S within 1e-4·max|S| and the
    same NMSE within 1e-3 relative."""
    from jstsp19_torch.harness import amp_sparse as aps
    from jstsp19_torch.solvers.sparse import sparse_admm

    bp = aps.to_device(aps.beamspace_problem(batch=16), cuda)
    dict_correlation.launches = fused_soft_threshold.launches = 0
    S_on, e_on = sparse_admm(bp["H"], bp["OH"], bp["Dr"], bp["Dt"], 20)
    torch.cuda.synchronize()
    assert (dict_correlation.launches, fused_soft_threshold.launches) == (21, 20)
    S_off, e_off = sparse_admm(bp["H"], bp["OH"], bp["Dr"], bp["Dt"], 20, use_kernels=False)
    assert float((S_on - S_off).abs().max()) <= 1e-4 * float(S_off.abs().max())
    assert float(((e_on - e_off).abs() / e_off).max()) <= 1e-3


def test_amp_est_and_vamp_slm_launch_their_kernels(cuda):
    """``amp_est`` on partial-Hadamard problems (B=4, n=4096) launches the
    FWHT exactly twice an iteration and matches the kernel off within 1e-4
    of max|x|; ``vamp_slm`` on the canonical VAMP problem (B=8) launches
    ``dict_correlation`` once and matches the CPU within 1e-3 of max|x|
    (10 iterations)."""
    from jstsp19_torch.harness import amp_sparse as aps
    from jstsp19_torch.ops.kron import KronDictOp
    from jstsp19_torch.solvers.gamp import amp_est
    from jstsp19_torch.solvers.vamp_slm import vamp_slm

    prob = hcs.hadamard_cs_problem(batch=4, n=4096)
    outs = []
    for flag in (True, False):
        y, op, prior, _ = aps.hadamard_amp_torch(prob, cuda, use_kernel=flag)
        fwht_kernel.launches = 0
        outs.append(amp_est(y, op, prior, nit=20))
        torch.cuda.synchronize()
        assert fwht_kernel.launches == (40 if flag else 0)
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-4 * float(outs[1].abs().max())
    vp = aps.vamp_slm_problem(batch=8)
    res = {}
    for dev in (cuda, "cpu"):
        d = aps.to_device(vp, dev)
        dict_correlation.launches = 0
        res[str(dev)] = vamp_slm(aps.vamp_slm_prior(vp["beta"]), d["y"], KronDictOp(d["A"], d["B"]),
                                 d["gamw"][:, None, None], nit=10).x.cpu()
        assert dict_correlation.launches == (1 if dev == cuda else 0)
    assert float((res[str(cuda)] - res["cpu"]).abs().max()) <= 1e-3 * float(res["cpu"].abs().max())


def test_new_operators_and_state_evolutions_on_the_card_match_the_cpu(cuda):
    """``harness/op_check.py`` at small sizes: every new operator within
    1e-5·max|ref| of the CPU with its adjoint identity to 1e-4, the four
    state evolutions on the same draws within 1e-4, and the random
    constructors' structure."""
    from jstsp19_torch.harness import op_check

    for name, factory in op_check.operator_cases(n=4096, haar_levels=12, image=64, image_levels=3, m=1024,
                                                 blocks=(8, 32, 64), rbf=(256, 16)):
        c = op_check.compare_operator(name, factory, cuda)
        assert c.ok, c
    for c in op_check.compare_state_evolutions(cuda):
        assert c.ok, c
    for what, (value, ok) in op_check.random_op_structure(cuda, 256, 1024, 4, 64).items():
        assert ok, (what, value)


def test_kernels_read_lazily_conjugated_operands_as_their_values(cuda):
    """``x.mH`` of a column-major x (eigh's eigenvectors) is contiguous with
    PyTorch's conjugate bit set, its memory unconjugated: each wrapper
    resolves the bit, so the kernels agree with their plain versions on such
    operands (``sparse_admm`` passes ``Utᴴ`` to ``dict_correlation``)."""
    U = torch.linalg.eigh(_crandn(cuda, 4, 4, seed=3) @ _crandn(cuda, 4, 4, seed=3).mH)[1]
    B = U.mH
    assert B.is_conj() and B.is_contiguous()
    A, K = _crandn(cuda, 32, 32, seed=4), _crandn(cuda, 16, 32, 4, seed=5)
    ref = dict_correlation_plain(A, K, B)
    assert float((dict_correlation(A, K, B) - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    V = torch.linalg.eigh(_crandn(cuda, 8, 8, seed=7) @ _crandn(cuda, 8, 8, seed=7).mH)[1].mH
    assert V.is_conj() and V.is_contiguous()
    assert torch.equal(fused_soft_threshold(V, 0.1), fused_soft_threshold_plain(V, 0.1))
    W = torch.linalg.eigh(_crandn(cuda, 64, 64, seed=8) @ _crandn(cuda, 64, 64, seed=8).mH)[1].mH
    assert W.is_conj() and W.is_contiguous()
    assert torch.equal(fwht_kernel(W), fwht_plain(W))


def test_kron_dict_op_whole_on_the_card_matches_the_cpu(cuda):
    """``KronDictOp``'s ``sq_mv``, ``sq_rmv``, ``gram``, ``gram_out``,
    ``pinv_rmv`` and ``materialize`` at the canonical VAMP shapes (B=8, A
    32×32, B 16×16, one pair a realization): the card within 1e-5·max|ref|
    of the CPU (``pinv_rmv``: 1e-4, two SVDs)."""
    from jstsp19_torch.ops.kron import KronDictOp

    A, Bm, S, Y = (_crandn("cpu", 8, *shape, seed=s) for s, shape in enumerate(((32, 32), (16, 16), (32, 16),
                                                                                 (32, 16))))
    ops = {d: KronDictOp(A.to(d), Bm.to(d)) for d in ("cpu", cuda)}
    for method, arg, tol in (("sq_mv", S.abs(), 1e-5), ("sq_rmv", Y.abs(), 1e-5), ("gram", S, 1e-5),
                             ("gram_out", Y, 1e-5), ("pinv_rmv", Y, 1e-4)):
        ref = getattr(ops["cpu"], method)(arg)
        got = getattr(ops[cuda], method)(arg.to(cuda)).cpu()
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max()), method
    ref = ops["cpu"].materialize()
    assert float((ops[cuda].materialize().cpu() - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_em_and_turbo_solvers_launch_dict_correlation_once_a_round(cuda):
    """``em_bg_vamp`` (n_em 2: 3 inner solves) and ``turbo_markov_vamp``
    (n_turbo 2) on the canonical VAMP problem at B=8, 10 inner iterations:
    exactly one ``dict_correlation`` launch an inner solve on the card, none
    on the CPU, and x within 1e-3·max|x| of the CPU's."""
    from jstsp19_torch.harness import amp_sparse as aps
    from jstsp19_torch.ops.kron import KronDictOp
    from jstsp19_torch.solvers.em import em_bg_vamp
    from jstsp19_torch.solvers.turbo import turbo_markov_vamp

    vp = aps.vamp_slm_problem(batch=8)
    beta = float(vp["beta"])
    for solve, rounds in ((lambda d, op: em_bg_vamp(d["y"], op, n_em=2, nit=10), 3),
                          (lambda d, op: turbo_markov_vamp(d["y"], op, 1 / beta, d["gamw"][:, None, None],
                                                           n_turbo=2, nit=10), 2)):
        res = {}
        for dev in ("cpu", cuda):
            d = aps.to_device(vp, dev)
            dict_correlation.launches = 0
            res[str(dev)] = solve(d, KronDictOp(d["A"], d["B"])).x.cpu()
            assert dict_correlation.launches == (rounds if dev == cuda else 0)
        assert float((res[str(cuda)] - res["cpu"]).abs().max()) <= 1e-3 * float(res["cpu"].abs().max())


def test_bilinear_solvers_on_the_card_match_the_cpu_in_float64_and_launch_no_kernel(cuda):
    """``bigamp_pev`` (the adaptive step decided per realization),
    ``em_bigamp_mc`` (the rank per realization), ``hutamp`` and ``pbigamp`` in
    complex128/float64 on the card and on the CPU from the same draws (a CPU
    generator's): Z within 1e-9·max|Z|, the same ranks; none of the four
    kernels launched."""
    from jstsp19_torch.solvers.bigamp import em_bigamp_mc
    from jstsp19_torch.solvers.bigamp_full import BigAmpOptions, bigamp_pev
    from jstsp19_torch.solvers.estim import CAwgnPrior, SparsePrior
    from jstsp19_torch.solvers.hutamp import hutamp
    from jstsp19_torch.solvers.pbigamp import pbigamp

    rng = np.random.default_rng(0)
    B, L, M = 4, 20, 24
    Z = (rng.standard_normal((B, L, 2)) + 1j * rng.standard_normal((B, L, 2))) @ (
        rng.standard_normal((B, 2, M)) + 1j * rng.standard_normal((B, 2, M))) / 2
    mask = (rng.random((B, L, M)) < 0.7).astype(np.float64)
    Y = torch.from_numpy((Z + 0.02 * rng.standard_normal(Z.shape)) * mask)
    mask = torch.from_numpy(mask)
    H = torch.from_numpy(np.abs(rng.standard_normal((B, 30, 10))) + 0.5)
    A = torch.from_numpy((rng.standard_normal((B, 20, 4, 8)) + 1j * rng.standard_normal((B, 20, 4, 8))) / 8)
    y = torch.from_numpy(rng.standard_normal((B, 20)) + 1j * rng.standard_normal((B, 20)))
    g = CAwgnPrior(0j, 1.0)
    solves = (
        lambda d: bigamp_pev(Y.to(d), mask.to(d), 2, g, g, 1e-3, torch.Generator().manual_seed(0),
                             BigAmpOptions(nit=40)).Z,
        lambda d: (lambda r: (r.Z, r.rank))(em_bigamp_mc(Y.to(d), mask.to(d), 3, torch.Generator().manual_seed(1),
                                                         nit=30, n_em=2, step=0.5)),
        lambda d: hutamp(H.to(d), 3, torch.Generator().manual_seed(2), nit=30, n_em=2).Z,
        lambda d: pbigamp(y.to(d), A.to(d), CAwgnPrior(1.0 + 0j, 0.05), SparsePrior(CAwgnPrior(0j, 2.0), 0.4), 1e-3,
                          torch.Generator().manual_seed(3), nit=30).z,
    )
    kernels = (fused_tracked_admm, dict_correlation, fused_soft_threshold, fwht_kernel)
    before = [k.launches for k in kernels]
    for solve in solves:
        got, ref = solve(cuda), solve("cpu")
        if isinstance(ref, tuple):
            assert torch.equal(got[1].cpu(), ref[1])
            got, ref = got[0], ref[0]
        assert float((got.cpu() - ref).abs().max()) <= 1e-9 * float(ref.abs().max())
    assert [k.launches for k in kernels] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_kron_rmv_matmul_route_on_the_card_matches_the_cpu(cuda, dtype):
    """s_amp's real 128×256 operator and sparse_recovery's complex one take
    the matmul route on the card too (the kernel would raise: a real operand,
    or an A its shared memory cannot hold), launch no kernel, and equal the
    CPU; a VAMP-shape complex operator takes the kernel."""
    from jstsp19_torch.ops import KronDictOp

    g = torch.Generator().manual_seed(5)
    A, Y = torch.randn(128, 256, generator=g, dtype=dtype), torch.randn(4, 128, 1, generator=g, dtype=dtype)
    B = torch.eye(1, dtype=dtype)
    launches, before = dict_correlation.launches, (KronDictOp.kernel_rmvs, KronDictOp.matmul_rmvs)
    got = KronDictOp(A.to(cuda), B.to(cuda)).rmv(Y.to(cuda))
    assert dict_correlation.launches == launches
    assert (KronDictOp.kernel_rmvs, KronDictOp.matmul_rmvs) == (before[0], before[1] + 1)
    want = KronDictOp(A, B).rmv(Y)
    assert (got.cpu() - want).abs().max() <= 1e-5 * want.abs().max()
    op = KronDictOp(_crandn(cuda, 4, 8, 32), _crandn(cuda, 4, 16, 16, seed=1))
    op.rmv(_crandn(cuda, 4, 8, 16, seed=2))
    assert dict_correlation.launches == launches + 1


def _launches():
    return [k.launches for k in (fused_tracked_admm, dict_correlation, fused_soft_threshold, fwht_kernel)]


def _rel_per_realization(got, ref):
    """The largest over realizations of max|Δ| / max|ref| (the card's result
    brought to the CPU)."""
    d = (got.cpu() - ref).abs().flatten(1).amax(1)
    return float((d / ref.abs().flatten(1).amax(1)).max())


def test_fwht_routes_by_dtype_and_length_on_the_card(cuda):
    """float64, complex128, n = 1 and n = 2^25 (over the kernel's 2^24) take
    the plain route on the card, launch nothing and equal the CPU (float64
    to 1e-12 of max|x|); float32 at 2^16 still launches the kernel."""
    from jstsp19_torch.ops import fourier

    rng = np.random.default_rng(0)
    cases = [torch.from_numpy(rng.standard_normal((4, 4096))),
             torch.from_numpy(rng.standard_normal((4, 64)) + 1j * rng.standard_normal((4, 64))),
             torch.from_numpy(rng.standard_normal((4, 1)).astype(np.float32)),
             torch.from_numpy(rng.standard_normal((1, 1 << 25)).astype(np.float32)),
             torch.from_numpy(rng.standard_normal((1, 1 << 25)))]
    before, calls = _launches(), (fourier.fwht.kernel_calls, fourier.ifwht.kernel_calls)
    for x in cases:
        for ordering in ("sequency", "natural"):
            y = fourier.fwht(x.to(cuda), ordering)
            back = fourier.ifwht(y, ordering)
            assert y.dtype == x.dtype and back.dtype == x.dtype
            want = fourier.fwht(x, ordering)
            tol = 1e-12 if x.dtype in (torch.float64, torch.complex128) else 1e-6
            assert float((y.cpu() - want).abs().max()) <= tol * float(want.abs().max())
            assert float((back.cpu() - x).abs().max()) <= 10 * tol * float(x.abs().max())
    torch.cuda.synchronize()
    assert _launches() == before and (fourier.fwht.kernel_calls, fourier.ifwht.kernel_calls) == calls
    fourier.fwht(torch.randn(4, 1 << 16, device=cuda))
    assert fwht_kernel.launches == before[3] + 1 and fourier.fwht.kernel_calls == calls[0] + 1


def test_float64_gamp_est_and_amp_est_on_the_card_match_the_cpu_and_launch_nothing(cuda):
    """A float64 partial-Hadamard problem (B=4, n=4096) through gamp_est
    (mean removal off) and amp_est on ``SubsetOp(FWHTOp)``: no kernel
    launched, the card within 1e-8 of the CPU per realization."""
    from jstsp19_torch.harness import amp_sparse as aps
    from jstsp19_torch.solvers.gamp import amp_est

    prob = hcs.hadamard_cs_problem(seed=3, batch=4, n=4096)
    prob = dict(prob, y=prob["y"].astype(np.float64), wvar=prob["wvar"].astype(np.float64))
    before = _launches()
    got = {dev: gamp_est(*hcs.hadamard_cs_torch(prob, dev))[0].xhat for dev in (cuda, "cpu")}
    assert got["cpu"].dtype is torch.float64 and got[cuda].dtype is torch.float64
    assert _rel_per_realization(got[cuda], got["cpu"]) <= 1e-8
    got = {}
    for dev in (cuda, "cpu"):
        y, op, prior, _ = aps.hadamard_amp_torch(prob, dev)
        got[dev] = amp_est(y, op, prior, nit=aps.AMP_NIT)
    assert got["cpu"].dtype is torch.float64
    assert _rel_per_realization(got[cuda], got["cpu"]) <= 1e-8
    torch.cuda.synchronize()
    assert _launches() == before


def test_complex128_sparse_admm_and_proposed_admm_on_the_card_match_the_cpu_and_launch_nothing(cuda):
    """complex128 ``sparse_admm`` (32×4, B=8, Imax 50) and
    ``proposed_admm(use_kernels=True)`` at the errorVSnrf shape (B=4, Imax
    25): the routes take the plain versions (no kernel launched), and the
    card is within 1e-8 of the CPU per realization."""
    from jstsp19_torch.harness import amp_sparse as aps
    from jstsp19_torch.kernels import dictionary, softthresh
    from jstsp19_torch.solvers.sparse import sparse_admm

    wide = {torch.complex64: torch.complex128, torch.float32: torch.float64}
    bp = aps.beamspace_problem(batch=8)
    before = _launches()
    routed = (dictionary.dict_correlation_routed.kernel_calls, softthresh.fused_soft_threshold_routed.kernel_calls)
    got = {}
    for dev in (cuda, "cpu"):
        d = {k: v.to(wide[v.dtype]) for k, v in aps.to_device(bp, dev).items()}
        got[dev] = sparse_admm(d["H"], d["OH"], d["Dr"], d["Dt"], 50)[0]
    assert got[cuda].dtype is torch.complex128
    assert _rel_per_realization(got[cuda], got["cpu"]) <= 1e-8
    pc = PointConfig(Mr=16, T=5, methods=("proposed",))
    prob = proposed_problem(prng.realization_generators(4, 3, "cpu"), pc, 10 ** -0.5, 4)
    args = [prob[k].to(wide.get(prob[k].dtype, prob[k].dtype))
            for k in ("subY", "Omega", "A", "B", "tau_Y", "tau_S", "rho")]
    got = {dev: proposed_admm(*[a.to(dev) for a in args[:4]], IMAX, *[a.to(dev) for a in args[4:]]).S
           for dev in (cuda, "cpu")}
    assert got[cuda].dtype is torch.complex128
    assert _rel_per_realization(got[cuda], got["cpu"]) <= 1e-8
    torch.cuda.synchronize()
    assert _launches() == before
    assert (dictionary.dict_correlation_routed.kernel_calls,
            softthresh.fused_soft_threshold_routed.kernel_calls) == routed
