"""The port's kernels/admm_fused.py on the CPU: the wrapper takes the plain
version for CPU tensors, and that plain version matches the JAX Pallas
kernel run in interpret mode on the same inputs (tests/test_fused_admm.py)."""
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.kernels.admm_fused import fused_tracked_admm as jfused  # noqa: E402
from jstsp19_tpu.solvers.admm import admm_hyperparams as jhp  # noqa: E402
from jstsp19_torch.kernels import admm_fused, build, launch_counts  # noqa: E402
from jstsp19_torch.kernels.admm_fused import fused_tracked_admm, fused_tracked_admm_plain  # noqa: E402

Bt, N, M, Gr, K = 2, 32, 140, 32, 16
IMAX = 25


# (M, K) of the 12 distinct shapes the fused route reaches in the seven
# sweep recipes (N = Gr = 32)
SWEEP_MK = ((140, 16), (40, 32), (120, 32), (200, 32), (280, 32), (40, 16), (60, 24), (80, 32),
            (100, 40), (210, 24), (420, 48), (400, 64))
# the sweep shapes where two 256-thread blocks do not fit an SM's shared memory
WIDE_MK = ((100, 40), (420, 48), (400, 64))


def _problem(seed, M=M, K=K):
    rng = np.random.default_rng(seed)

    def c(*s):
        return (rng.standard_normal(s) + 1j * rng.standard_normal(s)).astype(np.complex64)

    Omega = (rng.random((Bt, N, M)) < 0.5).astype(np.float32)
    subY = c(Bt, N, M) * Omega
    A = (c(Bt, N, Gr) / np.sqrt(N)).astype(np.complex64)
    B = (c(Bt, K, M) / np.sqrt(K)).astype(np.complex64)
    hp = [jhp(jnp.asarray(subY[b]), jnp.asarray(c(Gr, K))) for b in range(Bt)]
    tau_Y, tau_S, rho = (np.stack([np.asarray(h[i]) for h in hp]).astype(np.float32) for i in range(3))
    return subY, Omega, A, B, tau_Y, tau_S, rho


def _check_against_pallas_interpret(with_rank, M=M, K=K):
    args = _problem(int(with_rank), M, K)
    rank = None
    if with_rank:
        rng = np.random.default_rng(7)
        rank = np.stack([rng.permutation(Gr * K).reshape(Gr, K) for _ in range(Bt)]).astype(np.int32)
    S_j, Y_j = jfused(*args, Imax=IMAX, support_rank=rank, interpret=True)
    S_j = np.asarray(S_j)
    before = fused_tracked_admm.launches
    S, Y = fused_tracked_admm(
        *(torch.from_numpy(np.array(a)) for a in args), Imax=IMAX,
        support_rank=None if rank is None else torch.from_numpy(rank))
    assert fused_tracked_admm.launches == before  # CPU tensors never launch
    assert np.max(np.abs(S.numpy() - S_j)) < 2e-4 * np.max(np.abs(S_j))
    assert Y.shape == (Bt, N, M) and bool(torch.isfinite(torch.view_as_real(Y)).all())
    np.testing.assert_allclose(Y.numpy(), np.asarray(Y_j), atol=2e-4 * np.abs(np.asarray(Y_j)).max())


@pytest.mark.parametrize("with_rank", [False, True])
def test_plain_version_matches_jax_pallas_interpret(with_rank):
    """max|ΔS| < 2e-4·max|S| at Imax=25, the tolerance of
    tests/test_fused_admm.py:51-53 (same fp32 iteration; the Pallas kernel
    rotates the Gram T, the port the P-form, with other rounding)."""
    _check_against_pallas_interpret(with_rank)


@pytest.mark.parametrize("with_rank", [False, True])
@pytest.mark.parametrize("mk", [(200, 32), (420, 48), (400, 64)])
def test_plain_version_matches_jax_pallas_interpret_at_wide_sweep_shapes(mk, with_rank):
    """The same check at three of the sweep shapes whose operands exceed one
    block's shared memory when kept whole (errorVSframelength T=25,
    errorVSnt Nt=12 and Nt=16): the card's kernel streams them in tiles,
    and its plain version is what it is held to."""
    _check_against_pallas_interpret(with_rank, *mk)


def test_plan_fits_every_sweep_shape():
    """The kernel's plan fits each fused-route sweep shape in one block's
    shared memory, puts two blocks on an SM at the canonical shape, gives a
    block 512 threads and 64-column tiles exactly where it runs alone on an
    SM (two 256-thread blocks do not fit), takes N above 32 (groups of 32
    rows) while its buffers fit, and raises with the byte count for
    operands too large for a block."""
    for m, k in SWEEP_MK:
        pl = admm_fused.plan(N, m, Gr, k)
        assert pl.smem_bytes <= build.SMEM_LIMIT_BYTES and pl.tw == admm_fused.tile_width(pl.threads)
        assert pl.blocks_per_sm * (pl.smem_bytes + admm_fused.BLOCK_RESERVED_BYTES) <= admm_fused.SM_SMEM_BYTES
        assert pl.smem_bytes == 4 * admm_fused._layout_floats(N, Gr, k, pl.threads) and pl.row_groups == 1
        wide = (m, k) in WIDE_MK
        assert pl.threads == (admm_fused.WIDE_THREADS if wide else admm_fused.THREADS)
        assert (pl.blocks_per_sm == 1) == wide and pl.tw == (64 if wide else 32)
        two = 2 * (4 * admm_fused._layout_floats(N, Gr, k) + admm_fused.BLOCK_RESERVED_BYTES)
        assert (two > admm_fused.SM_SMEM_BYTES) == wide
    assert admm_fused.plan(N, M, Gr, K).blocks_per_sm == 2
    assert admm_fused.plan(40, 90, 36, 12).row_groups == 2
    wide = admm_fused.plan(66, 200, 32, 16)
    assert wide.row_groups == 3 and wide.blocks_per_sm == 1 and wide.smem_bytes <= build.SMEM_LIMIT_BYTES
    assert wide.threads == admm_fused.THREADS  # one block an SM, but no 512-thread instance at N = 66
    with pytest.raises(ValueError, match="B of shared memory"):
        admm_fused.plan(64, 4096, 64, 128)
    with pytest.raises(ValueError, match="B of shared memory"):
        admm_fused.plan(70, 200, 32, 16)


@pytest.mark.parametrize("k,threads,nbytes", [
    (16, 256, 82_432), (48, 256, 146_944), (64, 256, 190_080),
    (40, 512, 155_392), (48, 512, 175_424), (64, 512, 218_560),
])
def test_layout_bytes_follow_the_thread_count(k, threads, nbytes):
    """The layout's bytes at N = Gr = 32 for a block of 256 threads (32-column
    tiles) and of 512 (64-column tiles: wider B, W and transposed W tiles, a
    W tile that also holds K transposed, and a reduction buffer for 16
    warps); the card's tests hold the library's own count to the same
    function."""
    assert 4 * admm_fused._layout_floats(N, Gr, k, threads) == nbytes
    if threads == admm_fused.WIDE_THREADS:
        assert admm_fused.plan(N, 8 * k, Gr, k).smem_bytes == nbytes


def test_wrapper_dispatch_and_checks():
    args = [torch.from_numpy(np.array(a)) for a in _problem(3)]
    S, _ = fused_tracked_admm(*args, Imax=3)
    S_p, _ = fused_tracked_admm_plain(*args, Imax=3)
    assert torch.equal(S, S_p)
    # CPU calls launch nothing: the launch counters, the wide one too, stay at 0
    assert fused_tracked_admm.launches == fused_tracked_admm.wide_launches == 0
    assert launch_counts()["fused_tracked_admm"] == launch_counts()["fused_tracked_admm_512"] == 0
    with pytest.raises(ValueError, match="even N"):
        fused_tracked_admm(args[0][:, :31], args[1][:, :31], args[2][:, :31], *args[3:], Imax=3)
    with pytest.raises(ValueError, match="even N"):
        fused_tracked_admm(args[0][:, :, :30], args[1][:, :, :30], args[2], args[3][:, :, :30], *args[4:])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_tracked_admm(*(a.to("meta") for a in args), Imax=3)


def test_kernel_source_and_build_are_keyed_by_content():
    """The CUDA source is in the checkout, names the TPU kernel it replaces,
    and the library path is a hash of source and flags (no nvcc here)."""
    src = build.CSRC / "admm_fused.cu"
    text = src.read_text()
    assert "jstsp19_tpu/kernels/admm_fused.py" in text and "_fused_admm_kernel" in text
    assert "extern \"C\"" in text and "cudaGetLastError" in text
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    p = build.library_path("admm_fused")
    assert p.parent == build.BUILD_DIR and p.name.startswith("libadmm_fused-")
    assert p == build.library_path("admm_fused")
    assert pathlib.Path(admm_fused.__file__).parent / "csrc" == build.CSRC
