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
from jstsp19_torch.kernels import admm_fused, build  # noqa: E402
from jstsp19_torch.kernels.admm_fused import fused_tracked_admm, fused_tracked_admm_plain  # noqa: E402

Bt, N, M, Gr, K = 2, 32, 140, 32, 16
IMAX = 25


def _problem(seed):
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


@pytest.mark.parametrize("with_rank", [False, True])
def test_plain_version_matches_jax_pallas_interpret(with_rank):
    """max|ΔS| < 2e-4·max|S| at Imax=25, the tolerance of
    tests/test_fused_admm.py:51-53 (same fp32 iteration; the Pallas kernel
    rotates the Gram T, the port the P-form, with other rounding)."""
    args = _problem(int(with_rank))
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


def test_wrapper_dispatch_and_checks():
    args = [torch.from_numpy(np.array(a)) for a in _problem(3)]
    S, _ = fused_tracked_admm(*args, Imax=3)
    S_p, _ = fused_tracked_admm_plain(*args, Imax=3)
    assert torch.equal(S, S_p)
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
