"""The port's kernels/dictionary.py and kernels/softthresh.py on the CPU: each
wrapper takes its plain version for CPU tensors, and that plain version
matches the JAX Pallas kernel run in interpret mode (tests/test_kernels.py)
and the JAX reference paths on the same numpy inputs; the CUDA kernel's
plan (pure Python) fits every shape the port launches, and its order of
operations, run here in plain torch, matches the JAX reference."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.kernels import dict_correlation as jdict  # noqa: E402
from jstsp19_tpu.kernels import fused_soft_threshold as jsoft  # noqa: E402
from jstsp19_tpu.kernels.dictionary import dict_correlation_xla as jdict_xla  # noqa: E402
from jstsp19_torch.kernels import build, dictionary  # noqa: E402
from jstsp19_torch.kernels.dictionary import dict_correlation, dict_correlation_plain  # noqa: E402
from jstsp19_torch.kernels.softthresh import (  # noqa: E402
    fused_soft_threshold,
    fused_soft_threshold_plain,
)
from jstsp19_torch.solvers.sparse import soft_threshold  # noqa: E402


def _c(rng, *s):
    return ((rng.standard_normal(s) + 1j * rng.standard_normal(s)) / np.sqrt(2)).astype(np.complex64)


def T(x):
    return torch.from_numpy(np.array(x))


def test_dict_correlation_plain_matches_jax_pallas_interpret():
    """The shapes of tests/test_kernels.py:20-22, atol 2e-3 as there
    (measured gap 5.1e-5, 2.3e-7·max|ref|: one fp32 contraction order
    against another)."""
    rng = np.random.default_rng(0)
    A, K, B = _c(rng, 32, 32), _c(rng, 4, 32, 140), _c(rng, 16, 140)
    want = np.asarray(jdict(jnp.asarray(A), jnp.asarray(K), jnp.asarray(B), interpret=True))
    before = dict_correlation.launches
    got = dict_correlation(T(A), T(K), T(B))
    assert dict_correlation.launches == before  # CPU tensors never launch
    assert got.shape == (4, 32, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)
    torch.testing.assert_close(got, dict_correlation_plain(T(A), T(K), T(B)))


@pytest.mark.parametrize("shape", [(3, 32, 20, 32, 16), (2, 32, 16, 32, 16)])
def test_dict_correlation_per_realization_matches_xla(shape):
    """Per-realization A and B (the unfused ADMM's and VAMP's case), each
    matrix against dict_correlation_xla on its own: rtol 1e-5 with atol
    1e-5·max|ref| (measured gap 2.1e-7·max|ref|)."""
    b, N, M, Gr, Kd = shape
    rng = np.random.default_rng(1)
    A, K, B = _c(rng, b, N, Gr), _c(rng, b, N, M), _c(rng, b, Kd, M)
    got = dict_correlation(T(A), T(K), T(B)).numpy()
    for i in range(b):
        want = np.asarray(jdict_xla(jnp.asarray(A[i]), jnp.asarray(K[i][None]), jnp.asarray(B[i])))[0]
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_soft_threshold_plain_matches_jax_pallas_interpret():
    """Scalar τ, the shape of tests/test_kernels.py:27, atol 1e-6 (measured
    gap 0: the same float32 operations)."""
    v = _c(np.random.default_rng(2), 8, 33) * 3.0
    want = np.asarray(jsoft(jnp.asarray(v), 0.7, interpret=True))
    before = fused_soft_threshold.launches
    got = fused_soft_threshold(T(v), 0.7)
    assert fused_soft_threshold.launches == before
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_soft_threshold_per_matrix_tau():
    """One τ per matrix, shaped (..., 1, 1) as the solve's threshold is, is
    the JAX kernel run matrix by matrix (atol 1e-6, measured gap 0); any
    other τ shape is refused."""
    rng = np.random.default_rng(3)
    v = _c(rng, 4, 32, 16) * 2.0
    tau = np.array([0.0, 0.3, 1.0, 5.0], np.float32)
    want = np.stack([np.asarray(jsoft(jnp.asarray(v[i]), float(tau[i]), interpret=True)) for i in range(4)])
    t = T(tau)[:, None, None]
    np.testing.assert_allclose(fused_soft_threshold(T(v), t).numpy(), want, atol=1e-6)
    np.testing.assert_array_equal(fused_soft_threshold_plain(T(v), t).numpy(), soft_threshold(T(v), t).numpy())
    with pytest.raises(ValueError, match=r"\(\.\.\., 1, 1\)"):
        fused_soft_threshold(T(v), T(tau))


def test_wrappers_refuse_other_devices_and_sources_are_in_the_checkout():
    z = torch.zeros(2, 4, 4, dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        dict_correlation(z, z, z)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_soft_threshold(z, 0.1)
    for name, tpu in (("dict_correlation", "jstsp19_tpu/kernels/dictionary.py"),
                      ("soft_threshold", "jstsp19_tpu/kernels/softthresh.py")):
        text = (build.CSRC / f"{name}.cu").read_text()
        assert tpu in text and 'extern "C"' in text and "cudaGetLastError" in text
        assert build.library_path(name).name.startswith(f"lib{name}-")
    assert set(build.KERNELS) == {p.stem for p in build.CSRC.glob("*.cu")}


# (batch, N, M, Gr, Kd) of every shape the port launches dict_correlation at:
# the errorVSnrf ADMM (N=32, M = T*Mr = 20..80), VAMP's adjoint at
# Mr = 4..16, the canonical M=140 (shared and per realization alike for the
# plan) and errorVSnt Nt=16 (M=400, Kd=64)
PORT_SHAPES = (
    *((256, 32, m, 32, 16) for m in (20, 40, 60, 80)),
    *((256, mr, 16, 32, 16) for mr in (4, 8, 12, 16)),
    (256, 32, 140, 32, 16),
    (5, 32, 400, 32, 64),
)


@pytest.mark.parametrize("shape", PORT_SHAPES)
def test_dict_plan_fits_every_port_shape(shape):
    """At least one realization a block, a power of two; its threads and
    their 2x2 register tiles cover N, Gr and Kd in one pass (two row passes
    at Kd=64, where 32 threads take Kd); the grid of ceil(batch / rpb) blocks covers any
    batch; the shared memory stays within SMEM_LIMIT_BYTES and is the
    layout's count."""
    _, N, M, Gr, Kd = shape
    p = dictionary.plan(N, M, Gr, Kd)
    assert p.rpb >= 1 and p.rpb & (p.rpb - 1) == 0 and p.tk & (p.tk - 1) == 0
    tn = dictionary.THREADS // p.rpb // p.tk
    passes = (-(-max(N, Gr) // (2 * tn)), -(-Kd // (2 * p.tk)))  # (row passes, column passes)
    assert passes == ((2, 1) if Kd == 64 else (1, 1))
    assert p.mt % 4 == 0 and p.mt == min(dictionary.TILE_M, -(-M // 4) * 4)
    for batch in (1, p.rpb - 1, p.rpb + 1, 255, 256, 257):
        grid = -(-max(batch, 1) // p.rpb)
        assert (grid - 1) * p.rpb < max(batch, 1) <= grid * p.rpb
    assert p.smem_bytes == dictionary.smem_bytes(N, Gr, p.rpb, p.tk, p.mt) <= build.SMEM_LIMIT_BYTES
    if (N, Gr, Kd) == (32, 32, 16) or (N <= 16 and Kd == 16):
        assert p.rpb == 2  # 128 threads cover a realization: two share a block


def test_dict_plan_shrinks_to_fit_and_refuses_what_cannot():
    """A shape too large for two realizations a block gets one, then
    narrower tiles; A alone over the limit (256 x 128 complex64, 256 KB) is
    refused with the shared memory it would need."""
    p = dictionary.plan(200, 50, 100, 16)
    assert p.rpb == 1 and p.mt < 52 and p.smem_bytes <= build.SMEM_LIMIT_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        dictionary.plan(256, 50, 128, 16)


def _kernel_order(A, K, B):
    """Aᴴ·(K·Bᴴ) in the CUDA kernel's order, in float32 on the CPU: each
    entry of P = K·Bᴴ sums over m in increasing order (real part
    (re + Im K·Im B) + Re K·Re B, as the kernel's two fused multiply-adds),
    then each entry of the output over n in increasing order."""
    b, N, M = K.shape
    A, B = A.expand(b, *A.shape[-2:]), B.expand(b, *B.shape[-2:])
    Gr, Kd = A.shape[-1], B.shape[-2]
    kr, ki, br, bi = K.real, K.imag, B.real, B.imag
    pr = torch.zeros(b, N, Kd)
    pi = torch.zeros(b, N, Kd)
    for m in range(M):
        x_r, x_i = kr[:, :, m, None], ki[:, :, m, None]
        y_r, y_i = br[:, None, :, m], bi[:, None, :, m]
        pr = (pr + x_i * y_i) + x_r * y_r
        pi = (pi - x_r * y_i) + x_i * y_r
    ar, ai = A.real, A.imag
    o_r = torch.zeros(b, Gr, Kd)
    o_i = torch.zeros(b, Gr, Kd)
    for n in range(N):
        x_r, x_i = ar[:, n, :, None], ai[:, n, :, None]
        p_r, p_i = pr[:, n, None, :], pi[:, n, None, :]
        o_r = (o_r + x_i * p_i) + x_r * p_r
        o_i = (o_i - x_i * p_r) + x_r * p_i
    return torch.complex(o_r, o_i)


@pytest.mark.parametrize("shape,shared", [
    ((3, 32, 20, 32, 16), False),   # the errorVSnrf ADMM at Mr=4
    ((2, 32, 80, 32, 16), False),   # ... at Mr=16
    ((3, 4, 16, 32, 16), False),    # VAMP's adjoint at Mr=4
    ((2, 32, 140, 32, 16), True),   # canonical, the TPU signature
    ((2, 32, 400, 32, 64), False),  # errorVSnt Nt=16
    ((3, 7, 9, 5, 3), True),        # odd sizes
])
def test_dict_kernel_order_matches_xla(shape, shared):
    """The kernel's association and summation order, Aᴴ·(K·Bᴴ) over m then
    over n, against JAX's dict_correlation_xla (the (AᴴK)Bᴴ einsum) on the
    same numpy inputs, matrix by matrix: rtol 1e-5 with atol 1e-5·max|ref|
    (one fp32 order against another)."""
    b, N, M, Gr, Kd = shape
    rng = np.random.default_rng(7)
    A = _c(rng, *(() if shared else (b,)), N, Gr)
    K = _c(rng, b, N, M)
    B = _c(rng, *(() if shared else (b,)), Kd, M)
    got = _kernel_order(T(A), T(K), T(B)).numpy()
    for i in range(b):
        Ai, Bi = (A, B) if shared else (A[i], B[i])
        want = np.asarray(jdict_xla(jnp.asarray(Ai), jnp.asarray(K[i][None]), jnp.asarray(Bi)))[0]
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", ["flat tau", "(4, 2) tau", "tau not broadcasting", "meta device"])
def test_soft_threshold_refuses_what_it_refused_before(case):
    """A τ that is neither a number nor (..., 1, 1), a τ whose leading
    dimensions do not broadcast over v's, and a device other than the CPU
    or CUDA raise, before any launch."""
    v = T(_c(np.random.default_rng(4), 4, 32, 16))
    before = fused_soft_threshold.launches
    if case == "flat tau":
        with pytest.raises(ValueError, match=r"\(\.\.\., 1, 1\)"):
            fused_soft_threshold(v, torch.full((4,), 0.1))
    elif case == "(4, 2) tau":
        with pytest.raises(ValueError, match=r"\(\.\.\., 1, 1\)"):
            fused_soft_threshold(v, torch.full((4, 2), 0.1))
    elif case == "tau not broadcasting":
        with pytest.raises(RuntimeError):
            fused_soft_threshold(v, torch.full((3, 1, 1), 0.1))
    else:
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fused_soft_threshold(v.to("meta"), 0.1)
    assert fused_soft_threshold.launches == before
