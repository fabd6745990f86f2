"""The port's kernels/dictionary.py and kernels/softthresh.py on the CPU: each
wrapper takes its plain version for CPU tensors, and that plain version
matches the JAX Pallas kernel run in interpret mode (tests/test_kernels.py)
and the JAX reference paths on the same numpy inputs."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.kernels import dict_correlation as jdict  # noqa: E402
from jstsp19_tpu.kernels import fused_soft_threshold as jsoft  # noqa: E402
from jstsp19_tpu.kernels.dictionary import dict_correlation_xla as jdict_xla  # noqa: E402
from jstsp19_torch.kernels import build  # noqa: E402
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
