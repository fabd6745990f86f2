"""The port's FWHT (the kernel's plain version, which is what the wrapper runs
on CPU tensors) against the JAX package on the same numpy inputs:
``ops/fourier.py::fwht``/``ifwht``, ``kernels/wht.py::pallas_fwht`` in
interpret mode, and the C++ reference ``utils/native.py::native_fwht``."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from jstsp19_tpu.kernels.wht import pallas_fwht  # noqa: E402
from jstsp19_tpu.ops import fourier as jfourier  # noqa: E402
from jstsp19_tpu.utils import native  # noqa: E402
from jstsp19_torch.kernels import wht  # noqa: E402
from jstsp19_torch.ops import fourier  # noqa: E402

NS = (2, 16, 1024)


def _x(n, dtype, seed=0):
    rng = np.random.default_rng(seed + n)
    x = rng.standard_normal((3, n))
    if dtype == np.complex64:
        x = x + 1j * rng.standard_normal((3, n))
    return x.astype(dtype)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("ordering", ["sequency", "natural"])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64], ids=["float32", "complex64"])
def test_plain_fwht_equals_jax_fwht(n, ordering, dtype):
    """Equal to the last bit (measured) to JAX's fwht as it runs eagerly:
    the same butterflies in the same order, the same sequency gather and
    the same float32 division by √n; a complex input keeps its imaginary
    part, as JAX's fwht does."""
    x = _x(n, dtype)
    np.testing.assert_array_equal(wht.fwht_plain(torch.from_numpy(x), ordering).numpy(),
                                  np.asarray(jfourier.fwht(x, ordering)))
    np.testing.assert_array_equal(wht.ifwht_plain(torch.from_numpy(x), ordering).numpy(),
                                  np.asarray(jfourier.ifwht(x, ordering)))
    np.testing.assert_array_equal(wht._sequency_perm(n), jfourier._sequency_perm(n))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("ordering", ["sequency", "natural"])
def test_plain_fwht_matches_pallas_fwht(n, ordering):
    """Against the TPU kernel in interpret mode: max|Δ| ≤ 1e-6·max|ref|.
    ``pallas_fwht`` multiplies by 1/√n where the port divides by √n, which
    can differ by an ulp (measured 7.3e-8·max|ref| at n=2, 0 elsewhere)."""
    x = _x(n, np.float32, seed=1)
    want = np.asarray(pallas_fwht(x, ordering, interpret=True))
    got = wht.fwht_plain(torch.from_numpy(x), ordering).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("ordering", ["sequency", "natural"])
def test_plain_fwht_matches_native_fwht(ordering):
    """Against the C++ reference (``native/``, float64) where it builds:
    max|Δ| ≤ 1e-12·max|ref| in float64 (the same transform, summed in
    another order).  Where g++ is missing, JAX's fwht in float32 stands in
    for it (equal, as above)."""
    x = _x(512, np.float32, seed=2).astype(np.float64)
    got = wht.fwht_plain(torch.from_numpy(x), ordering).numpy()
    if native.native_available():
        want = native.native_fwht(x, ordering)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    else:
        x32 = x.astype(np.float32)
        np.testing.assert_array_equal(wht.fwht_plain(torch.from_numpy(x32), ordering).numpy(),
                                      np.asarray(jfourier.fwht(x32, ordering)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_kernel_wrapper_takes_the_plain_version_on_cpu(dtype):
    """On a CPU tensor the wrapper runs the plain version and counts no
    launch; inverse ∘ forward is the identity to 1e-5·max|x| (float32
    rounding of two transforms of 2048 terms); ops/fourier.py's fwht/ifwht
    go through the wrapper."""
    x = torch.randn(4, 2048, dtype=dtype, generator=torch.Generator().manual_seed(0))
    before = wht.fwht_kernel.launches
    y = wht.fwht_kernel(x)
    assert torch.equal(y, wht.fwht_plain(x)) and torch.equal(fourier.fwht(x), y)
    back = fourier.ifwht(y)
    assert torch.equal(back, wht.fwht_kernel(y, inverse=True))
    assert float((back - x).abs().max()) <= 1e-5 * float(x.abs().max())
    assert wht.fwht_kernel.launches == before
    nat = wht.fwht_kernel(x, "natural")
    torch.testing.assert_close(wht.fwht_kernel(nat, "natural"), x, rtol=0, atol=1e-5)


@pytest.mark.parametrize("elem_bytes", [4, 8], ids=["float32", "complex64"])
def test_plan_fwht_at_every_length(elem_bytes):
    """For every n from 2 to 2^24: one block a row up to 128 KB (2^15
    float32, 2^14 complex64), a cluster of 8 blocks up to 1 MB (2^18,
    2^17), the two-pass split above; each block within the 232,448 B of
    shared memory a block may use and 32-512 threads in whole warps, a
    cluster's blocks holding equal contiguous parts of the row; the GAMP
    slice's (32, 65536) float32 rows on the one-pass cluster path."""
    for log2n in range(1, 25):
        n = 1 << log2n
        plan = wht.plan_fwht(n, elem_bytes)
        row = n * elem_bytes
        want = "row" if row <= 128 * 1024 else "cluster" if row <= 1024 * 1024 else "split"
        assert plan.path == want, (n, plan)
        assert plan.cluster in {1, 2, 4, 8} and plan.cluster == (wht.CLUSTER if want == "cluster" else 1)
        assert plan.smem_bytes <= 232_448 and 32 <= plan.threads <= 512 and plan.threads % 32 == 0
        if want != "split":
            assert plan.smem_bytes * plan.cluster == row
            # a thread holds 128 B of entries (the whole row when it is shorter) a
            # pass, on the cluster path two such units
            units = plan.smem_bytes // (128 if want == "row" else 256)
            assert plan.threads == min(512, max(32, units))
    assert wht.plan_fwht(65536, 4) == wht.FwhtPlan("cluster", 8, 128, 32768)
    with pytest.raises(ValueError, match="supports n"):
        wht.plan_fwht(1 << 25, elem_bytes)
    with pytest.raises(ValueError, match="power of two"):
        wht.plan_fwht(48, elem_bytes)


def test_fwht_rejects_bad_lengths_and_orderings():
    with pytest.raises(ValueError, match="power of two"):
        wht.fwht_plain(torch.zeros(2, 12))
    with pytest.raises(ValueError, match="ordering"):
        wht.fwht_kernel(torch.zeros(2, 8), "dyadic")
    with pytest.raises(ValueError, match="ordering"):
        wht.ifwht_plain(torch.zeros(2, 8), "dyadic")
