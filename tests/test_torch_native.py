"""The port's host library (``jstsp19_torch/utils/native.py``, its own copy
of the C++ sources in ``jstsp19_torch/utils/csrc/``) against the JAX
package's (``jstsp19_tpu/utils/native.py``) on the same numpy inputs, edge
cases included; against JAX's ``fwht`` and the port's ``fwht_plain``; and
its build: into the port's git-ignored build directory, named by a hash,
and without a compiler or sources, unavailable with both functions
raising ``RuntimeError``, as the JAX package's bindings do."""
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.ops import fourier as jfourier  # noqa: E402
from jstsp19_tpu.utils import native as jnative  # noqa: E402
import jstsp19_torch.utils  # noqa: E402
from jstsp19_torch.kernels import wht  # noqa: E402
from jstsp19_torch.utils import native  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _built():
    """Both libraries built (decided here, not while the module is imported,
    so that every worker collects the same tests)."""
    if not (native.native_available() and jnative.native_available()):
        pytest.skip("g++ build unavailable")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These batches are small: one intra-op thread each, so that the suite's
    parallel workers do not oversubscribe the cores (OpenMP threads spinning
    on small linear-algebra calls made these tests 100 times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """The library forgotten and built anew into ``tmp_path``; the process's
    library is restored afterwards."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native._lib.cache_clear()
    yield monkeypatch, tmp_path
    monkeypatch.undo()
    native._lib.cache_clear()


def _c(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def test_utils_exports_the_three_names():
    for name in ("native_available", "native_fwht", "native_sparse_conj_mult"):
        assert getattr(jstsp19_torch.utils, name) is getattr(native, name)


@pytest.mark.parametrize("shape", [(64,), (3, 64), (2, 3, 256), (5, 1024)])
@pytest.mark.parametrize("ordering", ["sequency", "natural"])
def test_native_fwht_equals_jax_native(shape, ordering):
    """Batched rows in both orders: the port's library and the JAX package's
    give the same float64 transform (atol 1e-12), in the input's shape."""
    x = np.random.default_rng(len(shape)).standard_normal(shape)
    got = native.native_fwht(x, ordering)
    want = jnative.native_fwht(x, ordering)
    assert got.shape == shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("ordering", ["sequency", "natural"])
def test_native_fwht_matches_jax_fwht_and_the_plain_version(ordering):
    """Against JAX's fwht in float32 (atol 1e-4, as tests/test_native.py
    holds JAX's library) and the port's ``fwht_plain`` in float64 (atol
    1e-12), forward and, through the natural order's self-inverse, back."""
    x = np.random.default_rng(7).standard_normal((3, 512))
    got = native.native_fwht(x, ordering)
    np.testing.assert_allclose(got, np.asarray(jfourier.fwht(jnp.asarray(x, jnp.float32), ordering)), atol=1e-4)
    np.testing.assert_allclose(got, wht.fwht_plain(torch.from_numpy(x), ordering).numpy(), rtol=0, atol=1e-12)
    back = native.native_fwht(native.native_fwht(x, "natural"), "natural")
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-12)


@pytest.mark.parametrize("x", [np.arange(6.0), np.arange(12.0).reshape(2, 6), np.array([3.0]),
                               np.array([[2.5], [-1.0]]), np.arange(4, dtype=np.float32),
                               np.arange(8, dtype=np.int64), np.zeros((0, 4))],
                         ids=["length 6", "rows of 6", "n 1", "rows of 1", "float32", "int64", "no rows"])
@pytest.mark.parametrize("ordering", ["sequency", "natural"])
def test_native_fwht_edge_cases_mirror_jax(x, ordering):
    """A length that is not a power of two comes back unchanged (neither
    binding pads, the reference MEX does: a fault of the reference, mirrored),
    n = 1 is its own transform, and the output is float64 whatever the
    input; the same arrays as JAX's library gives."""
    got, want = native.native_fwht(x, ordering), jnative.native_fwht(x, ordering)
    assert got.dtype == np.float64 == want.dtype and got.shape == want.shape == x.shape
    np.testing.assert_array_equal(got, want)
    if x.size and (x.shape[-1] & (x.shape[-1] - 1)):
        np.testing.assert_array_equal(got, x.astype(np.float64))
    if x.shape[-1] == 1:
        np.testing.assert_array_equal(got, x)


def test_native_fwht_unknown_ordering_raises_as_jax_does():
    for lib in (native, jnative):
        with pytest.raises(ValueError, match="unknown ordering"):
            lib.native_fwht(np.ones(4), "dyadic")
        assert lib.native_fwht(np.zeros((0, 4)), "dyadic").shape == (0, 4)  # no row, no check


@pytest.mark.parametrize("n, r, c", [(20, 8, 6), (1, 1, 1), (64, 16, 3)])
def test_native_sparse_conj_mult_equals_jax_native_and_the_dense_product(n, r, c):
    rng = np.random.default_rng(n)
    A, X = _c(rng, n, r), _c(rng, n, c)
    rows, cols = rng.integers(0, r, 40), rng.integers(0, c, 40)
    got = native.native_sparse_conj_mult(A, X, rows, cols)
    assert got.dtype == np.complex128 and got.shape == (40,)
    np.testing.assert_allclose(got, jnative.native_sparse_conj_mult(A, X, rows, cols), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, (A.conj().T @ X)[rows, cols], rtol=0, atol=1e-10)


def test_native_sparse_conj_mult_out_of_range_pairs_give_zero_as_jax_does():
    rng = np.random.default_rng(11)
    A, X = _c(rng, 10, 4), _c(rng, 10, 3)
    rows = np.array([0, -1, 4, 3, 2, 100, 1])
    cols = np.array([0, 0, 1, -5, 3, 2, 2])
    got = native.native_sparse_conj_mult(A, X, rows, cols)
    np.testing.assert_array_equal(got, jnative.native_sparse_conj_mult(A, X, rows, cols))
    assert np.all(got[1:6] == 0)
    Z = A.conj().T @ X
    np.testing.assert_allclose(got[[0, 6]], Z[[0, 1], [0, 2]], atol=1e-12)
    # float32 and real inputs are widened to complex128, as JAX's binding does
    A32, X32 = A.real.astype(np.float32), X.imag.astype(np.float32)
    np.testing.assert_array_equal(native.native_sparse_conj_mult(A32, X32, rows, cols),
                                  jnative.native_sparse_conj_mult(A32, X32, rows, cols))


def test_the_sources_are_the_jax_side_sources_but_for_comments():
    """The port keeps its own copy of ``native/*.cpp`` with the same C ABI
    and the same code; only its comments differ."""
    strip = lambda text: [ln.strip() for ln in re.sub(r"//.*", "", text).splitlines() if ln.strip()]  # noqa: E731
    root = native.CSRC.parents[2]
    for name in native.SOURCES:
        assert strip((native.CSRC / name).read_text()) == strip((root / "native" / name).read_text()), name


def test_the_build_lands_in_the_ports_build_directory_named_by_a_hash(fresh_build):
    _, tmp_path = fresh_build
    assert native.native_available()
    built = sorted((tmp_path / "build").iterdir())
    assert len(built) == 1 and re.fullmatch(r"libjstsp19_native-[0-9a-f]{16}\.so", built[0].name)
    stamp = built[0].stat().st_mtime_ns
    native._lib.cache_clear()  # a new process: the library of the same hash is loaded, not rebuilt
    assert native.native_available() and built[0].stat().st_mtime_ns == stamp
    assert sorted((tmp_path / "build").iterdir()) == built  # no temporary file left behind
    np.testing.assert_array_equal(native.native_fwht(np.arange(8.0)), jnative.native_fwht(np.arange(8.0)))


@pytest.mark.parametrize("what", ["no compiler", "no sources"])
def test_without_a_build_the_library_is_unavailable_and_both_functions_raise(fresh_build, what):
    monkeypatch, tmp_path = fresh_build
    if what == "no compiler":
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    else:
        monkeypatch.setattr(native, "CSRC", tmp_path / "no-such-csrc")
    assert native.native_available() is False
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.native_fwht(np.ones(4))
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.native_sparse_conj_mult(np.ones((2, 2)), np.ones((2, 2)), np.zeros(1), np.zeros(1))
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())
