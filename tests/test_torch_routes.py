"""The kernel routes by dtype and shape: the pure predicates each route is
decided by (``kernels/wht.py``, ``kernels/dictionary.py``,
``kernels/softthresh.py::kernel_takes``) at every dtype and at the n and
``fits`` edges, and the routed call sites (``ops/fourier.py::fwht``/
``ifwht``/``FWHTOp``, ``solvers/sparse.py::sparse_admm``,
``solvers/admm.py::proposed_admm``, the soft threshold of
``parallel/sharded_admm.py``) on the CPU, where every operand takes the plain
route: float64 and complex128 run at their dtype, as the JAX package's XLA
forms do, and the route counters say which route ran.  The card's side is in
``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.ops import fourier as jfourier  # noqa: E402
from jstsp19_tpu.solvers import admm as jadmm  # noqa: E402
from jstsp19_tpu.solvers.sparse import sparse_admm as jsparse_admm  # noqa: E402
from jstsp19_torch.harness import amp_sparse as aps  # noqa: E402
from jstsp19_torch.harness import hadamard_cs as hcs  # noqa: E402
from jstsp19_torch.kernels import dictionary, softthresh, wht  # noqa: E402
from jstsp19_torch.kernels.build import SMEM_LIMIT_BYTES  # noqa: E402
from jstsp19_torch.ops import fourier  # noqa: E402
from jstsp19_torch.solvers import admm  # noqa: E402
from jstsp19_torch.solvers.gamp import amp_est  # noqa: E402
from jstsp19_torch.solvers.gamp_full import GampOptions, gamp_est  # noqa: E402
from jstsp19_torch.solvers.sparse import soft_threshold, sparse_admm  # noqa: E402

DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64, torch.complex64, torch.complex128,
          torch.int32)
WIDE = {torch.float32: torch.float64, torch.complex64: torch.complex128}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These batches are small: one intra-op thread each, so that the suite's
    parallel workers do not oversubscribe the cores (OpenMP threads spinning
    on small linear-algebra calls made these tests 100 times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wide(*tensors):
    return [t.to(WIDE.get(t.dtype, t.dtype)) for t in tensors]


# -- the predicates ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_fwht_kernel_takes_float32_and_complex64_at_powers_of_two_from_2_to_2_24(dtype):
    takes = dtype in (torch.float32, torch.complex64)
    for n in (2, 4, 64, 65536, 1 << 20, 1 << wht.MAX_LOG2N):
        assert wht.kernel_takes(dtype, n) is takes, n
    for n in (0, 1, 3, 6, 48, 65535, 65537, 1 << (wht.MAX_LOG2N + 1), 1 << 30):
        assert wht.kernel_takes(dtype, n) is False, n


def test_fwht_kernel_takes_exactly_what_plan_fwht_plans():
    """Where the predicate says yes, ``plan_fwht`` (the wrapper's own check)
    has a plan; at the powers of two it refuses, ``plan_fwht`` raises."""
    for log2n in range(0, wht.MAX_LOG2N + 3):
        n = 1 << log2n
        if wht.kernel_takes(torch.float32, n):
            assert wht.plan_fwht(n, 4).path in wht.PATHS and wht.plan_fwht(n, 8).path in wht.PATHS
        else:
            with pytest.raises(ValueError, match="supports n"):
                wht.plan_fwht(n, 4)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_soft_threshold_kernel_takes_complex64_only(dtype):
    assert softthresh.kernel_takes(dtype) is (dtype is torch.complex64)


def test_dict_kernel_takes_three_complex64_operands_that_fit():
    shapes = (32, 20, 32, 16)
    assert dictionary.kernel_takes((torch.complex64,) * 3, *shapes)
    for i in range(3):
        for other in DTYPES:
            if other is not torch.complex64:
                dtypes = [torch.complex64] * 3
                dtypes[i] = other
                assert not dictionary.kernel_takes(dtypes, *shapes), (i, other)


@pytest.mark.parametrize("N, Kd", [(32, 16), (128, 4), (256, 50), (8, 1)])
def test_dict_kernel_takes_up_to_the_largest_gr_that_fits(N, Kd):
    """At the edge of ``fits``: the largest Gr whose smallest layout fits
    the shared memory is taken, one more is not; where the predicate says
    yes ``plan`` has a layout within the limit, and where it says no
    ``plan`` raises."""
    gr = 1
    while dictionary.fits(N, 20, gr + 1, Kd):
        gr += 1
    c64 = (torch.complex64,) * 3
    assert dictionary.kernel_takes(c64, N, 20, gr, Kd) and not dictionary.kernel_takes(c64, N, 20, gr + 1, Kd)
    assert dictionary.smem_bytes(N, gr + 1, 1, dictionary._tk(Kd), 4) > SMEM_LIMIT_BYTES
    assert dictionary.plan(N, 20, gr, Kd).smem_bytes <= SMEM_LIMIT_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        dictionary.plan(N, 20, gr + 1, Kd)


# -- the FWHT's route ---------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 64, 4096])
@pytest.mark.parametrize("ordering", ["sequency", "natural"])
def test_fwht_on_the_cpu_runs_float64_on_the_plain_route(n, ordering):
    """float64 rows (and n = 1, which the kernel does not take) go to the
    plain version, at their dtype, equal bit for bit to what the wrapper
    gave on the CPU before the routes (``fwht_kernel``'s CPU branch) and
    counted on the plain route; against JAX's fwht, which runs float32
    without x64, within 1e-5."""
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((3, n)))
    counts = fourier.fwht.kernel_calls, fourier.fwht.plain_calls, fourier.ifwht.kernel_calls, \
        fourier.ifwht.plain_calls
    y = fourier.fwht(x, ordering)
    back = fourier.ifwht(y, ordering)
    assert (fourier.fwht.kernel_calls, fourier.fwht.plain_calls, fourier.ifwht.kernel_calls,
            fourier.ifwht.plain_calls) == (counts[0], counts[1] + 1, counts[2], counts[3] + 1)
    assert y.dtype is torch.float64 and back.dtype is torch.float64
    assert torch.equal(y, wht.fwht_kernel(x, ordering)) and torch.equal(back, wht.fwht_kernel(y, ordering, True))
    assert float((back - x).abs().max()) <= 1e-12 * float(x.abs().max())
    want = np.asarray(jfourier.fwht(jnp.asarray(x.numpy()), ordering))
    np.testing.assert_allclose(y.numpy(), want, atol=1e-5)


def test_fwht_op_float64_on_the_cpu():
    """``FWHTOp`` on float64 and complex128 vectors: mv and rmv keep the
    dtype, rmv inverts mv to 1e-12, through the plain route."""
    rng = np.random.default_rng(3)
    for x in (torch.from_numpy(rng.standard_normal((2, 256))),
              torch.from_numpy(rng.standard_normal((2, 256)) + 1j * rng.standard_normal((2, 256)))):
        op = fourier.FWHTOp(256)
        before = fourier.fwht.plain_calls + fourier.ifwht.plain_calls
        y = op.mv(x)
        assert y.dtype == x.dtype and op.rmv(y).dtype == x.dtype
        assert float((op.rmv(y) - x).abs().max()) <= 1e-12 * float(x.abs().max())
        assert fourier.fwht.plain_calls + fourier.ifwht.plain_calls == before + 3
        assert torch.equal(y, fourier.FWHTOp(256, use_kernel=False).mv(x))


@pytest.fixture
def transform_dtypes(monkeypatch):
    """The dtypes of every transform the plain route runs."""
    seen = []
    for name in ("fwht_plain", "ifwht_plain"):
        fn = getattr(fourier, name)
        monkeypatch.setattr(fourier, name, lambda x, *a, _fn=fn, **k: seen.append(x.dtype) or _fn(x, *a, **k))
    return seen


@pytest.mark.parametrize("solver", ["gamp_est", "amp_est"])
def test_float64_solves_on_the_hadamard_operator_run_every_transform_at_float64(solver, transform_dtypes):
    """The solves the FWHT kernel does not take on the card: a float64
    observation through ``SubsetOp(FWHTOp)`` keeps a float64 state from the
    first iteration on, so every transform is float64 and takes the plain
    route (none is left for the float32 kernel), and the estimate agrees
    with the float32 solve within float32's roundoff."""
    prob = hcs.hadamard_cs_problem(seed=2, batch=2, n=1024)
    wide = dict(prob, y=prob["y"].astype(np.float64), wvar=prob["wvar"].astype(np.float64))

    def solve(p):
        if solver == "gamp_est":
            return gamp_est(*hcs.hadamard_cs_torch(p, "cpu"), GampOptions(nit=30))[0].xhat
        y, op, prior, _ = aps.hadamard_amp_torch(p, "cpu")
        return amp_est(y, op, prior, nit=30)

    x64 = solve(wide)
    assert x64.dtype is torch.float64 and transform_dtypes and set(transform_dtypes) == {torch.float64}
    x32 = solve(prob)
    assert x32.dtype is torch.float32
    assert float((x64 - x32.double()).abs().max()) <= 1e-3 * float(x64.abs().max())


# -- the per-op kernels' routes -------------------------------------------------------------


def test_routed_soft_threshold_on_the_cpu_is_the_plain_threshold_at_the_operand_dtype():
    """On the CPU the routed threshold is the plain one: complex64 bit-equal
    to the wrapper's CPU branch, and complex128 bit-equal to ``soft_threshold``
    with the same τ in float64 (a number or one τ per matrix), counted on the
    plain route."""
    rng = np.random.default_rng(4)
    v = torch.from_numpy(rng.standard_normal((3, 8, 4)) + 1j * rng.standard_normal((3, 8, 4)))
    tau = torch.from_numpy(rng.random((3, 1, 1)))
    before = softthresh.fused_soft_threshold_routed.kernel_calls, softthresh.fused_soft_threshold_routed.plain_calls
    for t in (0.3, tau):
        got = softthresh.fused_soft_threshold_routed(v, t)
        assert got.dtype is torch.complex128 and torch.equal(got, soft_threshold(v, t))
        v32 = v.to(torch.complex64)
        t32 = t if isinstance(t, float) else t.float()
        assert torch.equal(softthresh.fused_soft_threshold_routed(v32, t32),
                           softthresh.fused_soft_threshold(v32, t32))
    assert (softthresh.fused_soft_threshold_routed.kernel_calls,
            softthresh.fused_soft_threshold_routed.plain_calls) == (before[0], before[1] + 4)


def test_routed_dict_correlation_on_the_cpu_is_the_plain_product_at_the_operand_dtype():
    rng = np.random.default_rng(5)

    def c(*s):
        return torch.from_numpy(rng.standard_normal(s) + 1j * rng.standard_normal(s))

    A, K, B = c(3, 8, 16), c(3, 8, 5), c(3, 4, 5)
    before = dictionary.dict_correlation_routed.plain_calls
    got = dictionary.dict_correlation_routed(A, K, B)
    assert got.dtype is torch.complex128 and torch.equal(got, dictionary.dict_correlation_plain(A, K, B))
    want = A.conj().mT @ K @ B.conj().mT
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    assert dictionary.dict_correlation_routed.plain_calls == before + 1


@pytest.mark.parametrize("per_realization", [False, True])
def test_sparse_admm_complex128_on_the_cpu(per_realization):
    """complex128 ``sparse_admm`` with the kernels on: plain routes
    throughout (2·Imax + 1 routed calls), complex128 out, equal to the
    kernels-off solve within 1e-12 of max|S|, and within 1e-4 of JAX's
    float32 solve per realization (the tolerance of the complex64 test,
    tests/test_torch_ops_tail.py)."""
    bp = aps.beamspace_problem(batch=2)
    H, OH, Dr, Dt = _wide(*(torch.from_numpy(bp[k]) for k in ("H", "OH", "Dr", "Dt")))
    if per_realization:
        Dr, Dt = Dr.expand(2, 32, 32).clone(), Dt.expand(2, 4, 4).clone()
    d0, s0 = dictionary.dict_correlation_routed.plain_calls, softthresh.fused_soft_threshold_routed.plain_calls
    S, errs = sparse_admm(H, OH, Dr, Dt, 20)
    assert (dictionary.dict_correlation_routed.plain_calls - d0,
            softthresh.fused_soft_threshold_routed.plain_calls - s0) == (21, 20)
    assert S.dtype is torch.complex128 and errs.dtype is torch.float64
    S_off, errs_off = sparse_admm(H, OH, Dr, Dt, 20, use_kernels=False)
    assert float((S - S_off).abs().max()) <= 1e-12 * float(S_off.abs().max())
    torch.testing.assert_close(errs, errs_off, rtol=1e-10, atol=0.0)
    for b in range(2):
        jS, _ = jsparse_admm(jnp.asarray(bp["H"][b]), jnp.asarray(bp["OH"][b]), jnp.asarray(bp["Dr"]),
                             jnp.asarray(bp["Dt"]), 20)
        jS = np.asarray(jS)
        assert np.abs(S[b].numpy() - jS).max() <= 1e-4 * np.abs(jS).max()


def _admm_problem(seed=0, Bt=2, N=32, M=20, Gr=32, K=16):
    rng = np.random.default_rng(seed)

    def c(*s):
        return (rng.standard_normal(s) + 1j * rng.standard_normal(s)).astype(np.complex64)

    Omega = (rng.random((Bt, N, M)) < 0.5).astype(np.float32)
    subY = c(Bt, N, M) * Omega
    A, B, Z = c(Bt, N, Gr) / np.sqrt(N), c(Bt, K, M) / np.sqrt(K), c(Bt, Gr, K)
    hp = [jadmm.admm_hyperparams(jnp.asarray(subY[b]), jnp.asarray(Z[b])) for b in range(Bt)]
    tau_Y, tau_S, rho = (np.stack([np.asarray(h[i]) for h in hp]).astype(np.float32) for i in range(3))
    return subY, Omega, A.astype(np.complex64), B.astype(np.complex64), tau_Y, tau_S, rho


@pytest.mark.parametrize("svt_method", ["eigh", "tracked"])
def test_proposed_admm_complex128_on_the_cpu(svt_method):
    """complex128 ``proposed_admm(use_kernels=True)`` at the errorVSnrf
    shape (N 32 > M 20), 25 iterations: plain routes throughout (one routed
    correlation and threshold an iteration), complex128 out, equal to
    ``use_kernels=False`` within 1e-12 of max|S|; and within 2e-4·max|S| of
    JAX's float32 solve (the float32 tolerance of tests/test_torch_solvers.py)."""
    args = _admm_problem()
    wide = _wide(*(torch.from_numpy(a) for a in args))
    d0, s0 = dictionary.dict_correlation_routed.plain_calls, softthresh.fused_soft_threshold_routed.plain_calls
    S = admm.proposed_admm(*wide[:4], 25, *wide[4:], svt_method=svt_method).S
    assert (dictionary.dict_correlation_routed.plain_calls - d0,
            softthresh.fused_soft_threshold_routed.plain_calls - s0) == (25, 25)
    assert S.dtype is torch.complex128
    S_off = admm.proposed_admm(*wide[:4], 25, *wide[4:], svt_method=svt_method, use_kernels=False).S
    assert float((S - S_off).abs().max()) <= 1e-12 * float(S_off.abs().max())
    f = lambda sy, om, a, b, ty, ts, rh: jadmm.proposed_admm(  # noqa: E731
        sy, om, a, b, 25, ty, ts, rh, svt_method=svt_method).S
    ref = np.asarray(jax.vmap(f)(*args))
    assert np.abs(S.numpy() - ref).max() < 2e-4 * np.abs(ref).max()


def test_proposed_admm_complex64_routes_are_unchanged_on_the_cpu():
    """complex64 with the kernels on equals the kernels off bit for bit on
    the CPU (both routes run the plain versions there), as before the
    routes."""
    args = [torch.from_numpy(a) for a in _admm_problem(seed=1)]
    S = admm.proposed_admm(*args[:4], 10, *args[4:]).S
    assert S.dtype is torch.complex64
    assert torch.equal(S, admm.proposed_admm(*args[:4], 10, *args[4:], use_kernels=False).S)
