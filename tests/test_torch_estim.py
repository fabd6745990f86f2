"""The port's estimator library (``jstsp19_torch/solvers/estim.py``) against
the JAX package's on the same numpy inputs: all 45 classes with every hook
JAX defines (``estim``, ``estim_map``, ``val_neg_kl``, ``loglike``,
``logscale``, ``loglikey``, ``val_map``, ``init_moments``), real and complex
where a class takes both; the estimators that reduce over a problem, at
B = 3 with different parameters per realization against three JAX calls;
and the truncated-normal helpers at far tails and near-degenerate
intervals.

Each port estimator is built by ``interop.estimator_to_torch`` from the JAX
one.  The port takes a batch of B realizations, (B, n), in one call; JAX
takes each row in its own call.  Tolerances are max|Δ| over
max|reference|: 1e-5 for closed forms, 1e-4 for the truncated-normal tails,
the quadrature rules and the particle sums (float32 special functions and
sums whose rounding differs between the two libraries)."""
import contextlib
import dataclasses
import io
import math
import re
import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.solvers import estim as jestim  # noqa: E402
from jstsp19_torch import interop  # noqa: E402
from jstsp19_torch.solvers import estim  # noqa: E402

CLOSED, TAIL = 1e-5, 1e-4
B, N = 2, 48
HOOKS = ("estim", "estim_map", "val_neg_kl", "loglike", "logscale", "loglikey", "val_map", "init_moments")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These batches are small: one intra-op thread each, so that the suite's
    parallel workers do not oversubscribe the cores (OpenMP threads spinning
    on small linear-algebra calls made these tests 100 times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _classes(module):
    return {n for n, c in vars(module).items()
            if isinstance(c, type) and dataclasses.is_dataclass(c) and c.__module__ == module.__name__}


def _rel(got, want):
    """max|Δ| over max|want|; NaN and ±inf must sit where the reference has
    them."""
    got, want = np.asarray(got, np.complex128), np.asarray(want, np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    bad_g, bad_w = ~np.isfinite(got), ~np.isfinite(want)
    assert np.array_equal(bad_g, bad_w), "non-finite values differ"
    if bad_w.any():
        assert np.array_equal(got[bad_w], want[bad_w], equal_nan=True)
    g, w = got[~bad_w], want[~bad_w]
    if w.size == 0:
        return 0.0
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _row(est, b):
    """JAX estimator for realization ``b`` of a batched one: every array
    field with a leading batch axis and two or more dimensions (y (B, n), a
    per-realization parameter (B, 1)) keeps its row; nested estimators
    recurse."""
    kw = {}
    for f in dataclasses.fields(est):
        v = getattr(est, f.name)
        if dataclasses.is_dataclass(v):
            v = _row(v, b)
        elif isinstance(v, tuple) and v and dataclasses.is_dataclass(v[0]):
            v = tuple(_row(e, b) for e in v)
        elif hasattr(v, "ndim") and v.ndim >= 2 and v.shape[0] == B_ROWS[0]:
            v = v[b]
        kw[f.name] = v
    return type(est)(**kw)


B_ROWS = [B]  # the batch size _row slices by (set per test)


def _draw(rng, shape, cplx, scale=2.0):
    x = rng.standard_normal(shape) * scale
    if cplx:
        x = x + 1j * rng.standard_normal(shape) * scale
    return x.astype(np.complex64 if cplx else np.float32)


def _inputs(rng, shape, cplx):
    """(a, v, a2): the estimates (sd 2, so up to about 7 from 0 and up to
    30 standard deviations of the smallest variances), positive variances
    and a second estimate (logscale's phat).  Farther out float32 no longer
    resolves the variances of the tail forms in either package (see
    test_truncated_normal_helpers_in_the_tails)."""
    a = _draw(rng, shape, cplx)
    v = (rng.random(shape) + 0.05).astype(np.float32)
    return a, v, _draw(rng, shape, cplx, 1.0)


def _labels(rng, shape):
    return (rng.random(shape) < 0.5).astype(np.float32)


def _case(rng, name, cplx):
    """(batched JAX estimator, input shape, tolerance, torch callables) of one
    class, its parameters drawn from ``rng``; y-like data is (B, n)."""
    f32 = np.float32
    yr = _draw(rng, (B, N), cplx, 1.0)
    lab = _labels(rng, (B, N))
    cawgn = jestim.CAwgnPrior(jnp.asarray(0.3 + 0.1j, jnp.complex64), f32(2.0)) if cplx \
        else jestim.AwgnPrior(f32(0.3), f32(2.0))
    K = 3
    w = np.array([0.5, 0.3, 0.2], f32)
    mk = (_draw(rng, (K,), cplx, 1.0))
    vk = np.array([0.5, 1.0, 2.0], f32)
    shape = (B, N)
    tol = CLOSED
    fns = {}
    if name == "CAwgnPrior":
        j = jestim.CAwgnPrior(jnp.asarray(0.3 + 0.1j, jnp.complex64), f32(2.0))
    elif name == "AwgnPrior":
        j = jestim.AwgnPrior(f32(0.3), f32(2.0))
    elif name == "SparsePrior":
        j = jestim.SparsePrior(cawgn, f32(0.1))
    elif name == "SoftThreshPrior":
        j = jestim.SoftThreshPrior(1.5)
    elif name == "CGMPrior":
        j = jestim.CGMPrior(jnp.asarray(w), jnp.asarray(mk), jnp.asarray(vk))
    elif name == "CAwgnLikelihood":
        j = jestim.CAwgnLikelihood(jnp.asarray(yr), f32(0.1), f32(1.3))
    elif name == "ProbitLikelihood":
        j, tol = jestim.ProbitLikelihood(jnp.asarray(lab), f32(0.05)), TAIL
    elif name == "PoissonLikelihood":
        j = jestim.PoissonLikelihood(jnp.asarray(rng.poisson(3.0, (B, N)).astype(f32)), f32(1.5))
    elif name == "QuantizedLikelihood":
        lo = np.floor(rng.standard_normal((B, N)) * 2).astype(f32) / 2
        lo[0, :3] = -np.inf  # half-lines and a far cell
        hi = lo + 0.5
        hi[1, :3] = np.inf
        j, tol = jestim.QuantizedLikelihood(jnp.asarray(lo), jnp.asarray(hi)), TAIL
    elif name == "OutlierLikelihood":
        j = jestim.OutlierLikelihood(jnp.asarray(yr), f32(0.01), f32(4.0), f32(0.1))
    elif name == "AwbgnLikelihood":
        j = jestim.AwbgnLikelihood(jnp.asarray(yr), f32(0.5), f32(0.2))
    elif name == "TruthReporterPrior":
        j = jestim.TruthReporterPrior(cawgn, jnp.asarray(_draw(rng, (B, N), cplx, 1.0)))
    elif name == "LaplacePrior":
        j, tol = jestim.LaplacePrior(f32(1.2)), TAIL
    elif name == "UnifPrior":
        j, tol = jestim.UnifPrior(f32(-0.5), f32(1.5)), TAIL
    elif name == "NNGMPrior":
        j, tol = jestim.NNGMPrior(jnp.asarray(w), jnp.asarray(np.abs(mk.real)), jnp.asarray(vk), f32(0.3)), TAIL
    elif name == "SNIPEPrior":
        j = jestim.SNIPEPrior(f32(2.5))
    elif name == "EllpPrior":
        j = jestim.EllpPrior(f32(0.8), f32(0.5))
    elif name == "DiscretePrior":
        atoms = np.array([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j], np.complex64) / np.sqrt(2) if cplx \
            else np.array([-3.0, -1.0, 1.0, 3.0], f32)
        j = jestim.DiscretePrior(jnp.asarray(atoms), jnp.asarray(np.array([0.1, 0.4, 0.3, 0.2], f32)))
    elif name == "GroupSparsePrior":
        j, shape = jestim.GroupSparsePrior(cawgn, f32(0.2)), (B, 12, 4)
    elif name == "LogitLikelihood":
        j, tol = jestim.LogitLikelihood(jnp.asarray(lab), f32(2.0)), TAIL
    elif name == "RobustProbitLikelihood":
        j, tol = jestim.RobustProbitLikelihood(jestim.ProbitLikelihood(jnp.asarray(lab), f32(0.05)), f32(0.1)), TAIL
    elif name == "RobustLogitLikelihood":
        j, tol = jestim.RobustLogitLikelihood(jnp.asarray(lab), f32(0.1), f32(2.0)), TAIL
    elif name == "TDistLikelihood":
        j, tol = jestim.TDistLikelihood(jnp.asarray(lab), f32(0.3)), TAIL
    elif name == "MultiLogitLikelihood":
        y = rng.integers(0, 4, (B, 16)).astype(np.int32)
        j, tol, shape = jestim.MultiLogitLikelihood(jnp.asarray(y), D=4, scale=f32(1.5), n_particles=64,
                                                    seed=3), TAIL, (B, 16, 4)
    elif name == "LaplaceLikelihood":
        j, tol = jestim.LaplaceLikelihood(jnp.asarray(yr), f32(1.5)), TAIL
    elif name == "MagnitudeLikelihood":
        j, tol = jestim.MagnitudeLikelihood(jnp.asarray(np.abs(_draw(rng, (B, N), True, 1.0))), f32(0.1)), TAIL
    elif name == "DiracPrior":
        j = jestim.DiracPrior(jnp.asarray(0.5 - 0.2j, jnp.complex64) if cplx else f32(0.5))
    elif name == "NullPrior":
        j = jestim.NullPrior()
    elif name == "ElasticNetPrior":
        j = jestim.ElasticNetPrior(f32(0.7), f32(0.4))
    elif name == "NNSoftThreshPrior":
        j, tol = jestim.NNSoftThreshPrior(f32(1.3)), TAIL
    elif name == "MixPrior":
        j = jestim.MixPrior(cawgn, jestim.CAwgnPrior(jnp.asarray(0j if cplx else 0.0), f32(0.1)) if cplx
                            else jestim.AwgnPrior(f32(0.0), f32(0.1)), f32(0.3))
    elif name == "ConcatPrior":
        j = jestim.ConcatPrior((cawgn, jestim.NullPrior(),
                                jestim.SoftThreshPrior(1.0)), (20, 2, N - 22))
    elif name == "DiracLikelihood":
        j = jestim.DiracLikelihood(jnp.asarray(yr))
    elif name == "MaskedLikelihood":
        j = jestim.MaskedLikelihood(jestim.CAwgnLikelihood(jnp.asarray(yr), f32(0.1)),
                                    jnp.asarray(rng.random((B, N)) < 0.7))
    elif name == "GaussMixLikelihood":
        j = jestim.GaussMixLikelihood(jnp.asarray(yr), jnp.asarray(w), jnp.asarray(vk / 4))
    elif name == "CMultAwgnLikelihood":
        j = jestim.CMultAwgnLikelihood(jnp.asarray(yr), jnp.asarray(_draw(rng, (B, N), cplx, 1.0)), f32(0.2))
    elif name == "HingeLikelihood":
        j, tol = jestim.HingeLikelihood(jnp.asarray(lab), f32(1.5)), TAIL
    elif name == "ConcatLikelihood":
        j = jestim.ConcatLikelihood((jestim.CAwgnLikelihood(jnp.asarray(yr[:, :N - 2]), f32(0.1)),
                                     jestim.DiracLikelihood(jnp.zeros((B, 2), yr.dtype))), (N - 2, 2))
    elif name == "BGZeroMeanPrior":
        j = jestim.BGZeroMeanPrior(f32(2.0), f32(0.2))
    elif name == "EllpDMMPrior":
        j = jestim.EllpDMMPrior(f32(1.2), 0.7)
    elif name == "SoftThreshDMMPrior":
        j = jestim.SoftThreshDMMPrior(f32(1.2), True)
    elif name == "FxnhandlePrior":
        # a linear denoiser: its divergence does not depend on the probes
        j = jestim.FxnhandlePrior(jax.random.PRNGKey(4), denoise=lambda r, v: 0.6 * r, n_avg=2)
        fns = dict(denoise=lambda r, v: 0.6 * r)
    elif name == "MultiSNIPEPrior":
        j = jestim.MultiSNIPEPrior(jnp.asarray(np.array([-1.0, 0.0, 2.0], np.complex64 if cplx else f32)),
                                   jnp.asarray(np.array([1.0, 2.0, 0.5], f32)), xvar_big=10.0)
    elif name == "L1Likelihood":
        j = jestim.L1Likelihood(f32(0.8), auto_scale=True, nit_scale=3)
    elif name == "NLLikelihood":
        j, tol = jestim.NLLikelihood(jnp.asarray(np.tanh(yr)), f32(0.05), out_fn=jnp.tanh, n_z=40), TAIL
        fns = dict(out_fn=torch.tanh)
    else:
        raise KeyError(name)
    return j, shape, tol, fns


REAL_ONLY = {"ProbitLikelihood", "PoissonLikelihood", "QuantizedLikelihood", "AwbgnLikelihood", "LaplacePrior",
             "UnifPrior", "NNGMPrior", "LogitLikelihood", "RobustProbitLikelihood", "RobustLogitLikelihood",
             "TDistLikelihood", "MultiLogitLikelihood", "LaplaceLikelihood", "NNSoftThreshPrior", "HingeLikelihood",
             "BGZeroMeanPrior", "NLLikelihood", "AwgnPrior", "MagnitudeLikelihood"}
CASES = sorted(_classes(jestim))
PARAMS = [(n, False) for n in CASES] + [(n, True) for n in CASES if n not in REAL_ONLY]


def _numpy(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def _call(est, hook, a, v, a2, xj):
    if hook in ("estim", "estim_map", "loglike", "loglikey"):
        return getattr(est, hook)(a, v)
    if hook == "val_neg_kl":
        return est.val_neg_kl(a, v, *xj)
    if hook == "logscale":
        return est.logscale(a, v, a2)
    if hook == "val_map":
        return est.val_map(a)
    return est.init_moments()


@pytest.mark.parametrize("name,cplx", PARAMS, ids=[f"{n}-{'complex' if c else 'real'}" for n, c in PARAMS])
def test_estimator_matches_jax(name, cplx):
    """``estim`` and every hook JAX defines, per realization, at the case's
    tolerance (1e-5 closed form, 1e-4 tails, quadrature and particles)."""
    B_ROWS[0] = B
    rng = np.random.default_rng(zlib.crc32(name.encode()) + int(cplx))
    jb, shape, tol, fns = _case(rng, name, cplx)
    port = interop.estimator_to_torch(jb, **fns)
    a, v, a2 = _inputs(rng, shape, cplx)
    rows = [_row(jb, b) for b in range(B)]
    hooks = [h for h in HOOKS if hasattr(rows[0], h)]
    assert "estim" in hooks
    out = io.StringIO()
    for hook in hooks:
        want = []
        with contextlib.redirect_stdout(out):
            for b in range(B):
                xj = rows[b].estim(a[b], v[b])
                want.append(_call(rows[b], hook, a[b], v[b], a2[b], [np.asarray(t) for t in xj]))
            xj_all = [np.stack([np.asarray(rows[b].estim(a[b], v[b])[k]) for b in range(B)]) for k in range(2)]
            got = _call(port, hook, torch.from_numpy(a), torch.from_numpy(v), torch.from_numpy(a2),
                        [torch.from_numpy(t) for t in xj_all])
            jax.effects_barrier()
        if hook == "init_moments":  # parameters shared by the rows: one reference
            pairs = [np.broadcast_arrays(_numpy(g), np.asarray(w_)) for g, w_ in zip(got, want[0])]
        else:
            got = got if isinstance(got, tuple) else (got,)
            want = [w_ if isinstance(w_, tuple) else (w_,) for w_ in want]
            pairs = [np.broadcast_arrays(_numpy(g), np.stack([np.asarray(w_[k]) for w_ in want]))
                     for k, g in enumerate(got)]
        for k, (g, ref) in enumerate(pairs):
            err = _rel(g, ref)
            assert err <= tol, f"{name}.{hook}[{k}]: {err:.3e} > {tol}"


def test_the_port_has_jax_s_45_classes_with_their_fields():
    """The same 45 class names as ``jstsp19_tpu/solvers/estim.py``, each with
    JAX's field names in JAX's order, and each carried by interop."""
    names = _classes(jestim)
    assert len(names) == 45 and _classes(estim) == names
    for n in names:
        fields = tuple(f.name for f in dataclasses.fields(getattr(jestim, n)))
        assert tuple(f.name for f in dataclasses.fields(getattr(estim, n))) == fields, n
        assert interop.ESTIMATOR_FIELDS[n] == fields, n


def test_interop_round_trip_keeps_nested_static_and_callable_fields():
    """estimator_to_numpy then estimator_to_torch rebuilds a nested tree
    exactly: tuples of estimators, static sizes, a callable and a
    generator's state."""
    def denoise(r, rv):
        return torch.tanh(r)

    g = torch.Generator().manual_seed(5)
    port = estim.ConcatPrior((estim.MixPrior(estim.AwgnPrior(0.0, torch.tensor([[2.0]])), estim.AwgnPrior(1.0, 0.1), 0.3),
                              estim.FxnhandlePrior(g, denoise=denoise, n_avg=3)), (5, 3))
    back = interop.estimator_to_torch(interop.estimator_to_numpy(port))
    assert back.sizes == (5, 3) and back.priors[1].n_avg == 3 and back.priors[1].denoise is denoise
    assert torch.equal(back.priors[0].base_a.var0, port.priors[0].base_a.var0)
    r = torch.linspace(-2, 2, 8)[None].expand(2, 8)
    assert all(torch.equal(x, y) for x, y in zip(back.estim(r, torch.full((2, 8), 0.3)),
                                                   port.estim(r, torch.full((2, 8), 0.3))))


# -- the reducing estimators at B = 3, one set of parameters per realization -----------


def _per_realization(jb, port, a, v, hooks=("estim",), tol=CLOSED):
    B_ROWS[0] = a.shape[0]
    for hook in hooks:
        got = getattr(port, hook)(torch.from_numpy(a), torch.from_numpy(v))
        got = got if isinstance(got, tuple) else (got,)
        for b in range(a.shape[0]):
            want = getattr(_row(jb, b), hook)(a[b], v[b])
            want = want if isinstance(want, tuple) else (want,)
            for g, w_ in zip(got, want):
                assert _rel(_numpy(g[b]), np.broadcast_to(np.asarray(w_), g[b].shape)) <= tol, (hook, b)


def test_dmm_priors_reduce_per_realization():
    """EllpDMMPrior and SoftThreshDMMPrior (with and without debiasing) take
    mean(rvar) and mean(active) over each realization: alpha (3, 1) and rvar
    of different sizes per row, against three JAX calls at 1e-5."""
    rng = np.random.default_rng(21)
    a = _draw(rng, (3, 64), False)
    v = (rng.random((3, 64)) * np.array([[0.1], [1.0], [3.0]])).astype(np.float32) + 0.01
    alpha = np.array([[0.8], [1.2], [2.0]], np.float32)
    for jb in (jestim.EllpDMMPrior(jnp.asarray(alpha), 0.6), jestim.SoftThreshDMMPrior(jnp.asarray(alpha), False),
               jestim.SoftThreshDMMPrior(jnp.asarray(alpha), True)):
        _per_realization(jb, interop.estimator_to_torch(jb), a, v)
    ac = _draw(rng, (3, 64), True)
    jb = jestim.SoftThreshDMMPrior(jnp.asarray(alpha), True)
    _per_realization(jb, interop.estimator_to_torch(jb), ac, v)


def test_group_sparse_and_l1_auto_scale_per_realization():
    """GroupSparsePrior pools within each group of each realization (p1 and
    var0 per realization); L1Likelihood's auto scale takes mean|zhat| per
    realization: at 1e-5 against three JAX calls."""
    rng = np.random.default_rng(22)
    a = _draw(rng, (3, 10, 6), False)
    v = (rng.random((3, 10, 6)) + 0.1).astype(np.float32)
    jb = jestim.GroupSparsePrior(jestim.AwgnPrior(0.0, jnp.asarray(np.array([[[1.0]], [[4.0]], [[0.5]]], np.float32))),
                                 jnp.asarray(np.array([[[0.1]], [[0.3]], [[0.6]]], np.float32)))
    _per_realization(jb, interop.estimator_to_torch(jb), a, v)
    a2 = _draw(rng, (3, 64), True)
    v2 = np.full((3, 64), 0.5, np.float32)
    jb = jestim.L1Likelihood(jnp.asarray(np.array([[0.2], [1.0], [5.0]], np.float32)), auto_scale=True)
    _per_realization(jb, interop.estimator_to_torch(jb), a2, v2, hooks=("estim", "loglike"))


def test_multilogit_batches_its_samples_per_realization():
    """MultiLogitLikelihood at (B, M, D) = (3, 20, 5) with labels and scale
    per realization, the particle set numpy's default_rng(seed) normals,
    bit for bit JAX's: estim and loglike against three JAX calls at 1e-4
    (particle sums)."""
    rng = np.random.default_rng(23)
    y = rng.integers(0, 5, (3, 20)).astype(np.int32)
    jb = jestim.MultiLogitLikelihood(jnp.asarray(y), D=5, scale=jnp.asarray(np.array([[0.5], [1.0], [3.0]],
                                                                                     np.float32)),
                                     n_particles=256, seed=11)
    a = _draw(rng, (3, 20, 5), False, 1.0)
    v = (rng.random((3, 20, 5)) + 0.2).astype(np.float32)
    port = interop.estimator_to_torch(jb)
    assert port.n_particles == 256 and port.seed == 11 and port.D == 5
    assert np.array_equal(port._nodes(torch.zeros(1)).numpy(), np.asarray(jb._nodes()))  # the same particles
    B_ROWS[0] = 3
    got = port.estim(torch.from_numpy(a), torch.from_numpy(v))
    ll = port.loglike(torch.from_numpy(a), torch.from_numpy(v))
    for b in range(3):
        jr = jestim.MultiLogitLikelihood(jnp.asarray(y[b]), D=5, scale=jb.scale[b], n_particles=256, seed=11)
        for g, w_ in zip(got, jr.estim(a[b], v[b])):
            assert _rel(g[b].numpy(), w_) <= TAIL
        assert _rel(ll[b].numpy(), jr.loglike(a[b], v[b])) <= TAIL


def test_fxnhandle_prior_divergence_per_realization():
    """FxnhandlePrior: with a linear denoiser per realization (gains 0.2,
    0.5, 0.9) the divergence is the gain whatever the probes, so the port
    equals JAX at 1e-5; with a soft-threshold denoiser the probe estimate
    of each realization's divergence (the active fraction) agrees with
    JAX's within 0.01 at n = 4096, and the port's probes are a fixed
    function of the generator (two calls agree bit for bit)."""
    rng = np.random.default_rng(24)
    a = _draw(rng, (3, 4096), False)
    v = (rng.random((3, 4096)) * np.array([[0.2], [1.0], [2.0]]) + 0.05).astype(np.float32)
    gains = np.array([[0.2], [0.5], [0.9]], np.float32)
    port = estim.FxnhandlePrior(torch.Generator().manual_seed(1), denoise=lambda r, rv: torch.from_numpy(gains) * r,
                                n_avg=2)
    xh, xv = port.estim(torch.from_numpy(a), torch.from_numpy(v))
    thr = np.array([[0.5], [1.5], [3.0]], np.float32)
    soft_t = estim.FxnhandlePrior(torch.Generator().manual_seed(1), n_avg=4,
                                  denoise=lambda r, rv: torch.sign(r) * torch.clamp(r.abs() - torch.from_numpy(thr),
                                                                                    min=0))
    s1, s2 = soft_t.estim(torch.from_numpy(a), torch.from_numpy(v)), soft_t.estim(torch.from_numpy(a),
                                                                               torch.from_numpy(v))
    assert torch.equal(s1[1], s2[1])
    for b in range(3):
        jl = jestim.FxnhandlePrior(jax.random.PRNGKey(b), denoise=lambda r, rv, g=float(gains[b, 0]): g * r, n_avg=2)
        for g, w_ in zip((xh[b], xv[b]), jl.estim(a[b], v[b])):
            assert _rel(g.numpy(), w_) <= CLOSED
        t = float(thr[b, 0])
        js = jestim.FxnhandlePrior(jax.random.PRNGKey(b), n_avg=4,
                                   denoise=lambda r, rv, t=t: jnp.sign(r) * jnp.maximum(jnp.abs(r) - t, 0))
        div_j = float(np.asarray(js.estim(a[b], v[b])[1])[0] / v[b, 0])
        div_p = float(s1[1][b, 0] / v[b, 0])
        assert abs(div_p - div_j) <= 0.01, (b, div_p, div_j)


def _printed(text):
    return [[float(x) for x in re.findall(r"=(-?[0-9.]+)", line)] for line in text.strip().splitlines()]


def test_truth_reporter_prints_per_realization():
    """TruthReporterPrior prints one line per realization, its four numbers
    within a unit of the last printed digit of JAX's line for that row, and
    returns the wrapped prior's moments exactly."""
    rng = np.random.default_rng(25)
    truth = _draw(rng, (3, 64), True, 1.0)
    a = (truth + _draw(rng, (3, 64), True, 0.3)).astype(np.complex64)
    v = (rng.random((3, 64)) * np.array([[0.1], [0.3], [1.0]]) + 0.02).astype(np.float32)
    jb = jestim.TruthReporterPrior(jestim.CAwgnPrior(0j, jnp.float32(1.0)), jnp.asarray(truth))
    port = interop.estimator_to_torch(jb)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        xh, xv = port.estim(torch.from_numpy(a), torch.from_numpy(v))
    got = _printed(buf.getvalue())
    assert len(got) == 3
    B_ROWS[0] = 3
    for b in range(3):
        jbuf = io.StringIO()
        with contextlib.redirect_stdout(jbuf):
            jx = _row(jb, b).estim(a[b], v[b])
            jax.effects_barrier()
        want = _printed(jbuf.getvalue())[0]
        assert all(abs(g - w_) <= u for g, w_, u in zip(got[b], want, (0.011, 1.1e-4, 1.1e-4, 0.011))), (got[b], want)
        assert _rel(xh[b].numpy(), jx[0]) <= CLOSED and _rel(xv[b].numpy(), jx[1]) <= CLOSED


# -- the truncated-normal helpers ------------------------------------------------------------


def test_truncated_normal_helpers_in_the_tails():
    """_log1mexp, _log_ndiff and _tn_moments against JAX's in float32 at
    1e-4: log1mexp across its branch point; log Φ-differences and the
    moments on intervals up to 8 σ out on either side, tiny widths (1e-6),
    half-lines and the whole line.  Under the pvar ≫ width² cap the
    variance is the uniform width²/12 = 3 to float32's resolution of the
    capped form, 2e-3 of it (the capped t = 1 + a·φ(a)/Z − b·φ(b)/Z − … is
    a difference of terms 1200 times larger; JAX's is 1.2e-3 off, the
    port's 1.7e-3).  At 30-40 σ the
    log mass still agrees at 1e-5, the mean to its float32 resolution
    (|a|³·eps, 4e-3 at 40 σ) and every value is finite, but the variance, a difference of terms of order
    a², is below float32's resolution in both packages and is only held
    finite and positive."""
    d = np.array([-1e-8, -1e-4, -0.5, -0.6931, -0.7, -5.0, -80.0, 0.0], np.float32)
    assert _rel(estim._log1mexp(torch.from_numpy(d)).numpy(), jestim._log1mexp(d)) <= TAIL
    lo = np.array([-np.inf, 6.0, -8.0, 0.5, -1e-6, -np.inf, 2.0, 5.0], np.float32)
    hi = np.array([np.inf, 7.0, -7.0, 0.5 + 1e-6, 1e-6, -6.0, np.inf, np.inf], np.float32)
    phat = np.array([0.0, 0.0, 0.0, 0.5, 0.0, 0.0, -4.0, 1.0], np.float32)
    pvar = np.array([1.0, 1.0, 1.0, 1.0, 1e11, 1.0, 0.5, 1.0], np.float32)
    T = torch.from_numpy
    assert _rel(estim._log_ndiff(T(lo), T(hi)).numpy(), jestim._log_ndiff(lo, hi)) <= TAIL
    got = estim._tn_moments(T(phat), T(pvar), T(lo), T(hi))
    for g, w_ in zip(got, jestim._tn_moments(phat, pvar, lo, hi)):
        assert np.all(np.isfinite(g.numpy())) and _rel(g.numpy(), w_) <= TAIL
    cap = [np.float32(v) for v in (0.2, 1e11, -3.0, 3.0)]
    for m, v, _ in (estim._tn_moments(*(T(np.array([c])) for c in cap)), jestim._tn_moments(*cap)):
        assert abs(float(np.asarray(m).reshape(-1)[0])) <= 1e-3 and abs(float(np.asarray(v).reshape(-1)[0]) - 3.0) <= 6e-3
    flo = np.array([30.0, -40.0, -np.inf, 35.0], np.float32)
    fhi = np.array([31.0, -39.0, -38.0, np.inf], np.float32)
    z = np.zeros(4, np.float32)
    one = np.ones(4, np.float32)
    mean, var, logz = estim._tn_moments(T(z), T(one), T(flo), T(fhi))
    jmean, _, jlogz = jestim._tn_moments(z, one, flo, fhi)
    # the mean is phat + σ(φ(a) − φ(b))/Z, a difference of terms of order |a|
    # each resolved to exp(a²/2)'s float32 rounding: |a|³·eps
    edge = np.where(np.isfinite(flo), np.abs(flo), np.abs(fhi))
    assert _rel(logz.numpy(), jlogz) <= CLOSED
    assert np.all(np.abs(mean.numpy() - np.asarray(jmean)) <= edge**3 * np.finfo(np.float32).eps)
    assert np.all(np.isfinite(var.numpy())) and np.all(var.numpy() > 0)
    # numbers as parameters follow jnp's domain: NaN below 0, −inf at 0
    assert math.isnan(estim._log(-1.0)) and estim._log(0.0) == -math.inf and estim._log1p(-1.0) == -math.inf
    x = np.array([-30.0, -1.0, 0.0, 2.0, 30.0], np.float32)
    assert _rel(estim._t2_logcdf(T(x)).numpy(), jestim._t2_logcdf(x)) <= CLOSED


@pytest.mark.parametrize("remove_mean", [False, True], ids=["plain", "remove_mean"])
def test_gamp_est_with_a_likelihood_without_cost_hooks(remove_mean):
    """A likelihood with no loglike (MaskedLikelihood: 30% of the rows
    unobserved) leaves the adaptive step the valIn-only criterion, as in
    JAX; with mean removal it is a ConcatLikelihood block without a hook,
    which costs 0.  30 iterations (tol −1), B=2 against two JAX calls:
    max|Δx̂| ≤ 1e-4·max|x̂| and the same step."""
    from jstsp19_tpu.ops.base import MatrixOp as JMatrixOp
    from jstsp19_tpu.solvers import gamp_full as jfull

    from jstsp19_torch.ops.base import MatrixOp
    from jstsp19_torch.solvers.gamp_full import GampOptions, gamp_est

    rng = np.random.default_rng(31)
    A = (rng.standard_normal((2, 64, 128)) / 8 + 0.3).astype(np.float32)
    X = ((rng.random((2, 128)) < 0.1) * rng.standard_normal((2, 128))).astype(np.float32)
    Y = (np.einsum("bmn,bn->bm", A, X) + 0.03 * rng.standard_normal((2, 64))).astype(np.float32)
    mask = rng.random((2, 64)) < 0.7
    jprior = jestim.SparsePrior(jestim.AwgnPrior(0.0, 1.0), 0.1)
    jlike = jestim.MaskedLikelihood(jestim.CAwgnLikelihood(jnp.asarray(Y), np.float32(1e-3)), jnp.asarray(mask))
    kw = dict(nit=30, tol=-1.0, remove_mean=remove_mean)
    fin, _, _ = gamp_est(interop.estimator_to_torch(jprior), interop.estimator_to_torch(jlike),
                         MatrixOp(torch.from_numpy(A)), GampOptions(**kw))
    B_ROWS[0] = 2
    for b in range(2):
        jfin, _, _ = jfull.gamp_est(jprior, _row(jlike, b), JMatrixOp(jnp.asarray(A[b])), jfull.GampOptions(**kw))
        assert _rel(fin.xhat[b].numpy(), jfin.xhat) <= TAIL
        assert abs(float(fin.step[b]) - float(jfin.step)) <= 1e-5
