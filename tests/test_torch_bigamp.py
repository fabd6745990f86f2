"""The port's BiG-AMP solvers (``solvers/bigamp.py``, ``solvers/bigamp_full.py``)
against the JAX package on the same numpy inputs.  The port solves a batch of
problems in one call; JAX solves each in its own call.

* The cores (``bigamp``, ``bigamp_pev`` with and without X2 and in gain modes
  1 and 2, ``bigamp_lite``) from the same explicit initial factors, drawn
  with JAX's own ``_rand_init``: Z, the pseudo-data and the variances within
  1e-3·max at 20-30 iterations (the tolerance the port's ``vamp_slm`` is
  held to), ``bigamp_lite``'s accept/reject history equal.
* The wrappers (``bigamp_mc``, ``em_bigamp_mc``, ``em_bigamp_dl``) per
  realization, the port's draws replaced by JAX's for the same key
  sequence (the ``jax_draws`` fixture patches ``prng.fold_in``, ``split``
  and ``normal``); ``bigamp_rpca``, deterministic, per realization.
* The JAX tests' recovery claims (``tests/test_bigamp.py``,
  ``tests/test_bigamp_full.py``) on the port at those tests' problems, with
  the port's own draws.
* Batch order: reversing the batch reverses the results, so that no pass
  test, step or reduction runs over the batch axis.
* The package exports every JAX ``solvers`` name but the documented three.
"""
import ast
import importlib
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import jstsp19_tpu.solvers  # noqa: E402,F401
from jstsp19_tpu.core import prng as jprng  # noqa: E402
from jstsp19_torch.core import prng  # noqa: E402
from jstsp19_torch.solvers import estim  # noqa: E402

jbig = importlib.import_module("jstsp19_tpu.solvers.bigamp")
jfull = importlib.import_module("jstsp19_tpu.solvers.bigamp_full")
jest = importlib.import_module("jstsp19_tpu.solvers.estim")
big = importlib.import_module("jstsp19_torch.solvers.bigamp")
full = importlib.import_module("jstsp19_torch.solvers.bigamp_full")

T = torch.from_numpy
NB = 3  # realizations in the per-realization checks
TOL = 1e-3  # of max|ref|, at 20-30 iterations


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small batches: one intra-op thread each, so that the suite's parallel
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class JaxKeys:
    """One JAX key a realization, standing in for the port's generator."""

    def __init__(self, keys):
        self.keys = list(keys)


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's draws become JAX's: ``fold_in``/``split`` act on each
    realization's key and ``normal`` stacks each key's ``jax.random.normal``."""

    def fold_in(k, data):
        return JaxKeys(jax.random.fold_in(kk, data) for kk in k.keys)

    def split(k, n):
        if k is None:
            return (None,) * n
        parts = [jax.random.split(kk, n) for kk in k.keys]
        return tuple(JaxKeys(p[i] for p in parts) for i in range(n))

    def normal(k, shape, dtype, device):
        draws = np.stack([np.asarray(jax.random.normal(kk, tuple(shape[1:]))) for kk in k.keys])
        return T(draws).to(dtype).to(device)

    monkeypatch.setattr(prng, "fold_in", fold_in)
    monkeypatch.setattr(prng, "split", split)
    monkeypatch.setattr(prng, "normal", normal)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _crandn(rng, *shape, var=1.0):
    return (np.sqrt(var / 2) * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _nmse_db(zh, z):
    zh, z = np.asarray(zh).astype(np.complex128), np.asarray(z).astype(np.complex128)
    return 10 * np.log10((np.abs(zh - z) ** 2).sum() / (np.abs(z) ** 2).sum())


def _mc_problems(B=NB, seed=0, L=20, M=24, R=2, frac=0.7, nv=1e-3):
    """B masked low-rank problems, numpy complex64 / float32."""
    rng = np.random.default_rng(seed)
    Z = _crandn(rng, B, L, R) @ _crandn(rng, B, R, M)
    mask = (rng.random((B, L, M)) < frac).astype(np.float32)
    Y = ((Z + _crandn(rng, B, L, M, var=nv)) * mask).astype(np.complex64)
    return Y, mask, Z


def _jax_inits(B, L, M, R, seed=5):
    """JAX's own ``_rand_init`` draws of CN(0, 1) factors, one key a realization."""
    keys = [jax.random.key(seed + b) for b in range(B)]
    A = np.stack([np.asarray(jfull._rand_init(jax.random.fold_in(k, 0), (L, R), 0j, 1.0, jnp.complex64)) for k in keys])
    X = np.stack([np.asarray(jfull._rand_init(jax.random.fold_in(k, 1), (R, M), 0j, 1.0, jnp.complex64)) for k in keys])
    return A, X


def _jg():
    return jest.CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0))


def _tg():
    return estim.CAwgnPrior(0j, 1.0)


# -- the cores, per realization --------------------------------------------------------


@pytest.mark.parametrize("sparse_x", [False, True])
def test_bigamp_core_matches_jax_per_realization(sparse_x):
    """``bigamp`` from the same initial factors, Gaussian A and Gaussian or
    spike-slab X: Z, Rx and rvar_x within 1e-3·max after 20 iterations."""
    Y, mask, _ = _mc_problems()
    B, L, M = Y.shape
    R = 2
    iA, iX = _jax_inits(B, L, M, R)
    if sparse_x:
        px, jpx = estim.SparsePrior(estim.CAwgnPrior(0j, 2.0), 0.5), jest.SparsePrior(jest.CAwgnPrior(0j, 2.0), 0.5)
    else:
        px, jpx = _tg(), _jg()
    got = big.bigamp(T(Y), T(mask), R, _tg(), px, 1e-3, None, nit=20, step=0.5, init_A=T(iA), init_X=T(iX))
    for b in range(B):
        want = jbig.bigamp(jnp.asarray(Y[b]), jnp.asarray(mask[b]), R, _jg(), jpx, 1e-3, jax.random.key(0), nit=20,
                           step=0.5, init_A=jnp.asarray(iA[b]), init_X=jnp.asarray(iX[b]))
        for g, w in ((got.Z, want.Z), (got.Rx, want.Rx), (got.rvar_x, want.rvar_x)):
            assert _rel(g[b].reshape(np.shape(w)), w) <= TOL


@pytest.mark.parametrize("gain_mode,with_x2", [(1, False), (2, False), (1, True), (2, True)])
def test_bigamp_pev_matches_jax_per_realization(gain_mode, with_x2):
    """``bigamp_pev`` (adaptive step, per-element variances) from the same
    initial factors, with and without the X2 branch, gain modes 1 and 2: Z,
    Avar, Xvar, Rx and X2 within 1e-3·max after 30 iterations."""
    Y, mask, _ = _mc_problems(seed=1)
    B, L, M = Y.shape
    R = 2
    iA, iX = _jax_inits(B, L, M, R, seed=7)
    rng = np.random.default_rng(3)
    A2 = _crandn(rng, B, L, 6, var=1.0 / L)
    opts, jopts = full.BigAmpOptions(nit=30, gain_mode=gain_mode), jfull.BigAmpOptions(nit=30, gain_mode=gain_mode)
    kw = dict(A2=T(A2), prior_x2=estim.SparsePrior(estim.CAwgnPrior(0j, 1.0), 0.1)) if with_x2 else {}
    got = full.bigamp_pev(T(Y), T(mask), R, _tg(), _tg(), 1e-3, None, opts, init_A=T(iA), init_X=T(iX), **kw)
    for b in range(B):
        jkw = dict(A2=jnp.asarray(A2[b]), prior_x2=jest.SparsePrior(jest.CAwgnPrior(0j, 1.0), 0.1)) if with_x2 else {}
        want = jfull.bigamp_pev(jnp.asarray(Y[b]), jnp.asarray(mask[b]), R, _jg(), _jg(), 1e-3, jax.random.key(0),
                                jopts, init_A=jnp.asarray(iA[b]), init_X=jnp.asarray(iX[b]), **jkw)
        pairs = [(got.Z, want.Z), (got.Avar, want.Avar), (got.Xvar, want.Xvar), (got.Rx, want.Rx)]
        if with_x2:
            pairs.append((got.X2, want.X2))
        for g, w in pairs:
            assert _rel(g[b], w) <= TOL


def test_bigamp_lite_matches_jax_per_realization():
    """``bigamp_lite`` from the same initial factors: Z, Avar and Xvar within
    1e-3·max after 30 iterations, and the accept/reject history equal."""
    Y, mask, _ = _mc_problems(seed=2)
    B, L, M = Y.shape
    R = 2
    iA, iX = _jax_inits(B, L, M, R, seed=9)
    got, hist = full.bigamp_lite(T(Y), T(mask), R, 1.0, 1.0, 1e-3, None, nit=30, step=0.5, init_A=T(iA),
                                 init_X=T(iX))
    assert hist["passed"].shape == (B, 30)
    for b in range(B):
        want, jh = jfull.bigamp_lite(jnp.asarray(Y[b]), jnp.asarray(mask[b]), R, 1.0, 1.0, 1e-3, jax.random.key(0),
                                     nit=30, step=0.5, init_A=jnp.asarray(iA[b]), init_X=jnp.asarray(iX[b]))
        for g, w in ((got.Z[b], want.Z), (got.Avar[b], want.Avar), (got.Xvar[b], want.Xvar)):
            assert _rel(np.asarray(g).reshape(np.shape(w)), w) <= TOL
        np.testing.assert_array_equal(hist["passed"][b].numpy(), np.asarray(jh["passed"]))
        assert not hist["passed"][b].all()  # the adaptive step rejected a step
        np.testing.assert_allclose(hist["step"][b].numpy(), np.asarray(jh["step"]), rtol=1e-5)


# -- the wrappers, per realization -------------------------------------------------------


def test_bigamp_mc_matches_jax_draws(jax_draws):
    """``bigamp_mc`` with JAX's random initial factors for each realization's
    key: Z within 1e-3·max after 20 iterations."""
    Y, mask, _ = _mc_problems(seed=4)
    keys = [jax.random.key(10 + b) for b in range(len(Y))]
    got = big.bigamp_mc(T(Y), T(mask), 2, 1e-3, JaxKeys(keys), nit=20, step=0.5)
    for b, k in enumerate(keys):
        want = jbig.bigamp_mc(jnp.asarray(Y[b]), jnp.asarray(mask[b]), 2, 1e-3, k, nit=20, step=0.5)
        assert _rel(got.Z[b], want.Z) <= TOL


def test_em_bigamp_mc_matches_jax_per_realization(jax_draws):
    """``em_bigamp_mc`` (max rank 3, 2 EM rounds of 20 iterations) with JAX's
    draws: each realization's rank, BIC (rtol 1e-3), noise variance and Z;
    the factors padded with zeros past the rank, A·X = Z exactly."""
    Y, mask, _ = _mc_problems(seed=5)
    keys = [jax.random.key(20 + b) for b in range(len(Y))]
    got = big.em_bigamp_mc(T(Y), T(mask), 3, JaxKeys(keys), nit=20, n_em=2, step=0.5)
    assert got.rank.dtype == torch.int64 and got.rank.shape == (len(Y),) and got.bic.shape == (len(Y), 3)
    assert got.A.shape == (len(Y), Y.shape[1], 3) and got.X.shape == (len(Y), 3, Y.shape[2])
    torch.testing.assert_close(got.A @ got.X, got.Z, rtol=0, atol=0)
    for b, k in enumerate(keys):
        want = jbig.em_bigamp_mc(jnp.asarray(Y[b]), jnp.asarray(mask[b]), 3, k, nit=20, n_em=2, step=0.5)
        assert int(got.rank[b]) == want.rank
        assert not got.A[b, :, want.rank:].any() and not got.X[b, want.rank:].any()
        np.testing.assert_allclose(got.bic[b].numpy(), np.asarray(want.bic), rtol=1e-3)
        assert _rel(got.Z[b], want.Z) <= TOL
        np.testing.assert_allclose(float(got.noise_var[b]), float(want.noise_var), rtol=1e-3)


def test_em_bigamp_mc_names_the_realizations_whose_every_rank_diverged(monkeypatch):
    """A realization whose every candidate rank gives a non-finite BIC raises,
    and the message names it."""
    Y, mask, _ = _mc_problems(B=2, seed=6)
    real = big.bigamp

    def diverge_second(Yb, *args, **kw):
        res = real(Yb, *args, **kw)
        Z = res.Z.clone()
        Z[1] = torch.inf
        return res._replace(Z=Z)

    monkeypatch.setattr(big, "bigamp", diverge_second)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match=r"realizations \[1\]"):
        big.em_bigamp_mc(T(Y), T(mask), 2, g, nit=3, n_em=1)


def test_em_bigamp_dl_matches_jax_per_realization(jax_draws):
    """``em_bigamp_dl`` (2 EM rounds of 20 iterations, 10 polish rounds) with
    JAX's draws: Z within 1e-3·max, the learned sparsity, slab variance and
    noise variance within rtol 1e-3."""
    rng = np.random.default_rng(7)
    L, R, M = 12, 3, 60
    Z = _crandn(rng, NB, L, R) @ (_crandn(rng, NB, R, M) * (rng.random((NB, R, M)) < 0.3))
    Y = (Z + _crandn(rng, NB, L, M, var=1e-4)).astype(np.complex64)
    keys = [jax.random.key(30 + b) for b in range(NB)]
    got = big.em_bigamp_dl(T(Y), R, JaxKeys(keys), nit=20, n_em=2, polish_iters=10)
    for b, k in enumerate(keys):
        want = jbig.em_bigamp_dl(jnp.asarray(Y[b]), R, k, nit=20, n_em=2, polish_iters=10)
        assert _rel(got.Z[b], want.Z) <= TOL
        for f in ("sparsity", "slab_var", "noise_var"):
            np.testing.assert_allclose(float(getattr(got, f)[b]), float(getattr(want, f)), rtol=1e-3)


def test_dl_polish_matches_jax_per_realization():
    """``_dl_polish`` with one τ pair a realization: A and X within 1e-3·max."""
    rng = np.random.default_rng(8)
    L, R, M = 10, 3, 40
    Y, A0, X0 = _crandn(rng, NB, L, M), _crandn(rng, NB, L, R), _crandn(rng, NB, R, M)
    tau0 = np.array([0.5, 0.8, 0.3], np.float32)
    A, X = big._dl_polish(T(Y), T(A0), T(X0), R, T(tau0)[:, None, None], T(tau0 / 25)[:, None, None], iters=12)
    for b in range(NB):
        jA, jX = jbig._dl_polish(jnp.asarray(Y[b]), jnp.asarray(A0[b]), jnp.asarray(X0[b]), R, jnp.float32(tau0[b]),
                                 jnp.float32(tau0[b] / 25), iters=12)
        assert _rel(A[b], jA) <= TOL and _rel(X[b], jX) <= TOL


def _rpca_problems(B=NB, seed=9, L=20, M=25, R=2):
    rng = np.random.default_rng(seed)
    Z = _crandn(rng, B, L, R) @ _crandn(rng, B, R, M)
    E = np.where(rng.random((B, L, M)) < 0.05, _crandn(rng, B, L, M, var=50.0), 0)
    return (Z + E + _crandn(rng, B, L, M, var=1e-3)).astype(np.complex64), Z


def test_bigamp_rpca_matches_jax_per_realization():
    """``bigamp_rpca`` is deterministic (the spectral init, even-count median
    and all): Z within 1e-3·max after 30 iterations."""
    Y, _ = _rpca_problems()
    got = big.bigamp_rpca(T(Y), 2, 1e-3, 50.0, 0.05, None, nit=30)
    for b in range(len(Y)):
        want = jbig.bigamp_rpca(jnp.asarray(Y[b]), 2, 1e-3, 50.0, 0.05, jax.random.key(0), nit=30)
        assert _rel(got.Z[b], want.Z) <= TOL


# -- the JAX tests' recovery claims on the port ----------------------------------------


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _jax_mc_problem(seed, L, M, R, frac, nv_rel=None, nv=1e-3):
    """``tests/test_bigamp.py``'s masked low-rank problem for key ``seed``."""
    key = jax.random.key(seed)
    Z = jprng.complex_normal(jax.random.fold_in(key, 0), (L, R)) @ jprng.complex_normal(jax.random.fold_in(key, 1),
                                                                                        (R, M))
    if nv_rel is not None:
        nv = nv_rel * float(jnp.mean(jnp.abs(Z) ** 2))
        mask = (jax.random.uniform(jax.random.fold_in(key, 3), (L, M)) < frac).astype(jnp.float32)
        noise = jprng.complex_normal(jax.random.fold_in(key, 2), (L, M), var=nv)
    else:
        mask = (jax.random.uniform(jax.random.fold_in(key, 2), (L, M)) < frac).astype(jnp.float32)
        noise = jprng.complex_normal(jax.random.fold_in(key, 3), (L, M), var=nv)
    Y = mask * (Z + noise)
    return T(np.array(Y))[None], T(np.array(mask))[None], np.asarray(Z)[None], nv


def test_recovery_claims_of_test_bigamp_on_the_port():
    """``tests/test_bigamp.py``: matrix completion NMSE < 1e-3; the sparse-code
    product < 5e-2; robust PCA < 5e-2 and better than plain completion;
    EM-MC NMSE < 1e-2 at the true rank 3 with the noise variance within
    [0.2, 5]× the truth; EM-DL < 0.05 with sparsity in (0.05, 0.45) and the
    noise under 5% of the signal power."""
    Y, mask, Z, _ = _jax_mc_problem(0, 40, 60, 3, 0.6)
    res = big.bigamp_mc(Y, mask, 3, 1e-3, _gen(), nit=300, step=0.5)
    assert 10 ** (_nmse_db(res.Z, Z) / 10) < 1e-3

    key = jax.random.key(1)
    L, M, R, beta = 32, 80, 4, 0.3
    A = jprng.complex_normal(jax.random.fold_in(key, 0), (L, R))
    act = jax.random.uniform(jax.random.fold_in(key, 1), (R, M)) < beta
    X = jnp.where(act, jprng.complex_normal(jax.random.fold_in(key, 2), (R, M), var=1 / beta), 0.0)
    Zs = np.asarray(A @ X)[None]
    Ys = T(np.array(A @ X + jprng.complex_normal(jax.random.fold_in(key, 3), (L, M), var=1e-3)))[None]
    px = estim.SparsePrior(estim.CAwgnPrior(0j, 1 / beta), beta)
    res = big.bigamp(Ys, torch.ones(1, L, M), R, _tg(), px, 1e-3, _gen(1), nit=300, step=0.4)
    assert 10 ** (_nmse_db(res.Z, Zs) / 10) < 5e-2

    key = jax.random.key(2)
    L, M, R = 40, 50, 2
    Zr = jprng.complex_normal(jax.random.fold_in(key, 0), (L, R)) @ jprng.complex_normal(jax.random.fold_in(key, 1),
                                                                                         (R, M))
    out = jax.random.uniform(jax.random.fold_in(key, 2), (L, M)) < 0.05
    E = jnp.where(out, jprng.complex_normal(jax.random.fold_in(key, 3), (L, M), var=50.0), 0.0)
    Yr = T(np.array(Zr + E + jprng.complex_normal(jax.random.fold_in(key, 4), (L, M), var=1e-3)))[None]
    Zr = np.asarray(Zr)[None]
    robust = _nmse_db(big.bigamp_rpca(Yr, R, 1e-3, 50.0, 0.05, None, nit=300).Z, Zr)
    plain = _nmse_db(big.bigamp_mc(Yr, torch.ones(1, L, M), R, 1e-3, _gen(2), nit=300, step=0.5).Z, Zr)
    assert 10 ** (robust / 10) < 5e-2 and robust < plain

    Y, mask, Z, nv_true = _jax_mc_problem(13, 40, 56, 3, 0.6, nv_rel=1e-3)
    res = big.em_bigamp_mc(Y, mask, 8, _gen(3), nit=300, n_em=3, step=0.5)
    assert 10 ** (_nmse_db(res.Z, Z) / 10) < 1e-2
    assert int(res.rank[0]) == 3 and 0.2 * nv_true < float(res.noise_var[0]) < 5 * nv_true

    key = jax.random.PRNGKey(7)
    L, R, M = 24, 5, 400
    kA, kX, kS, kN = jax.random.split(key, 4)
    A = (jax.random.normal(kA, (L, R)) + 1j * jax.random.normal(jax.random.fold_in(kA, 1), (L, R))) / np.sqrt(2)
    X = (jax.random.uniform(kS, (R, M)) < 0.15) * (jax.random.normal(kX, (R, M)) + 1j * jax.random.normal(
        jax.random.fold_in(kX, 1), (R, M))) / np.sqrt(2)
    Zd = A @ X
    nv = 1e-4 * float(jnp.mean(jnp.abs(Zd) ** 2))
    Yd = Zd + jnp.sqrt(nv / 2) * (jax.random.normal(kN, (L, M)) + 1j * jax.random.normal(jax.random.fold_in(kN, 1),
                                                                                          (L, M)))
    res = big.em_bigamp_dl(T(np.array(Yd, np.complex64))[None], R, _gen(4))
    Zd = np.asarray(Zd)[None]
    assert 10 ** (_nmse_db(res.Z, Zd) / 10) < 0.05
    assert 0.05 < float(res.sparsity[0]) < 0.45
    assert float(res.noise_var[0]) < 0.05 * float(np.mean(np.abs(Zd) ** 2))


def _full_problem(seed=0, L=64, M=64, R=4, nuw=1e-4, frac=0.5):
    """``tests/test_bigamp_full.py::_problem``."""
    rng = np.random.default_rng(seed)
    A0 = (rng.standard_normal((L, R)) + 1j * rng.standard_normal((L, R))) / np.sqrt(2)
    X0 = (rng.standard_normal((R, M)) + 1j * rng.standard_normal((R, M))) / np.sqrt(2)
    Z0 = A0 @ X0
    Y = Z0 + np.sqrt(nuw / 2) * (rng.standard_normal((L, M)) + 1j * rng.standard_normal((L, M)))
    mask = (rng.random((L, M)) < frac).astype(float)
    return T((Y * mask).astype(np.complex64))[None], T(mask.astype(np.float32))[None], Z0[None]


def test_recovery_claims_of_test_bigamp_full_on_the_port():
    """``tests/test_bigamp_full.py``: PEV completion < −40 dB with per-element
    variances, < −45 dB fully observed; X2 self-calibration Z < −45 dB and
    X2 < −30 dB; Lite < −40 dB at 100%, 50% and 30% observed with a pass
    rate in (0.3, 1], and from the bad step 0.5."""
    Y, mask, Z0 = _full_problem()
    r = full.bigamp_pev(Y, mask, 4, _tg(), _tg(), 1e-4, _gen(), full.BigAmpOptions(nit=300))
    assert _nmse_db(r.Z, Z0) < -40.0
    assert r.Avar.shape == (1, 64, 4) and r.Xvar.shape == (1, 4, 64) and float(r.Xvar.std()) > 0.0
    Y, mask, Z0 = _full_problem(frac=1.0)
    r = full.bigamp_pev(Y, mask, 4, _tg(), _tg(), 1e-4, _gen(1), full.BigAmpOptions(nit=300))
    assert _nmse_db(r.Z, Z0) < -45.0

    rng = np.random.default_rng(1)
    L, M, R, N2 = 64, 64, 4, 32
    A0 = (rng.standard_normal((L, R)) + 1j * rng.standard_normal((L, R))) / np.sqrt(2)
    X0 = (rng.standard_normal((R, M)) + 1j * rng.standard_normal((R, M))) / np.sqrt(2)
    A2 = (rng.standard_normal((L, N2)) + 1j * rng.standard_normal((L, N2))) / np.sqrt(2 * L)
    X2t = np.zeros((N2, M), complex)
    idx = rng.random((N2, M)) < 0.1
    X2t[idx] = (rng.standard_normal(idx.sum()) + 1j * rng.standard_normal(idx.sum())) / np.sqrt(2)
    Z = A0 @ X0 + A2 @ X2t
    Y = Z + np.sqrt(1e-4 / 2) * (rng.standard_normal((L, M)) + 1j * rng.standard_normal((L, M)))
    r = full.bigamp_pev(T(Y.astype(np.complex64))[None], torch.ones(1, L, M), R, _tg(), _tg(), 1e-4, _gen(2),
                        full.BigAmpOptions(nit=400), A2=T(A2.astype(np.complex64))[None],
                        prior_x2=estim.SparsePrior(base=estim.CAwgnPrior(0j, 1.0), p1=0.1))
    assert _nmse_db(r.Z, Z[None]) < -45.0 and _nmse_db(r.X2, X2t[None]) < -30.0

    for frac in (1.0, 0.5, 0.3):
        Y, mask, Z0 = _full_problem(seed=2, frac=frac)
        r, hist = full.bigamp_lite(Y, mask, 4, 1.0, 1.0, 1e-4, _gen(3), nit=400, step=0.05)
        assert _nmse_db(r.Z, Z0) < -40.0
        assert 0.3 < float(hist["passed"].float().mean()) <= 1.0
    Y, mask, Z0 = _full_problem(seed=3)
    r, _ = full.bigamp_lite(Y, mask, 4, 1.0, 1.0, 1e-4, _gen(4), nit=400, step=0.5)
    assert _nmse_db(r.Z, Z0) < -40.0


# -- batch order -------------------------------------------------------------------------


def test_reversing_the_batch_reverses_every_result(jax_draws):
    """Each realization's result does not depend on the others: the cores from
    explicit initial factors, ``bigamp_rpca``, and ``em_bigamp_mc`` /
    ``em_bigamp_dl`` with each realization's own key, solved in order and
    reversed, agree to float32 roundoff (1e-5·max), the selected ranks and
    ``bigamp_lite``'s history exactly."""
    Y, mask, _ = _mc_problems(B=4, seed=10)
    B, L, M = Y.shape
    iA, iX = _jax_inits(B, L, M, 2, seed=11)
    rev = slice(None, None, -1)

    def both(fn, *arrays):
        fwd = fn(*(T(a.copy()) for a in arrays))
        bwd = fn(*(T(a[rev].copy()) for a in arrays))
        return fwd, bwd

    def close(f, b):
        assert _rel(b.flip(0), f) <= 1e-5

    f, b = both(lambda y, m, a, x: big.bigamp(y, m, 2, _tg(), _tg(), 1e-3, None, nit=20, step=0.5, init_A=a,
                                              init_X=x).Z, Y, mask, iA, iX)
    close(f, b)
    f, b = both(lambda y, m, a, x: full.bigamp_pev(y, m, 2, _tg(), _tg(), 1e-3, None, full.BigAmpOptions(nit=30),
                                                   init_A=a, init_X=x).Z, Y, mask, iA, iX)
    close(f, b)
    (fr, fh), (br, bh) = both(lambda y, m, a, x: full.bigamp_lite(y, m, 2, 1.0, 1.0, 1e-3, None, nit=30, init_A=a,
                                                                  init_X=x), Y, mask, iA, iX)
    close(fr.Z, br.Z)
    assert torch.equal(bh["passed"].flip(0), fh["passed"]) and torch.equal(bh["step"].flip(0), fh["step"])
    Yr, _ = _rpca_problems(B=4)
    f, b = both(lambda y: big.bigamp_rpca(y, 2, 1e-3, 50.0, 0.05, None, nit=30).Z, Yr)
    close(f, b)

    keys = [jax.random.key(40 + i) for i in range(B)]
    fwd = big.em_bigamp_mc(T(Y), T(mask), 3, JaxKeys(keys), nit=20, n_em=2, step=0.5)
    bwd = big.em_bigamp_mc(T(Y[rev].copy()), T(mask[rev].copy()), 3, JaxKeys(keys[::-1]), nit=20, n_em=2, step=0.5)
    assert torch.equal(bwd.rank.flip(0), fwd.rank)
    close(fwd.Z, bwd.Z)
    np.testing.assert_allclose(bwd.bic.flip(0).numpy(), fwd.bic.numpy(), rtol=1e-6)
    fwd = big.em_bigamp_dl(T(Y), 2, JaxKeys(keys), nit=20, n_em=2, polish_iters=5)
    bwd = big.em_bigamp_dl(T(Y[rev].copy()), 2, JaxKeys(keys[::-1]), nit=20, n_em=2, polish_iters=5)
    close(fwd.Z, bwd.Z)
    np.testing.assert_allclose(bwd.sparsity.flip(0).numpy(), fwd.sparsity.numpy(), rtol=1e-6)


# -- the exports -------------------------------------------------------------------------


def test_the_port_exports_every_jax_solvers_name_but_the_documented_three():
    """Every name ``jstsp19_tpu/solvers/__init__.py`` imports is in the
    port's ``_EXPORTS``, except ``gamp``, ``gamp_se`` and ``vamp_slm`` (there
    the port's package names its modules); the fifteen bilinear names resolve,
    ``bigamp``, ``pbigamp`` and ``hutamp`` to the functions also after their
    modules are imported."""
    import jstsp19_torch.solvers as ts

    src = (pathlib.Path(jstsp19_tpu.solvers.__file__)).read_text()
    names = {a.asname or a.name for node in ast.walk(ast.parse(src)) if isinstance(node, ast.ImportFrom)
             for a in node.names}
    missing = names - set(ts._EXPORTS) - {"gamp", "gamp_se", "vamp_slm"}
    assert not missing, sorted(missing)
    bilinear = ("bigamp", "bigamp_mc", "bigamp_rpca", "em_bigamp_mc", "em_bigamp_dl", "BigAmpOptions", "bigamp_pev",
                "bigamp_lite", "pbigamp", "em_pbigamp", "hutamp", "prior_moments", "rank_one_fit", "mc_prior_mse",
                "rank_one_se")
    for n in bilinear:
        assert n in names and callable(getattr(ts, n)), n
    for n in ("bigamp", "pbigamp", "hutamp"):
        importlib.import_module(f"jstsp19_torch.solvers.{n}")
        assert getattr(ts, n) is getattr(importlib.import_module(f"jstsp19_torch.solvers.{n}"), n)
