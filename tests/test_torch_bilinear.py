"""The port's HUTAMP, P-BiG-AMP and rank-one solvers (``solvers/hutamp.py``,
``solvers/pbigamp.py``, ``solvers/rank_one.py``) against the JAX package on
the same numpy inputs.  The port solves a batch of problems in one call; JAX
solves each in its own call.

* ``pbigamp`` from the same initial b and c (A one a realization and shared),
  ``rank_one_fit`` from the deterministic mean init (``vvar_init=0.0``) in
  both branches, ``prior_moments``: per realization within 1e-3·max at
  20 iterations (``rank_one_fit``: 10).
* ``hutamp`` and ``em_pbigamp`` per realization with JAX's draws for the
  same key sequence (the ``jax_draws`` fixture patches ``prng.fold_in``,
  ``split`` and ``normal``); ``mc_prior_mse`` and ``rank_one_se`` at the
  ensemble level (the Monte-Carlo draws differ; the SE trajectories agree to
  their sampling error).
* The JAX tests' recovery claims (``tests/test_hutamp.py``,
  ``tests/test_pbigamp.py``, ``tests/test_rank_one.py``) on the port at
  those tests' problems, with the port's own draws.
* Batch order, and the estimators these solvers learn carried between the
  packages by ``interop``.
"""
import importlib
from itertools import permutations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.core import prng as jprng  # noqa: E402
from jstsp19_torch import interop  # noqa: E402
from jstsp19_torch.core import prng  # noqa: E402
from jstsp19_torch.solvers import estim  # noqa: E402

jhut = importlib.import_module("jstsp19_tpu.solvers.hutamp")
jpb = importlib.import_module("jstsp19_tpu.solvers.pbigamp")
jr1 = importlib.import_module("jstsp19_tpu.solvers.rank_one")
jest = importlib.import_module("jstsp19_tpu.solvers.estim")
hut = importlib.import_module("jstsp19_torch.solvers.hutamp")
pb = importlib.import_module("jstsp19_torch.solvers.pbigamp")
r1 = importlib.import_module("jstsp19_torch.solvers.rank_one")

T = torch.from_numpy
NB = 3
TOL = 1e-3


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


def _nmse(zh, z):
    zh, z = np.asarray(zh).astype(np.complex128), np.asarray(z).astype(np.complex128)
    return (np.abs(zh - z) ** 2).sum() / (np.abs(z) ** 2).sum()


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# -- hutamp --------------------------------------------------------------------------------


def _endmembers(T_):
    t = np.linspace(0, 1, T_)
    return np.stack([0.2 + np.exp(-0.5 * ((t - 0.25) / 0.08) ** 2),
                     0.3 + 0.8 * np.exp(-0.5 * ((t - 0.6) / 0.15) ** 2),
                     0.1 + 0.5 * t + 0.4 * np.exp(-0.5 * ((t - 0.9) / 0.1) ** 2)]).astype(np.float32)


def _hsi_problems(B=NB, seed=0, N=60, T_=12):
    rng = np.random.default_rng(seed)
    e = rng.exponential(size=(B, N, 3))
    Z = (e / e.sum(-1, keepdims=True)) @ _endmembers(T_)
    return (Z + 0.01 * rng.standard_normal(Z.shape)).astype(np.float32), Z


def test_hutamp_matches_jax_per_realization(jax_draws):
    """``hutamp`` (2 EM rounds of 20 iterations) with JAX's draws: S, A and Z
    within 1e-3·max."""
    Y, _ = _hsi_problems()
    keys = [jax.random.key(b) for b in range(NB)]
    got = hut.hutamp(T(Y), 3, JaxKeys(keys), nit=20, n_em=2)
    for b, k in enumerate(keys):
        want = jhut.hutamp(jnp.asarray(Y[b]), 3, k, nit=20, n_em=2)
        for g, w in ((got.S, want.S), (got.A, want.A), (got.Z, want.Z)):
            assert _rel(g[b], w) <= TOL


# -- pbigamp ------------------------------------------------------------------------------


def _pb_problems(B=NB, seed=1, M=30, Nb=4, Nc=10, shared=False):
    rng = np.random.default_rng(seed)
    A = _crandn(rng, *((M, Nb, Nc) if shared else (B, M, Nb, Nc)), var=1.0 / (Nb * Nc))
    b0 = 1 + 0.2 * _crandn(rng, B, Nb)
    c0 = _crandn(rng, B, Nc) * (rng.random((B, Nc)) < 0.4)
    z = np.einsum("mij,bi,bj->bm" if shared else "bmij,bi,bj->bm", A, b0, c0)
    return A, (z + _crandn(rng, B, M, var=1e-4)).astype(np.complex64), z


def _pb_priors(mod, cplx):
    return mod.CAwgnPrior(cplx(1.0 + 0j), cplx(0.05)), mod.SparsePrior(mod.CAwgnPrior(cplx(0j), cplx(2.0)), cplx(0.4))


@pytest.mark.parametrize("shared", [False, True])
def test_pbigamp_matches_jax_per_realization(shared):
    """``pbigamp`` from the same initial b and c, A one a realization or one for
    all: z, b, c, the pseudo-data variances and zvar within 1e-3·max after
    20 iterations."""
    A, y, _ = _pb_problems(shared=shared)
    rng = np.random.default_rng(2)
    ib, ic = 1 + 0.2 * _crandn(rng, NB, A.shape[-2]), _crandn(rng, NB, A.shape[-1])
    pbt, pct = _pb_priors(estim, lambda v: v)
    got = pb.pbigamp(T(y), T(A), pbt, pct, 1e-4, None, nit=20, init_b=T(ib), init_c=T(ic))
    pbj, pcj = _pb_priors(jest, jnp.asarray)
    for b in range(NB):
        want = jpb.pbigamp(jnp.asarray(y[b]), jnp.asarray(A if shared else A[b]), pbj, pcj, 1e-4, jax.random.key(0),
                           nit=20, init_b=jnp.asarray(ib[b]), init_c=jnp.asarray(ic[b]))
        for f in ("z", "b", "c", "rvar_b", "rvar_c", "zvar"):
            assert _rel(getattr(got, f)[b], getattr(want, f)) <= TOL, f


def test_em_pbigamp_matches_jax_per_realization(jax_draws):
    """``em_pbigamp`` (3 EM rounds of 20 iterations) with JAX's draws: z within
    1e-3·max; the learned noise variance, activity and slab variance within
    rtol 1e-3."""
    A, y, _ = _pb_problems(seed=3)
    keys = [jax.random.key(10 + b) for b in range(NB)]
    got = pb.em_pbigamp(T(y), T(A), JaxKeys(keys), n_em=3, nit=20)
    for b, k in enumerate(keys):
        want = jpb.em_pbigamp(jnp.asarray(y[b]), jnp.asarray(A[b]), k, n_em=3, nit=20)
        assert _rel(got.z[b], want.z) <= TOL
        for g, w in ((got.noise_var[b], want.noise_var), (got.prior_c.p1[b], want.prior_c.p1),
                     (got.prior_c.base.var0[b], want.prior_c.base.var0)):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-3)


# -- rank-one fit --------------------------------------------------------------------------


def _grid(nx=100):
    """``rankOneSE.m:53-66``'s sparse-exponential grid."""
    x = np.linspace(1 / nx, 2, nx)
    px = np.exp(-x)
    px = 0.1 * px / px.sum()
    return np.concatenate([[0.0], x]).astype(np.float32), np.concatenate([[0.9], px]).astype(np.float32)


def _r1_problems(B=NB, seed=4, m=80, n=40, wvar=0.3):
    rng = np.random.default_rng(seed)
    atoms, w = _grid(20)
    w64 = w.astype(np.float64)
    v0 = atoms[rng.choice(len(atoms), (B, n), p=w64 / w64.sum())]
    u0 = rng.standard_normal((B, m))
    return (u0[:, :, None] * v0[:, None, :] + np.sqrt(m * wvar) * rng.standard_normal((B, m, n))).astype(np.float32)


@pytest.mark.parametrize("lin_est", [False, True])
def test_rank_one_fit_matches_jax_per_realization(lin_est):
    """``rank_one_fit`` from the deterministic mean init on the discrete v
    prior, both branches: u, v and the tracked correlations within 1e-3·max
    after 10 iterations."""
    A = _r1_problems()
    atoms, w = _grid(20)
    got = r1.rank_one_fit(T(A), estim.AwgnPrior(0.0, 1.0), estim.DiscretePrior(T(atoms), T(w)), 0.3, nit=10,
                          vvar_init=0.0, lin_est=lin_est)
    ju, jv = jest.AwgnPrior(jnp.asarray(0.0), jnp.asarray(1.0)), jest.DiscretePrior(jnp.asarray(atoms), jnp.asarray(w))
    for b in range(NB):
        want = jr1.rank_one_fit(jnp.asarray(A[b]), ju, jv, jnp.asarray(0.3), nit=10, vvar_init=0.0, lin_est=lin_est)
        for f in ("u", "v", "corru", "corrv"):
            assert _rel(getattr(got, f)[b], getattr(want, f)) <= TOL, f


def test_prior_moments_match_jax():
    """Discrete, spike-slab and Gaussian moments, rtol 1e-6."""
    atoms, w = _grid()
    cases = [(estim.DiscretePrior(T(atoms), T(w)), jest.DiscretePrior(jnp.asarray(atoms), jnp.asarray(w))),
             (estim.SparsePrior(estim.CAwgnPrior(0.5 + 0j, 2.0), 0.3),
              jest.SparsePrior(jest.CAwgnPrior(jnp.asarray(0.5 + 0j), jnp.asarray(2.0)), jnp.asarray(0.3))),
             (estim.AwgnPrior(0.25, 3.0), jest.AwgnPrior(jnp.asarray(0.25), jnp.asarray(3.0)))]
    for port, jx in cases:
        for g, want in zip(r1.prior_moments(port), jr1.prior_moments(jx)):
            np.testing.assert_allclose(complex(g), complex(want), rtol=1e-6)


def test_state_evolution_matches_jax_to_its_sampling_error():
    """``mc_prior_mse`` and ``rank_one_se`` at 5 dB on the test's priors: the
    squared-correlation trajectories within 0.02 of JAX's (8192 samples each,
    different draws)."""
    atoms, w = _grid()
    pu, pv = estim.AwgnPrior(0.0, 1.0), estim.DiscretePrior(T(atoms), T(w))
    ju, jv = jest.AwgnPrior(jnp.asarray(0.0), jnp.asarray(1.0)), jest.DiscretePrior(jnp.asarray(atoms), jnp.asarray(w))
    um, uv = r1.prior_moments(pu)
    vm, vv = r1.prior_moments(pv)
    wvar = float((um**2 + uv) * (vm**2 + vv)) * 10 ** -0.5
    pw = T(w / w.sum())
    mse_u = r1.mc_prior_mse(lambda g, n: torch.randn(n, generator=g), pu, seed=11, device="cpu")
    mse_v = r1.mc_prior_mse(lambda g, n: T(atoms)[torch.multinomial(pw, n, True, generator=g)], pv, seed=12,
                            device="cpu")
    cu, cv = r1.rank_one_se(mse_u, mse_v, 0.5, um, uv, vm, vv, wvar, nit=10)
    jw = jv.weights / jnp.sum(jv.weights)
    jmu = jr1.mc_prior_mse(lambda k, n: jax.random.normal(k, (n,)), ju, seed=11)
    jmv = jr1.mc_prior_mse(lambda k, n: jv.atoms[jax.random.choice(k, jv.atoms.shape[0], (n,), p=jw)], jv, seed=12)
    jcu, jcv = jr1.rank_one_se(jmu, jmv, 0.5, *jr1.prior_moments(ju), *jr1.prior_moments(jv), jnp.asarray(wvar),
                               nit=10)
    assert cu.shape == (10,) and cv.shape == (11,)
    np.testing.assert_allclose(cu.numpy(), np.asarray(jcu), atol=0.02)
    np.testing.assert_allclose(cv.numpy(), np.asarray(jcv), atol=0.02)


# -- the JAX tests' recovery claims on the port ------------------------------------------


def test_recovery_claims_of_test_hutamp_on_the_port():
    """``tests/test_hutamp.py``: the synthetic scene's reconstruction NMSE
    < 0.01, abundances on the simplex, endmembers matched up to permutation
    with mean cosine > 0.93.  The NMSE claim depends on the initial draw in
    both packages (JAX meets it at its test's key, and at one of the keys
    100-105); the port is run with its generator seeded 0."""
    key = jax.random.key(9)
    N, T_, R = 400, 48, 3
    A_true = _endmembers(T_)
    e = jax.random.exponential(jax.random.fold_in(key, 0), (N, R))
    Z_true = np.asarray((e / jnp.sum(e, axis=1, keepdims=True)) @ jnp.asarray(A_true))
    nv = 1e-4 * float(np.mean(Z_true**2))
    Y = Z_true + np.sqrt(nv) * np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (N, T_)))
    res = hut.hutamp(T(Y.astype(np.float32))[None], R, _gen(), nit=150, n_em=3, step=0.3)
    assert _nmse(res.Z, Z_true[None]) < 0.01
    assert float(res.S.min()) >= 0.0
    np.testing.assert_allclose(res.S.sum(-1).numpy(), 1.0, atol=1e-5)
    Ae = res.A[0].numpy()
    best = max(np.mean([np.dot(Ae[p[r]], A_true[r]) / (np.linalg.norm(Ae[p[r]]) * np.linalg.norm(A_true[r]) + 1e-12)
                        for r in range(R)]) for p in permutations(range(R)))
    assert best > 0.93


def _align(est, true):
    return (np.vdot(est, true) / max(np.vdot(est, est).real, 1e-30)) * est


def test_recovery_claims_of_test_pbigamp_on_the_port():
    """``tests/test_pbigamp.py``: self-calibration z NMSE < 0.02 and aligned c
    < 0.05; rank-one projections' b·cᵀ < 0.05; EM-P-BiG-AMP z < −40 dB, the
    noise variance within [0.3, 3]× the truth and p1 within 0.05 of k/Nc."""
    key = jax.random.key(11)
    M, Nc, k = 96, 128, 8
    Phi = jprng.complex_normal(jax.random.fold_in(key, 0), (M, Nc)) / np.sqrt(M)
    beta = k / Nc
    act = jax.random.uniform(jax.random.fold_in(key, 1), (Nc,)) < beta
    c_true = np.asarray(jnp.where(act, jprng.complex_normal(jax.random.fold_in(key, 2), (Nc,), var=1 / beta), 0.0))
    b_true = np.asarray(1.0 + jprng.complex_normal(jax.random.fold_in(key, 3), (M,), var=0.05))
    z_true = b_true * (np.asarray(Phi) @ c_true)
    nv = 1e-4 * float(np.mean(np.abs(z_true) ** 2))
    y = z_true + np.asarray(jprng.complex_normal(jax.random.fold_in(key, 4), (M,), var=nv))
    A = np.zeros((M, M, Nc), np.complex64)
    A[np.arange(M), np.arange(M), :] = np.asarray(Phi)
    res = pb.pbigamp(T(y.astype(np.complex64))[None], T(A), estim.CAwgnPrior(1.0 + 0j, 0.05),
                     estim.SparsePrior(estim.CAwgnPrior(0j, 1.0 / beta), beta), nv, _gen(), nit=200, step=0.5)
    assert _nmse(res.z, z_true[None]) < 0.02
    assert _nmse(_align(res.c[0].numpy(), c_true), c_true) < 0.05

    key = jax.random.key(21)
    M, Nb, Nc = 200, 12, 12
    U = jprng.complex_normal(jax.random.fold_in(key, 0), (M, Nb), var=1.0)
    V = jprng.complex_normal(jax.random.fold_in(key, 1), (M, Nc), var=1.0)
    b_true = np.asarray(jprng.complex_normal(jax.random.fold_in(key, 2), (Nb,)))
    c_true = np.asarray(jprng.complex_normal(jax.random.fold_in(key, 3), (Nc,)))
    A = np.asarray(jnp.einsum("mi,mj->mij", U, V) / np.sqrt(M))
    z_true = np.einsum("mij,i,j->m", A, b_true, c_true)
    nv = 1e-4 * float(np.mean(np.abs(z_true) ** 2))
    y = z_true + np.asarray(jprng.complex_normal(jax.random.fold_in(key, 4), (M,), var=nv))
    prior = estim.CAwgnPrior(0j, 1.0)
    res = pb.pbigamp(T(y.astype(np.complex64))[None], T(A.copy()), prior, prior, nv, _gen(1), nit=300, step=0.4)
    G = np.outer(res.b[0].numpy(), res.c[0].numpy())
    assert _nmse(G, np.outer(b_true, c_true)) < 0.05

    rng = np.random.default_rng(0)
    M, Nb, Nc, k = 300, 8, 64, 6
    A = (rng.standard_normal((M, Nb, Nc)) + 1j * rng.standard_normal((M, Nb, Nc))) / np.sqrt(2 * Nb * Nc)
    b0 = 1.0 + 0.2 * (rng.standard_normal(Nb) + 1j * rng.standard_normal(Nb)) / np.sqrt(2)
    c0 = np.zeros(Nc, complex)
    c0[rng.choice(Nc, k, False)] = (rng.standard_normal(k) + 1j * rng.standard_normal(k)) / np.sqrt(2)
    z0 = np.einsum("mij,i,j->m", A, b0, c0)
    wvar = 1e-4 * np.mean(np.abs(z0) ** 2)
    y = z0 + np.sqrt(wvar / 2) * (rng.standard_normal(M) + 1j * rng.standard_normal(M))
    res = pb.em_pbigamp(T(y.astype(np.complex64))[None], T(A.astype(np.complex64)), _gen(2), n_em=6, nit=120)
    assert 10 * np.log10(_nmse(res.z, z0[None])) < -40.0
    assert 0.3 * wvar < float(res.noise_var[0]) < 3.0 * wvar
    assert abs(float(res.prior_c.p1[0]) - k / Nc) < 0.05


def test_recovery_claims_of_test_rank_one_on_the_port():
    """``tests/test_rank_one.py`` at 5 dB (m, n = 1000, 500): the MMSE fit's
    squared correlations within 0.1 of the SE's last value with corr(u) >
    0.5, the SE non-decreasing, the linear branch's corr(v) in [0, 1] and no
    better than the MMSE one's by more than 0.02."""
    key = jax.random.key(3)
    ku, kv, kw = jax.random.split(key, 3)
    atoms, w = _grid()
    M, N = 1000, 500
    u0 = np.asarray(jax.random.normal(ku, (M,)))
    jw = jnp.asarray(w) / jnp.sum(jnp.asarray(w))
    v0 = atoms[np.asarray(jax.random.choice(kv, len(atoms), (N,), p=jw))]
    pu, pv = estim.AwgnPrior(0.0, 1.0), estim.DiscretePrior(T(atoms), T(w))
    um, uv = r1.prior_moments(pu)
    vm, vv = r1.prior_moments(pv)
    wvar = float((um**2 + uv) * (vm**2 + vv)) * 10 ** -0.5
    A = np.outer(u0, v0) + np.sqrt(M * wvar) * np.asarray(jax.random.normal(kw, (M, N)))
    A = T(A.astype(np.float32))[None]

    def corr(a, b):
        a, b = a.numpy().ravel().astype(np.float64), b.astype(np.float64)
        return np.dot(a, b) ** 2 / (np.dot(a, a) * np.dot(b, b))

    res = r1.rank_one_fit(A, pu, pv, wvar, nit=10)
    pw = T(w / w.sum())
    mse_u = r1.mc_prior_mse(lambda g, n: torch.randn(n, generator=g), pu, seed=11, device="cpu")
    mse_v = r1.mc_prior_mse(lambda g, n: T(atoms)[torch.multinomial(pw, n, True, generator=g)], pv, seed=12,
                            device="cpu")
    cu, cv = r1.rank_one_se(mse_u, mse_v, N / M, um, uv, vm, vv, wvar, nit=10)
    eu, ev = corr(res.u, u0), corr(res.v, v0)
    assert eu > 0.5 and abs(eu - float(cu[-1])) < 0.1 and abs(ev - float(cv[-1])) < 0.1
    assert (np.diff(cv.numpy()) > -1e-6).all()
    lin = r1.rank_one_fit(A, pu, pv, wvar, nit=10, lin_est=True)
    cl = corr(lin.v, v0)
    assert np.isfinite(cl) and 0.0 <= cl <= 1.0 and ev >= cl - 0.02


def test_far_tail_half_line_moments_match_the_exact_ones():
    """``_tn_moments`` on half-lines 12σ to 1e6σ out, where the float32
    log-domain ratio is past its resolution and the Mills-ratio series takes
    over: mean and variance within 1e-4 of the exact ones (float64: from
    erfcx up to 100σ, where 1 + c·λ − λ² still resolves the variance, and
    the edge plus σ(1/c − 2/c³), variance σ²(1/c² − 6/c⁴) beyond), both
    sides."""
    from scipy.special import erfcx

    c = np.array([12.5, 20.0, 100.0, 1e3, 1e5, 1e6])
    near = c <= 100
    lam = np.sqrt(2 / np.pi) / erfcx(np.minimum(c, 100) / np.sqrt(2))
    delta = np.where(near, lam - c, 1 / c - 2 / c**3)
    t = np.where(near, 1 + c * lam - lam**2, 1 / c**2 - 6 / c**4)
    sig = 0.3
    z = np.zeros_like(c, dtype=np.float32)
    pvar = np.full_like(z, sig**2)
    inf = np.full_like(z, np.inf)
    edge = (c * sig).astype(np.float32)
    for lo, hi, sign in ((edge, inf, 1.0), (-inf, -edge, -1.0)):
        mean, var, _ = estim._tn_moments(T(z), T(pvar), T(lo), T(hi))
        want_mean = sign * (np.abs(edge.astype(np.float64)) + sig * delta)
        assert np.all(np.abs(mean.numpy() - want_mean) <= 1e-4 * np.abs(want_mean))
        assert np.all(np.abs(var.numpy() - sig**2 * t) <= 1e-4 * sig**2 * t)


# -- batch order and the estimators carried across -------------------------------------


def test_reversing_the_batch_reverses_every_result(jax_draws):
    """``hutamp`` and ``em_pbigamp`` with each realization's own key,
    ``pbigamp`` and ``rank_one_fit`` from explicit inits, solved in order and
    reversed, agree to float32 roundoff (1e-5·max)."""
    rev = slice(None, None, -1)
    keys = [jax.random.key(50 + b) for b in range(NB)]

    def close(fwd, bwd):
        assert _rel(bwd.flip(0), fwd) <= 1e-5

    Y, _ = _hsi_problems(seed=5)
    close(hut.hutamp(T(Y), 3, JaxKeys(keys), nit=20, n_em=2).Z,
          hut.hutamp(T(Y[rev].copy()), 3, JaxKeys(keys[::-1]), nit=20, n_em=2).Z)
    A, y, _ = _pb_problems(seed=6)
    f = pb.em_pbigamp(T(y), T(A), JaxKeys(keys), n_em=2, nit=20)
    b = pb.em_pbigamp(T(y[rev].copy()), T(A[rev].copy()), JaxKeys(keys[::-1]), n_em=2, nit=20)
    close(f.z, b.z)
    close(f.noise_var, b.noise_var)
    close(f.prior_c.p1, b.prior_c.p1)
    pbt, pct = _pb_priors(estim, lambda v: v)
    f = pb.pbigamp(T(y), T(A), pbt, pct, 1e-4, JaxKeys(keys), nit=20)
    b = pb.pbigamp(T(y[rev].copy()), T(A[rev].copy()), pbt, pct, 1e-4, JaxKeys(keys[::-1]), nit=20)
    close(f.z, b.z)
    Ar = _r1_problems(seed=7)
    atoms, w = _grid(20)
    pv = estim.DiscretePrior(T(atoms), T(w))
    f = r1.rank_one_fit(T(Ar), estim.AwgnPrior(0.0, 1.0), pv, 0.3, nit=10, vvar_init=0.0)
    b = r1.rank_one_fit(T(Ar[rev].copy()), estim.AwgnPrior(0.0, 1.0), pv, 0.3, nit=10, vvar_init=0.0)
    close(f.v, b.v)
    close(f.corru, b.corru)


def test_learned_estimators_round_trip_through_interop_and_match_jax():
    """``hutamp``'s two NNGM priors (the endmember prior's scale one a
    realization) and ``em_pbigamp``'s learned ``SparsePrior(CAwgnPrior)`` and b
    prior go through ``estimator_to_numpy`` → ``estimator_to_torch``
    unchanged, and each realization's prior estimates as JAX's built from the
    same parameters (rtol 1e-5)."""
    rng = np.random.default_rng(8)
    y_energy = T(np.array([0.5, 1.0, 2.0], np.float32))[:, None, None]
    prior_s, prior_a = hut._priors(y_energy, 3)
    A, y, _ = _pb_problems(seed=9)
    res = pb.em_pbigamp(T(y), T(A), _gen(), n_em=2, nit=10)
    prior_b = estim.CAwgnPrior(1.0, T(np.array([[0.05], [0.1], [0.2]], np.float32)))
    rhat = T(np.abs(rng.standard_normal((NB, 4, 5))).astype(np.float32))
    chat = T(_crandn(rng, NB, 10))
    for port, r in ((prior_s, rhat), (prior_a, rhat), (res.prior_c, chat), (prior_b, chat)):
        back = interop.estimator_to_torch(interop.estimator_to_numpy(port))
        assert type(back) is type(port)
        got, want = port.estim(r, 0.1), back.estim(r, 0.1)
        for g, w_ in zip(got, want):
            torch.testing.assert_close(g, w_, rtol=0, atol=0)
        for b in range(NB):
            params = interop.estimator_to_numpy(port)

            def pick(v):
                if isinstance(v, dict):
                    return {k: pick(e) for k, e in v.items()}
                if isinstance(v, str):
                    return v
                a = np.asarray(v)
                return a[b] if a.ndim and a.shape[0] == NB else a

            jx = _to_jax(pick(params))
            jwant = jx.estim(jnp.asarray(r[b].numpy()), 0.1)
            for g, w_ in zip(got, jwant):
                np.testing.assert_allclose(g[b].numpy(), np.asarray(w_).reshape(g[b].shape), rtol=1e-5, atol=1e-7)


def _to_jax(d):
    """A JAX estimator from a port estimator's numpy dict (one realization)."""
    kind = d["type"]
    kw = {k: (_to_jax(v) if isinstance(v, dict) else jnp.asarray(np.asarray(v).reshape(np.shape(v))))
          for k, v in d.items() if k != "type"}
    if kind == "NNGMPrior":
        kw = {k: (v.reshape(-1) if k in ("weights", "means", "variances") else v.reshape(())) for k, v in kw.items()}
    else:
        kw = {k: (v if isinstance(v, (jest.CAwgnPrior,)) else v.reshape(())) for k, v in kw.items()}
    return getattr(jest, kind)(**kw)
