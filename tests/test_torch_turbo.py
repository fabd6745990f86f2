"""The port's turbo solvers (``solvers/turbo.py``, ``solvers/turbo_em.py``)
against the JAX package on the same numpy inputs: the chain smoothers to
float32 roundoff (rtol 1e-5), each solver per element over a short horizon
(2 rounds of 10 inner iterations: x and every learned hyperparameter within
1e-3·max, the tolerance the port's ``vamp_slm`` is held to), the batch
order (each realization's result does not depend on the others), and the
JAX tests' recovery claims on the port at those tests' problems.  The port
solves a batch of problems in one call; JAX solves each in its own call."""
import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.core import prng as jprng  # noqa: E402
from jstsp19_tpu.ops import KronDictOp as JKronDictOp, MatrixOp as JMatrixOp  # noqa: E402
from jstsp19_tpu.solvers import turbo as jturbo, turbo_em as jturbo_em  # noqa: E402
from jstsp19_torch.harness import em_turbo as et  # noqa: E402
from jstsp19_torch.ops.base import MatrixOp  # noqa: E402
from jstsp19_torch.ops.kron import KronDictOp  # noqa: E402
from jstsp19_torch.solvers import estim, turbo, turbo_em  # noqa: E402
from jstsp19_torch.solvers.vamp_slm import vamp_slm  # noqa: E402

T = torch.from_numpy
NB = 3  # realizations in the per-element checks


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small batches: one intra-op thread each, so that the suite's parallel
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _crandn(rng, *shape, var=1.0):
    return (np.sqrt(var / 2) * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _nmse_db(xh, x):
    xh, x = np.asarray(xh).reshape(-1), np.asarray(x).reshape(-1)
    return 10 * np.log10((np.abs(xh - x) ** 2).sum() / (np.abs(x) ** 2).sum())


def _kron_problems(B=NB, seed=0, Gr=16, K=4, N=20, M=8, beta=0.2, nv=1e-2):
    """B spike-slab problems y = A·X·B + CN(0, nv) with full-rank Grams,
    numpy complex64."""
    rng = np.random.default_rng(seed)
    A = _crandn(rng, B, N, Gr, var=1 / N)
    Bm = _crandn(rng, B, K, M, var=1 / K)
    X = np.where(rng.random((B, Gr, K)) < beta, _crandn(rng, B, Gr, K, var=1 / beta), 0).astype(np.complex64)
    Y = (A @ X @ Bm + _crandn(rng, B, N, M, var=nv)).astype(np.complex64)
    return A, Bm, X, Y


def _vector_problems(B=NB, seed=1, n=64, m=40, beta=0.2, nv=1e-3):
    rng = np.random.default_rng(seed)
    A = _crandn(rng, B, m, n, var=1 / m)
    x = np.where(rng.random((B, n)) < beta, _crandn(rng, B, n), 0).astype(np.complex64)
    y = (np.einsum("bmn,bn->bm", A, x) + _crandn(rng, B, m, var=nv)).astype(np.complex64)
    return A, x, y


# -- the chain smoothers ---------------------------------------------------------------


@pytest.mark.parametrize("dim", [-2, -1])
def test_markov_extrinsic_matches_jax_along_each_axis(dim):
    """Chain along the angle axis (JAX's axis 0) and along the other axis
    (JAX's ``_markov_extrinsic(llr.T).T``, the MRF's column chain) of a
    batch of (16, 4) LLR matrices, rtol 1e-5."""
    llr = (np.random.default_rng(2).standard_normal((NB, 16, 4)) * 4).astype(np.float32)
    got = turbo._markov_extrinsic(T(llr), 0.05, 0.3, dim).numpy()
    for b in range(NB):
        if dim == -2:
            want = jturbo._markov_extrinsic(jnp.asarray(llr[b]), 0.05, 0.3)
        else:
            want = jturbo._markov_extrinsic(jnp.asarray(llr[b].T), 0.05, 0.3).T
        np.testing.assert_allclose(got[b], np.asarray(want), rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_markov_fb_matches_jax_with_per_realization_parameters():
    """``markov_fb`` along the chain axis with λ and p01 one per realization
    (B, 1, 1): pi_in, s_post and s_corr against JAX's per realization, rtol
    1e-5."""
    rng = np.random.default_rng(3)
    pi_out = rng.uniform(0.02, 0.98, (NB, 12, 4)).astype(np.float32)
    lam = np.array([0.1, 0.25, 0.4], np.float32)
    p01 = np.array([0.05, 0.2, 0.5], np.float32)
    got = turbo_em.markov_fb(T(pi_out), T(lam)[:, None, None], T(p01)[:, None, None], -2)
    for b in range(NB):
        want = jturbo_em.markov_fb(jnp.asarray(pi_out[b]), jnp.float32(lam[b]), jnp.float32(p01[b]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)


def test_markov_fb_matches_brute_force_per_realization():
    """The JAX test's oracle (``tests/test_turbo_em.py``): s_post and s_corr
    equal exact enumeration over all 2^N supports, here for two
    realizations with their own (λ, p01), the chain along dim 1."""
    rng = np.random.default_rng(0)
    N = 6
    lams, p01s = (0.3, 0.15), (0.15, 0.4)
    pi_out = rng.uniform(0.05, 0.95, (2, N))
    _, s_post, s_corr = turbo_em.markov_fb(T(pi_out.astype(np.float32)), torch.tensor([[lams[0]], [lams[1]]]),
                                           torch.tensor([[p01s[0]], [p01s[1]]]), 1)
    for b, (lam, p01) in enumerate(zip(lams, p01s)):
        p10 = p01 * lam / (1 - lam)
        Tm = np.array([[1 - p10, p10], [p01, 1 - p01]])
        post, corr, Z = np.zeros(N), np.zeros(N - 1), 0.0
        for s in itertools.product([0, 1], repeat=N):
            w = lam if s[0] else 1 - lam
            for k in range(1, N):
                w *= Tm[s[k - 1], s[k]]
            w *= np.prod([pi_out[b, k] if s[k] else 1 - pi_out[b, k] for k in range(N)])
            Z += w
            post += w * np.asarray(s)
            corr += w * np.asarray(s[:-1]) * np.asarray(s[1:])
        np.testing.assert_allclose(s_post[b].numpy(), post / Z, atol=1e-5)
        np.testing.assert_allclose(s_corr[b].numpy(), corr / Z, atol=1e-5)


def test_gauss_markov_extrinsic_matches_jax_with_per_realization_parameters():
    """The AR(1) chain's extrinsic (eta, kappa) along the angle axis with
    alpha and sigma2 one per realization, against JAX's, rtol 1e-5."""
    rng = np.random.default_rng(4)
    r = _crandn(rng, NB, 12, 4)
    prec = rng.uniform(0.0, 5.0, (NB, 12, 4)).astype(np.float32)
    alpha = np.array([0.05, 0.3, 0.7], np.float32)
    sigma2 = np.array([0.5, 1.0, 4.0], np.float32)
    eta, kappa = turbo._gauss_markov_extrinsic(T(r), T(prec), T(alpha)[:, None, None], T(sigma2)[:, None, None], -2)
    for b in range(NB):
        we, wk = jturbo._gauss_markov_extrinsic(jnp.asarray(r[b]), jnp.asarray(prec[b]), jnp.float32(alpha[b]),
                                                jnp.float32(sigma2[b]))
        np.testing.assert_allclose(eta[b].numpy(), np.asarray(we), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(kappa[b].numpy(), np.asarray(wk), rtol=1e-5)


# -- the solvers per element -------------------------------------------------------------

KRON_SOLVERS = {
    # name: (arguments after (y, op), keyword arguments, the fields held to JAX)
    "turbo_markov_vamp": ((5.0, 100.0), dict(n_turbo=2, nit=10), ("x", "p1")),
    "turbo_mrf_vamp": ((5.0, 100.0), dict(n_turbo=2, nit=10), ("x", "p1")),
    "turbo_gauss_markov_vamp": ((5.0, 100.0), dict(n_turbo=2, nit=10), ("x", "p1")),
    "em_turbo_markov_vamp": ((5.0, 100.0), dict(n_em=2, nit=10), ("x", "p1", "p01", "lam")),
    "em_turbo_gauss_markov_vamp": ((100.0,), dict(n_em=2, nit=10), ("x", "alpha", "sigma2")),
}
VECTOR_SOLVERS = {
    "turbo_mrf3d_vamp": dict(shape3d=(4, 4, 4), n_turbo=2, nit=10),
    "turbo_mrf_arb_vamp": dict(coupling=0.8, field=-1.2, n_turbo=2, nit=10),
}


def _module(name):
    return (turbo, jturbo) if hasattr(turbo, name) else (turbo_em, jturbo_em)


def _asym_adjacency(n):
    """A ring with an extra one-way edge of weight 1/2: not symmetric."""
    adj = et.ring_adjacency(n)
    i = np.arange(n)
    adj[i, (i + 3) % n] = 0.5
    return adj


def _run_port(name, y, A, Bm=None):
    mod, _ = _module(name)
    if name in KRON_SOLVERS:
        args, kw, _ = KRON_SOLVERS[name]
        return getattr(mod, name)(T(y), KronDictOp(T(A), T(Bm)), *args, **kw)
    kw = dict(VECTOR_SOLVERS[name])
    extra = (T(_asym_adjacency(A.shape[-1])),) if name == "turbo_mrf_arb_vamp" else ()
    return getattr(mod, name)(T(y), MatrixOp(T(A)), 1.0, 1e3, *extra, **kw)


@pytest.mark.parametrize("name", sorted(KRON_SOLVERS) + sorted(VECTOR_SOLVERS))
def test_turbo_solver_matches_jax_per_element(name):
    """Each turbo solver's batch against JAX's calls, per element: x and
    every learned hyperparameter (p1, p01, λ, alpha, sigma2) within
    1e-3·max (measured ≤ 4e-5).  The support and amplitude chains run along
    the Gr axis of (3, 16, 4) coefficients on a ``KronDictOp``; the 3-D
    lattice (4, 4, 4) and the asymmetric adjacency on a ``MatrixOp``."""
    _, jmod = _module(name)
    if name in KRON_SOLVERS:
        A, Bm, _, Y = _kron_problems()
        got = _run_port(name, Y, A, Bm)
        args, kw, fields = KRON_SOLVERS[name]
        want = [getattr(jmod, name)(jnp.asarray(Y[b]), JKronDictOp(jnp.asarray(A[b]), jnp.asarray(Bm[b])), *args,
                                    **kw) for b in range(NB)]
    else:
        A, _, Y = _vector_problems()
        got = _run_port(name, Y, A)
        extra = (jnp.asarray(_asym_adjacency(A.shape[-1])),) if name == "turbo_mrf_arb_vamp" else ()
        want = [getattr(jmod, name)(jnp.asarray(Y[b]), JMatrixOp(jnp.asarray(A[b])), 1.0, 1e3, *extra,
                                    **VECTOR_SOLVERS[name]) for b in range(NB)]
        fields = ("x", "p1")
    for f in fields:
        w = np.stack([np.asarray(getattr(r, f)) for r in want])
        g = getattr(got, f).numpy()
        assert g.size == w.size, (f, g.shape, w.shape)
        assert _rel(g.reshape(w.shape), w) < 1e-3, f


@pytest.mark.parametrize("name", sorted(KRON_SOLVERS) + sorted(VECTOR_SOLVERS))
def test_turbo_solver_batch_order_leaves_each_realization_unchanged(name):
    """Reversing the batch reverses the results, to float32 roundoff
    (1e-5·max): no chain, reduction or keep-best choice runs over the
    batch axis."""
    if name in KRON_SOLVERS:
        A, Bm, _, Y = _kron_problems()
        fwd, rev = _run_port(name, Y, A, Bm), _run_port(name, Y[::-1].copy(), A[::-1].copy(), Bm[::-1].copy())
    else:
        A, _, Y = _vector_problems()
        fwd, rev = _run_port(name, Y, A), _run_port(name, Y[::-1].copy(), A[::-1].copy())
    for f, g in fwd._asdict().items():
        assert _rel(getattr(rev, f).flip(0).numpy(), g.numpy()) < 1e-5, f


# -- the JAX tests' recovery claims on the port ------------------------------------------


def _jax_block_sparse_problem(Gr=32, K=8, N=16, M=30, nv=5e-2):
    """``tests/test_turbo.py::_block_sparse_problem`` at its key, as numpy."""
    kA, kB, kx, kn = jax.random.split(jax.random.key(0), 4)
    A = jprng.complex_normal(kA, (N, Gr)) / np.sqrt(N)
    B = jprng.complex_normal(kB, (K, M)) / np.sqrt(K)
    sup = np.zeros((Gr, K), bool)
    rng = np.random.default_rng(0)
    for k in range(K):
        for _ in range(2):
            s = rng.integers(0, Gr - 5)
            sup[s: s + 5, k] = True
    beta = sup.mean()
    X = jnp.where(jnp.asarray(sup), jprng.complex_normal(kx, (Gr, K), var=1 / beta), 0.0)
    Y = A @ X @ B + jprng.complex_normal(kn, (N, M), var=nv)
    return (np.array(v) for v in (A, B, X, Y)), nv, beta, sup


def _iid_vamp(Y, op, beta, nv, nit=40):
    prior = estim.SparsePrior(estim.CAwgnPrior(0.0, torch.tensor(1 / beta, dtype=torch.float32)),
                              torch.tensor(beta, dtype=torch.float32))
    return vamp_slm(prior, Y, op, gamw=1.0 / nv, nit=nit)


def test_turbo_markov_beats_iid_prior_on_block_sparse():
    """``test_turbo_beats_iid_prior_on_block_sparse`` on the port: the
    Markov support smoother beats the iid spike-slab on two runs of 5 a
    column, and its activity map is higher on the true support."""
    (A, B, X, Y), nv, beta, sup = _jax_block_sparse_problem()
    op = KronDictOp(T(A)[None], T(B)[None])
    e_iid = _nmse_db(_iid_vamp(T(Y)[None], op, beta, nv).x, X)
    res = turbo.turbo_markov_vamp(T(Y)[None], op, 1 / beta, 1.0 / nv, p01=0.09, p10=0.2, n_turbo=6, nit=40)
    e_tb = _nmse_db(res.x, X)
    assert np.isfinite(e_tb) and e_tb < e_iid, (e_iid, e_tb)
    p1 = res.p1[0].numpy()
    assert p1[sup].mean() > p1[~sup].mean()


def test_turbo_gauss_markov_beats_iid_on_smooth_amplitudes():
    """``test_turbo_gauss_markov_beats_iid_on_smooth_amplitudes`` on the
    port: a dense AR(1) amplitude sequence, undersampled 2:1."""
    n, m, alpha, nv = 96, 48, 0.05, 1e-2
    a = 1 - alpha
    kA, kw, kn = jax.random.split(jax.random.key(0), 3)
    w = np.asarray(jprng.complex_normal(kw, (n,)))
    theta = np.zeros(n, np.complex64)
    th = w[0]
    for t in range(n):
        th = a * th + np.sqrt(1 - a * a) * w[t]
        theta[t] = th
    A = np.asarray(jprng.complex_normal(kA, (m, n))) / np.float32(np.sqrt(m))
    y = (A @ theta + np.asarray(jprng.complex_normal(kn, (m,), var=nv))).astype(np.complex64)
    op = MatrixOp(T(A)[None])
    e_iid = _nmse_db(_iid_vamp(T(y)[None], op, 1.0 - 1e-6, nv).x, theta)
    res = turbo.turbo_gauss_markov_vamp(T(y)[None], op, 1.0, 1.0 / nv, alpha=alpha, n_turbo=6, nit=40)
    e_gm = _nmse_db(res.x, theta)
    assert np.isfinite(e_gm) and e_gm < e_iid, (e_iid, e_gm)


def test_turbo_mrf_beats_iid_on_clustered_support():
    """``test_turbo_mrf_beats_iid_on_clustered_support`` on the port: three
    6×4 blobs on a 32×16 grid, the row + column chains against the iid
    prior."""
    kA, kB, kx, kn = jax.random.split(jax.random.key(0), 4)
    Gr, K, N, M, nv = 32, 16, 14, 28, 5e-2
    A = np.array(jprng.complex_normal(kA, (N, Gr)) / np.sqrt(N))
    B = np.array(jprng.complex_normal(kB, (K, M)) / np.sqrt(K))
    sup = np.zeros((Gr, K), bool)
    rng = np.random.default_rng(1)
    for _ in range(3):
        r0, c0 = rng.integers(0, Gr - 6), rng.integers(0, K - 4)
        sup[r0: r0 + 6, c0: c0 + 4] = True
    beta = sup.mean()
    X = np.array(jnp.where(jnp.asarray(sup), jprng.complex_normal(kx, (Gr, K), var=1 / beta), 0.0))
    Y = (A @ X @ B + np.asarray(jprng.complex_normal(kn, (N, M), var=nv))).astype(np.complex64)
    op = KronDictOp(T(A)[None], T(B)[None])
    e_iid = _nmse_db(_iid_vamp(T(Y)[None], op, beta, nv).x, X)
    res = turbo.turbo_mrf_vamp(T(Y)[None], op, 1 / beta, 1.0 / nv, p01=0.08, p10=0.25, n_turbo=6, nit=40)
    e_mrf = _nmse_db(res.x, X)
    assert np.isfinite(e_mrf) and e_mrf < e_iid, (e_iid, e_mrf)
    p1 = res.p1[0].numpy()
    assert p1[sup].mean() > p1[~sup].mean()


def test_em_turbo_markov_learns_hyperparams():
    """``test_em_markov_learns_hyperparams`` on the port: from (p01, λ) =
    (0.5, 0.5), NMSE < −25 dB, p01 < 0.3 (true 0.1) and λ within 0.05 of the
    support's share."""
    p = et.markov_support_problem(0, m=140, p01=0.1, lam=0.25)
    res = turbo_em.em_turbo_markov_vamp(T(p["y"])[None], MatrixOp(T(p["A"])[None]), 1.0, 1e3, p01_init=0.5,
                                        lam_init=0.5, n_em=10)
    assert _nmse_db(res.x, p["x"]) < -25.0
    assert float(res.p01) < 0.3
    assert abs(float(res.lam) - p["s"].mean()) < 0.05


def test_em_turbo_gauss_markov_learns_hyperparams():
    """``test_em_gauss_markov_learns_hyperparams`` on the port: NMSE < −8 dB
    on a dense AR(1), alpha moves from 0.6 below 0.35 (true 0.1), sigma2
    from 3.0 into (0.5, 2.0) (true 1.0)."""
    rng = np.random.default_rng(3)
    n, m, wvar = 256, 140, 1e-3
    a = 1 - 0.1
    q = 1 - a * a
    th = np.zeros(n, complex)
    th[0] = np.sqrt(1 / 2) * (rng.standard_normal() + 1j * rng.standard_normal())
    for i in range(1, n):
        th[i] = a * th[i - 1] + np.sqrt(q / 2) * (rng.standard_normal() + 1j * rng.standard_normal())
    A = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))) / np.sqrt(2 * m)
    y = A @ th + np.sqrt(wvar / 2) * (rng.standard_normal(m) + 1j * rng.standard_normal(m))
    r = turbo_em.em_turbo_gauss_markov_vamp(T(y.astype(np.complex64))[None], MatrixOp(T(A.astype(np.complex64))[None]),
                                            1 / wvar, alpha_init=0.6, sigma2_init=3.0, n_em=12)
    assert _nmse_db(r.x, th) < -8.0
    assert float(r.alpha) < 0.35
    assert 0.5 < float(r.sigma2) < 2.0


def test_mrf3d_recovers_clustered_support():
    """``test_mrf3d_recovers_clustered_support`` on the port: NMSE < −15 dB."""
    p = et.clustered_3d_problem(4)
    res = turbo_em.turbo_mrf3d_vamp(T(p["y"])[None], MatrixOp(T(p["A"])[None]), 1.0, 1e3, shape3d=(8, 8, 4))
    assert _nmse_db(res.x, p["x"]) < -15.0


def test_mrf_arb_ring_adjacency():
    """``test_mrf_arb_ring_adjacency`` on the port: the ring MRF recovers a
    clustered 1-D support from 120 measurements, NMSE < −20 dB."""
    p = et.markov_support_problem(5, p01=0.08, lam=0.2, m=120)
    res = turbo_em.turbo_mrf_arb_vamp(T(p["y"])[None], MatrixOp(T(p["A"])[None]), 1.0, 1e3,
                                      T(et.ring_adjacency(256)), coupling=0.8, field=-1.2)
    assert _nmse_db(res.x, p["x"]) < -20.0
