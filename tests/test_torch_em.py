"""The port's ``KronDictOp`` made whole and its EM solvers
(``solvers/em.py``) against the JAX package on the same numpy inputs:
``sq_mv``, ``sq_rmv``, ``gram``, ``gram_out``, ``pinv_rmv`` and
``materialize`` per realization (rtol 1e-5), no operator class missing a
public method of its JAX counterpart, each EM solver per element over a
short horizon (2 EM rounds of 10 inner iterations: x and every learned
hyperparameter within 1e-3·max), the batch order, the JAX tests' recovery
claims on the port, and JAX's learned priors carried across by
``interop``.  The port solves a batch of problems in one call; JAX solves
each in its own call."""
import ast
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.core import prng as jprng  # noqa: E402
from jstsp19_tpu.ops import KronDictOp as JKronDictOp, MatrixOp as JMatrixOp  # noqa: E402
from jstsp19_tpu.ops.fourier import FWHTOp as JFWHTOp  # noqa: E402
from jstsp19_tpu.ops.structured import SubsetOp as JSubsetOp  # noqa: E402
from jstsp19_tpu.solvers import em as jem  # noqa: E402
from jstsp19_torch import interop  # noqa: E402
from jstsp19_torch.harness import hadamard_cs as hcs  # noqa: E402
from jstsp19_torch.ops.base import MatrixOp  # noqa: E402
from jstsp19_torch.ops.fourier import FWHTOp  # noqa: E402
from jstsp19_torch.ops.kron import KronDictOp  # noqa: E402
from jstsp19_torch.ops.structured import SubsetOp  # noqa: E402
from jstsp19_torch.solvers import em  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
T = torch.from_numpy
NB = 3  # realizations in the per-element checks
SHORT = dict(n_em=2, nit=10)


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


def _kron_problems(B=NB, seed=0, Gr=16, K=4, N=20, M=8, beta=0.2, nv=1e-2):
    """B spike-slab problems y = A·X·B + CN(0, nv) with full-rank Grams."""
    rng = np.random.default_rng(seed)
    A = _crandn(rng, B, N, Gr, var=1 / N)
    Bm = _crandn(rng, B, K, M, var=1 / K)
    X = np.where(rng.random((B, Gr, K)) < beta, _crandn(rng, B, Gr, K, var=1 / beta), 0).astype(np.complex64)
    Y = (A @ X @ Bm + _crandn(rng, B, N, M, var=nv)).astype(np.complex64)
    return A, Bm, X, Y


# -- KronDictOp made whole --------------------------------------------------------------

KRON_METHODS = ("sq_mv", "sq_rmv", "gram", "gram_out", "pinv_rmv", "materialize")


@pytest.mark.parametrize("shared", [False, True], ids=["per-realization", "shared"])
@pytest.mark.parametrize("method", KRON_METHODS)
def test_kron_dict_op_method_matches_jax(method, shared):
    """Each of the six methods on a batch of 3 against JAX's per
    realization, rtol 1e-5: A (3, 6, 5) and B (3, 2, 7), or one shared pair;
    |·| inputs for the squared-magnitude pair, a rank-deficient A for
    ``pinv_rmv`` (its cutoff is JAX's 10·max(rows, cols)·eps)."""
    rng = np.random.default_rng(5)
    A, Bm = _crandn(rng, NB, 6, 5), _crandn(rng, NB, 2, 7)
    if method == "pinv_rmv":
        A[..., -1] = A[..., 0]  # rank 4: the cutoff matters
    if shared:
        A, Bm = A[:1].repeat(NB, 0), Bm[:1].repeat(NB, 0)
    op = KronDictOp(T(A[0]) if shared else T(A), T(Bm[0]) if shared else T(Bm))
    arg = {"sq_mv": np.abs(_crandn(rng, NB, 5, 2)), "sq_rmv": np.abs(_crandn(rng, NB, 6, 7)),
           "gram": _crandn(rng, NB, 5, 2), "gram_out": _crandn(rng, NB, 6, 7), "pinv_rmv": _crandn(rng, NB, 6, 7)}
    for b in range(NB):
        jop = JKronDictOp(jnp.asarray(A[b]), jnp.asarray(Bm[b]))
        if method == "materialize":
            got = op.materialize().numpy()
            got, want = (got if shared else got[b]), np.asarray(jop.materialize())
        else:
            got = getattr(op, method)(T(arg[method])).numpy()[b]
            want = np.asarray(getattr(jop, method)(jnp.asarray(arg[method][b])))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_kron_dict_op_mv_is_materialized_product():
    """``mv(S)`` equals ``materialize() @ vec(S)`` (column-major vec, the
    reference's kron(B.', A)) per realization, and ``rmv`` its adjoint."""
    rng = np.random.default_rng(6)
    A, Bm, S = _crandn(rng, NB, 6, 5), _crandn(rng, NB, 2, 7), _crandn(rng, NB, 5, 2)
    op = KronDictOp(T(A), T(Bm))
    K2 = op.materialize().numpy()
    vec = S.transpose(0, 2, 1).reshape(NB, -1)
    want = np.einsum("bij,bj->bi", K2, vec).reshape(NB, 7, 6).transpose(0, 2, 1)
    np.testing.assert_allclose(op.mv(T(S)).numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    Y = _crandn(rng, NB, 6, 7)
    want = np.einsum("bji,bj->bi", K2.conj(), Y.transpose(0, 2, 1).reshape(NB, -1)).reshape(NB, 2, 5).transpose(0, 2, 1)
    np.testing.assert_allclose(op.rmv(T(Y)).numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _public_methods(directory: pathlib.Path):
    """{class: its public method and property names} over the modules of
    ``directory``, read from the source (nothing is imported)."""
    out = {}
    for f in directory.glob("*.py"):
        for node in ast.parse(f.read_text()).body:
            if isinstance(node, ast.ClassDef):
                out[node.name] = {n.name for n in node.body
                                  if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")}
    return out


def test_every_operator_class_has_its_jax_counterparts_public_methods():
    """An AST comparison of the two packages' ``ops/``: every operator
    class of the JAX package is in the port, and each defines every public
    method its JAX counterpart defines (an inherited ``LinOp`` stub raises,
    so it does not count)."""
    jax_ops = _public_methods(ROOT / "jstsp19_tpu" / "ops")
    port_ops = _public_methods(ROOT / "jstsp19_torch" / "ops")
    assert len(jax_ops) > 20
    missing = {name: sorted(methods - port_ops.get(name, set())) for name, methods in jax_ops.items()}
    assert not {k: v for k, v in missing.items() if v or k not in port_ops}


def test_matrix_op_eigenbasis_maps_a_batch_of_vectors():
    """``MatrixOp``'s eigenbasis maps (VAMP-SLM's LMMSE stage) act on each
    vector of a batch, with one matrix per realization or one shared: the
    round trip is the identity and ``to_eigbasis`` matches JAX's per
    realization (1e-5)."""
    rng = np.random.default_rng(7)
    A, x = _crandn(rng, NB, 12, 8), _crandn(rng, NB, 8)
    for a in (A, A[0]):
        op = MatrixOp(T(a))
        V, Vb, _ = op.gram_in_eig()
        xt = op.to_eigbasis(V, Vb, T(x))
        assert _rel(op.from_eigbasis(V, Vb, xt).numpy(), x) < 1e-5
        for b in range(NB):
            jop = JMatrixOp(jnp.asarray(a[b] if a.ndim == 3 else a))
            Vj, _, _ = jop.gram_in_eig()
            want = np.asarray(jop.to_eigbasis(Vj, None, jnp.asarray(x[b])))
            # eigenvectors are unique up to a phase each: compare magnitudes
            assert _rel(np.abs(xt[b].numpy()), np.abs(want)) < 1e-4


# -- the EM solvers per element -------------------------------------------------------------


def _nngm_problems():
    """3 non-negative partial-Hadamard problems at n = 256 on one row set
    (so that JAX compiles its static-index operator once)."""
    prob = hcs.hadamard_cs_problem(batch=NB, n=256, nonneg=True)
    prob["idx"] = prob["idx"][:1].repeat(NB, 0)
    return prob


def _port_solve(name, kw=SHORT, flip=False):
    take = (lambda v: v[::-1].copy()) if flip else (lambda v: v)
    if name == "em_nngm_gamp":
        p = _nngm_problems()
        op = SubsetOp(FWHTOp(256), T(p["idx"][0]))
        return em.em_nngm_gamp(T(take(p["y"])), op, **kw)
    A, Bm, _, Y = _kron_problems()
    return getattr(em, name)(T(take(Y)), KronDictOp(T(take(A)), T(take(Bm))), **kw)


def _jax_solves(name, kw=SHORT):
    if name == "em_nngm_gamp":
        p = _nngm_problems()
        op = JSubsetOp(JFWHTOp(256), tuple(int(i) for i in p["idx"][0]))
        return [jem.em_nngm_gamp(jnp.asarray(p["y"][b]), op, **kw) for b in range(NB)]
    A, Bm, _, Y = _kron_problems()
    return [getattr(jem, name)(jnp.asarray(Y[b]), JKronDictOp(jnp.asarray(A[b]), jnp.asarray(Bm[b])), **kw)
            for b in range(NB)]


def _learned(res, name):
    """{field: array} of everything a result learned."""
    prior = res.prior if name == "em_nngm_gamp" else res.prior.base
    out = {"x": res.x, "noise_var": res.noise_var, "p1": res.prior.p1}
    if name == "em_bg_vamp":
        out["var0"] = prior.var0
    else:
        out.update(weights=prior.weights, means=prior.means, variances=prior.variances)
    return out


EM_SOLVERS = ("em_bg_vamp", "em_gm_vamp", "em_nngm_gamp")


@pytest.mark.parametrize("name", EM_SOLVERS)
def test_em_solver_matches_jax_per_element(name):
    """Each EM solver's batch against JAX's calls, per element: x, the noise
    variance, the activity and the slab variance or the mixture's weights,
    means and variances within 1e-3·max (measured ≤ 2e-5).  em_bg_vamp and
    em_gm_vamp on a ``KronDictOp`` (3, 16, 4), em_nngm_gamp through
    ``SubsetOp(FWHTOp(256))`` (the FWHT's plain version here)."""
    got = _learned(_port_solve(name), name)
    want = [_learned(r, name) for r in _jax_solves(name)]
    for f, g in got.items():
        w = np.stack([np.asarray(r[f]) for r in want])
        g = g.numpy()
        assert g.size == w.size, (f, g.shape, w.shape)
        assert _rel(g.reshape(w.shape), w) < 1e-3, f


@pytest.mark.parametrize("name", EM_SOLVERS)
def test_em_solver_batch_order_leaves_each_realization_unchanged(name):
    """Reversing the batch reverses x and every learned hyperparameter, to
    float32 roundoff (1e-5·max): no reduction runs over the batch axis."""
    fwd = _learned(_port_solve(name), name)
    rev = _learned(_port_solve(name, flip=True), name)
    for f, g in fwd.items():
        assert _rel(rev[f].flip(0).numpy(), g.numpy()) < 1e-5, f


def test_em_learned_shapes_are_one_per_realization():
    """The learned hyperparameters carry one value per realization: noise
    variance and p1 (B, 1, 1) on a ``KronDictOp``, the mixture (B, 1, 1, 3);
    on GAMP's vector problem the noise variance (B, 1) against the
    measurements and the mixture (B, 1, 3)."""
    gm = _port_solve("em_gm_vamp")
    assert gm.noise_var.shape == gm.prior.p1.shape == (NB, 1, 1)
    assert gm.prior.base.weights.shape == gm.prior.base.variances.shape == (NB, 1, 1, 3)
    nn = _port_solve("em_nngm_gamp")
    assert nn.noise_var.shape == nn.prior.p1.shape == (NB, 1)
    assert nn.prior.weights.shape == nn.prior.means.shape == (NB, 1, 3)
    assert abs(float(nn.prior.weights.sum(-1).max()) - 1.0) < 1e-6


# -- the JAX tests' recovery claims on the port ------------------------------------------


def test_em_bg_vamp_learns_noise_and_sparsity():
    """``test_em_bg_vamp_learns_noise_and_sparsity`` on the port, at that
    test's key: NMSE < 1e-2, the noise variance within 0.3×-3× of the truth,
    the activity in (0.03, 0.3)."""
    key = jax.random.key(0)
    N_, Gr, K, M_ = 24, 16, 8, 30
    A = jprng.complex_normal(jax.random.fold_in(key, 0), (N_, Gr)) / np.sqrt(N_)
    B = jprng.complex_normal(jax.random.fold_in(key, 1), (K, M_)) / np.sqrt(K)
    beta, nv_true = 0.1, 0.005
    act = jax.random.uniform(jax.random.fold_in(key, 2), (Gr, K)) < beta
    X = jnp.where(act, jprng.complex_normal(jax.random.fold_in(key, 3), (Gr, K), var=1 / beta), 0.0)
    Y = A @ X @ B + jprng.complex_normal(jax.random.fold_in(key, 4), (N_, M_), var=nv_true)
    A, B, X, Y = (np.array(v) for v in (A, B, X, Y))
    res = em.em_bg_vamp(T(Y)[None], KronDictOp(T(A)[None], T(B)[None]), n_em=10, nit=40)
    nmse = float(((res.x[0].numpy() - X) ** 2).__abs__().sum() / (np.abs(X) ** 2).sum())
    assert nmse < 1e-2, nmse
    assert 0.3 * nv_true < float(res.noise_var) < 3 * nv_true
    assert 0.03 < float(res.prior.p1) < 0.3


def test_em_gm_vamp_learns_mixture():
    """``test_em_gm_vamp_learns_mixture`` on the port: two-scale GM
    amplitudes, everything learned; NMSE < 0.02, activity in (0.02, 0.2),
    noise variance within 0.2×-5×."""
    key = jax.random.key(3)
    m, n, beta = 200, 400, 0.06
    A = jprng.complex_normal(jax.random.fold_in(key, 0), (m, n)) / np.sqrt(m)
    act = jax.random.uniform(jax.random.fold_in(key, 1), (n,)) < beta
    big = jax.random.uniform(jax.random.fold_in(key, 2), (n,)) < 0.5
    x = jnp.where(act, jnp.where(big, 3.0, 0.5) * jprng.complex_normal(jax.random.fold_in(key, 3), (n,)), 0.0)
    nv_true = 1e-3 * float(jnp.mean(jnp.abs(x) ** 2)) * n / m
    y = A @ x + jprng.complex_normal(jax.random.fold_in(key, 4), (m,), var=nv_true)
    A, x, y = (np.array(v) for v in (A, x, y))
    res = em.em_gm_vamp(T(y)[None], MatrixOp(T(A)[None]), n_components=3, n_em=10, nit=40)
    nmse = float((np.abs(res.x[0].numpy() - x) ** 2).sum() / (np.abs(x) ** 2).sum())
    assert nmse < 0.02, nmse
    assert 0.02 < float(res.prior.p1) < 0.2
    assert 0.2 * nv_true < float(res.noise_var) < 5 * nv_true


def test_em_nngm_gamp_recovers_nonnegative():
    """``test_em_nngm_gamp_recovers_nonnegative`` on the port: a real
    non-negative sparse signal, no hand-tuned hyperparameters; NMSE < 0.03,
    min x > −1e-3."""
    key = jax.random.key(7)
    m, n, k = 160, 320, 16
    A = (jax.random.normal(jax.random.fold_in(key, 0), (m, n)) / np.sqrt(m)).astype(jnp.float32)
    idx = jax.random.choice(jax.random.fold_in(key, 1), n, (k,), replace=False)
    vals = jnp.abs(jax.random.normal(jax.random.fold_in(key, 2), (k,))) + 0.5
    x = jnp.zeros((n,), jnp.float32).at[idx].set(vals)
    nv_true = 1e-4 * float(jnp.mean((A @ x) ** 2)) * m
    y = A @ x + jnp.sqrt(nv_true) * jax.random.normal(jax.random.fold_in(key, 3), (m,))
    A, x, y = (np.array(v) for v in (A, x, y))
    res = em.em_nngm_gamp(T(y)[None], MatrixOp(T(A)[None]), n_components=3, n_em=10, nit=40)
    assert not res.x.is_complex()
    nmse = float(((res.x[0].numpy() - x) ** 2).sum() / (x**2).sum())
    assert nmse < 0.03, nmse
    assert float(res.x.min()) > -1e-3


# -- learned priors carried across ------------------------------------------------------------


@pytest.mark.parametrize("name", ["em_gm_vamp", "em_nngm_gamp"])
def test_learned_prior_round_trips_through_interop(name):
    """JAX's learned ``SparsePrior(CGMPrior)`` (em_gm_vamp) and ``NNGMPrior``
    (em_nngm_gamp) become the port's through ``estimator_to_torch``, survive
    ``estimator_to_numpy`` and back unchanged, and the port's ``estim`` on
    them matches JAX's (1e-5·max) on the same inputs."""
    jprior = _jax_solves(name)[0].prior
    port = interop.estimator_to_torch(jprior)
    again = interop.estimator_to_torch(interop.estimator_to_numpy(port))
    rng = np.random.default_rng(8)
    if name == "em_gm_vamp":
        r, rvar = _crandn(rng, 64), rng.uniform(0.01, 1.0, 64).astype(np.float32)
    else:
        r, rvar = rng.standard_normal(64).astype(np.float32), rng.uniform(1e-3, 0.1, 64).astype(np.float32)
    want = jprior.estim(jnp.asarray(r), jnp.asarray(rvar))
    for est in (port, again):
        for g, w in zip(est.estim(T(r), T(rvar)), want):
            assert _rel(g.numpy(), w) < 1e-5
