"""The port's l1 beamspace ADMM (``solvers/sparse.py::sparse_admm``), the rest
of the operators (``ConcatOp``, ``BlockDiagOp``, ``CenterOp``, ``TVOp``,
``HaarOp``, ``MedImageOp``, ``FxnhandleOp``, the random constructors,
``rbf_kernel_op``, ``genie_normal_matvec``) and ``utils/distributions.py``
against the JAX package on the same numpy inputs.  Tolerances are stated at
each test: the deterministic operators to float32 roundoff (1e-5 relative),
the ADMM per element over 20 iterations, the random constructors exactly in
their structure and at the ensemble level in their distribution."""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu import ops as jops  # noqa: E402
from jstsp19_tpu.ops.structured import fxnhandle_op as jfxnhandle_op  # noqa: E402
from jstsp19_tpu.solvers.sparse import sparse_admm as jsparse_admm  # noqa: E402
from jstsp19_tpu.utils import DisDist as JDisDist, weibull_grid as jweibull_grid  # noqa: E402
from jstsp19_torch import interop, ops  # noqa: E402
from jstsp19_torch.harness import amp_sparse as aps  # noqa: E402
from jstsp19_torch.ops.structured import FxnhandleOp, fxnhandle_op  # noqa: E402
from jstsp19_torch.solvers.sparse import sparse_admm  # noqa: E402
from jstsp19_torch.utils import DisDist, weibull_grid  # noqa: E402

T = torch.from_numpy


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


def _vdot(a, b):
    return complex((np.conj(np.asarray(a, np.complex128)) * np.asarray(b, np.complex128)).sum())


# -- sparse_admm ------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("per_realization", [False, True])
def test_sparse_admm_matches_jax_per_element(use_kernels, per_realization):
    """Three beamspace problems at the canonical shapes (32×4), 20 iterations,
    both routes (on the CPU the kernel route takes the wrappers' plain
    versions), the dictionaries shared or one per realization: S and the
    NMSE per iteration within 1e-4 of JAX's (relative to max|S|; measured
    ~1e-6; 20 iterations is where the soft threshold has set the support
    and the iterates still move)."""
    bp = aps.beamspace_problem(batch=3)
    Dr, Dt = T(bp["Dr"]), T(bp["Dt"])
    if per_realization:
        Dr, Dt = Dr.expand(3, 32, 32).clone(), Dt.expand(3, 4, 4).clone()
    S, errs = sparse_admm(T(bp["H"]), T(bp["OH"]), Dr, Dt, 20, use_kernels=use_kernels)
    assert S.shape == (3, 32, 4) and errs.shape == (3, 20)
    for b in range(3):
        jS, jerrs = jsparse_admm(jnp.asarray(bp["H"][b]), jnp.asarray(bp["OH"][b]), jnp.asarray(bp["Dr"]),
                                 jnp.asarray(bp["Dt"]), 20)
        assert _rel(S[b].numpy(), jS) < 1e-4
        np.testing.assert_allclose(errs[b].numpy(), np.asarray(jerrs), rtol=1e-4)


def test_sparse_admm_recovers_sparse_beamspace():
    """The JAX package's test (``tests/test_solvers_lowrank.py``) on the port:
    a two-atom beamspace channel (16×8 unitary DFT dictionaries) is recovered
    to NMSE < 0.05 in 100 iterations, on both routes alike."""
    from jstsp19_torch.channel.widemmwave import dft_dictionary

    Mr, Mt = 16, 8
    Dr = dft_dictionary(Mr, Mr) * math.sqrt(Mr)
    Dt = dft_dictionary(Mt, Mt) * math.sqrt(Mt)
    S_true = torch.zeros(1, Mr, Mt, dtype=torch.complex64)
    S_true[0, 3, 2], S_true[0, 10, 5] = 2.0 + 1j, -1.5 + 0.5j
    H = Dr @ S_true @ Dt.mH
    for use_kernels in (True, False):
        S, errs = sparse_admm(H, H, Dr, Dt, 100, use_kernels=use_kernels)
        assert float(((S - S_true).abs() ** 2).sum() / (S_true.abs() ** 2).sum()) < 0.05
        assert float(errs[0, -1]) < 0.05


# -- ConcatOp and BlockDiagOp ------------------------------------------------------------------


def test_concat_and_blockdiag_match_jax():
    """Forward, adjoint and variance maps against JAX's on the same inputs to
    1e-5 relative, with a batch of two inputs on the port's side; the
    adjoint identity over the stacked output to 1e-4."""
    rng = np.random.default_rng(0)
    A1, A2 = _crandn(rng, 6, 4), _crandn(rng, 3, 4)
    jop = jops.ConcatOp((jops.MatrixOp(jnp.asarray(A1)), jops.MatrixOp(jnp.asarray(A2))))
    op = ops.ConcatOp((ops.MatrixOp(T(A1)), ops.MatrixOp(T(A2))))
    assert op.in_shape == (4,) and op.out_shape == ((6,), (3,))
    x, ys = _crandn(rng, 2, 4), (_crandn(rng, 2, 6), _crandn(rng, 2, 3))
    for b in range(2):
        for got, want in zip([t[b] for t in op.mv(T(x))], jop.mv(jnp.asarray(x[b]))):
            assert _rel(got.numpy(), want) < 1e-5
        assert _rel(op.rmv(tuple(T(y) for y in ys))[b].numpy(), jop.rmv(tuple(jnp.asarray(y[b]) for y in ys))) < 1e-5
        v = np.abs(x[b]).astype(np.float32)
        for got, want in zip(op.sq_mv(T(v)), jop.sq_mv(jnp.asarray(v))):
            assert _rel(got.numpy(), want) < 1e-5
    y1, y2 = op.mv(T(x))
    lhs = _vdot(ys[0], y1.numpy()) + _vdot(ys[1], y2.numpy())
    assert abs(lhs - _vdot(op.rmv(tuple(T(y) for y in ys)).numpy(), x)) < 1e-4 * (1 + abs(lhs))
    sq = op.sq_rmv((T(np.abs(ys[0][0])), T(np.abs(ys[1][0]))))
    assert _rel(sq.numpy(), jop.sq_rmv((jnp.abs(jnp.asarray(ys[0][0])), jnp.abs(jnp.asarray(ys[1][0]))))) < 1e-5

    A = _crandn(rng, 3, 5, 4)
    jbd, bd = jops.BlockDiagOp(jnp.asarray(A)), ops.BlockDiagOp(T(A))
    assert bd.in_shape == (3, 4) and bd.out_shape == (3, 5)
    xb, yb = _crandn(rng, 2, 3, 4), _crandn(rng, 2, 3, 5)
    for b in range(2):
        assert _rel(bd.mv(T(xb))[b].numpy(), jbd.mv(jnp.asarray(xb[b]))) < 1e-5
        assert _rel(bd.rmv(T(yb))[b].numpy(), jbd.rmv(jnp.asarray(yb[b]))) < 1e-5
        v = np.abs(xb[b]).astype(np.float32)
        assert _rel(bd.sq_mv(T(v)).numpy(), jbd.sq_mv(jnp.asarray(v))) < 1e-5
        w = np.abs(yb[b]).astype(np.float32)
        assert _rel(bd.sq_rmv(T(w)).numpy(), jbd.sq_rmv(jnp.asarray(w))) < 1e-5


# -- CenterOp, TVOp, HaarOp, MedImageOp --------------------------------------------------------

MAPS = ("mv", "rmv", "sq_mv", "sq_rmv")


def _pair(name, rng):
    """(port op, JAX op) of one kind at a small size."""
    if name == "center":
        return ops.CenterOp(6), jops.CenterOp(6)
    if name == "tv9":
        return ops.TVOp(9), jops.TVOp(9)
    if name == "tv2":
        return ops.TVOp(2), jops.TVOp(2)
    if name.startswith("haar"):
        n, lv = {"haar8_1": (8, 1), "haar8_3": (8, 3), "haar32_4": (32, 4)}[name]
        return ops.HaarOp(n, lv), jops.HaarOp(n, lv)
    idx = np.sort(rng.choice(256, 100, False))
    return ops.MedImageOp(16, 16, 3, T(idx)), jops.MedImageOp(16, 16, 3, tuple(int(i) for i in idx))


@pytest.mark.parametrize("name", ["center", "tv9", "tv2", "haar8_1", "haar8_3", "haar32_4", "medimage"])
def test_structured_op_matches_jax_and_is_adjoint(name):
    """Every map against JAX's on the same inputs (a batch of two on the
    port's side) to 1e-5 relative, the adjoint identity to 1e-4, and the
    variance maps against the densified |A|² (the exact maps; MedImageOp's
    Frobenius approximation against JAX's)."""
    rng = np.random.default_rng(1)
    op, jop = _pair(name, rng)
    (n,), (m,) = op.in_shape, op.out_shape
    x, y = _crandn(rng, 2, n), _crandn(rng, 2, m)
    xv, yv = rng.random((2, n)).astype(np.float32), rng.random((2, m)).astype(np.float32)
    for fn, arg in zip(MAPS, (x, y, xv, yv)):
        got = getattr(op, fn)(T(arg)).numpy()
        for b in range(2):
            assert _rel(got[b], getattr(jop, fn)(jnp.asarray(arg[b]))) < 1e-5, fn
    lhs = _vdot(y[0], op.mv(T(x[0])).numpy())
    assert abs(lhs - _vdot(op.rmv(T(y[0])).numpy(), x[0])) < 1e-4 * max(1.0, abs(lhs))
    if name != "medimage":
        A = op.mv(torch.eye(n, dtype=torch.complex64)).numpy().T  # columns are A·e_j
        np.testing.assert_allclose(op.sq_mv(T(xv[0])).numpy(), np.abs(A) ** 2 @ xv[0], atol=1e-4)
        np.testing.assert_allclose(op.sq_rmv(T(yv[0])).numpy(), (np.abs(A) ** 2).T @ yv[0], atol=1e-4)


def test_structured_ops_keep_their_contracts():
    """The JAX package's contract tests on the port: the centering sums to
    zero, TV of a ramp is 1, Haar is orthonormal with constants on the
    approximation, the full-mask MedImageOp is unitary and its analysis
    inverts its synthesis."""
    rng = np.random.default_rng(2)
    x = T(_crandn(rng, 6))
    assert abs(complex(ops.CenterOp(6).mv(x).sum())) < 1e-5
    np.testing.assert_allclose(ops.TVOp(9).mv(torch.arange(9.0)).numpy(), 1.0)
    for n, lv in ((8, 1), (8, 3), (32, 4)):
        op, x = ops.HaarOp(n, lv), T(_crandn(rng, n))
        y = op.mv(x)
        assert float(y.abs().norm()) == pytest.approx(float(x.abs().norm()), rel=1e-5)
        np.testing.assert_allclose(op.rmv(y).numpy(), x.numpy(), atol=1e-5)
        np.testing.assert_allclose(op.mv(torch.ones(n, dtype=torch.complex64))[n >> lv:].numpy(), 0.0, atol=1e-6)
    with pytest.raises(ValueError):
        ops.HaarOp(12, 1)
    full = ops.MedImageOp(16, 16, 3, torch.arange(256))
    x = T(_crandn(rng, 256))
    assert float(full.mv(x).norm() / x.norm()) == pytest.approx(1.0, abs=1e-5)
    c = x.reshape(16, 16)
    np.testing.assert_allclose(full._analysis(full._synthesis(c)).numpy(), c.numpy(), atol=1e-5)
    with pytest.raises(ValueError):
        ops.MedImageOp(16, 16, 5, torch.arange(4))


def test_medimage_adjoint_accumulates_repeated_samples():
    """A k-space index given twice adds twice in the adjoint (``index_add_``),
    as JAX's ``.at[].add``."""
    idx = np.array([3, 3, 17], np.int64)
    op, jop = ops.MedImageOp(8, 8, 2, T(idx)), jops.MedImageOp(8, 8, 2, (3, 3, 17))
    z = _crandn(np.random.default_rng(3), 3)
    assert _rel(op.rmv(T(z)).numpy(), jop.rmv(jnp.asarray(z))) < 1e-5


# -- FxnhandleOp and the constructors ------------------------------------------------------------


def test_fxnhandle_op_matches_jax_and_probes_at_the_ensemble_level():
    """With ‖A‖²_F given, the maps equal JAX's (1e-5 relative) with a batch
    of two; probed with a generator (64 probes), the estimate lies within
    Monte-Carlo reach of the truth (0.6-1.5×, as JAX's test); the rank-1
    variance map integrates to ‖A‖²_F·mean."""
    rng = np.random.default_rng(8)
    A = _crandn(rng, 24, 40, var=2.0)
    fro2 = float((np.abs(A) ** 2).sum())
    At, Aj = T(A), jnp.asarray(A)
    op = fxnhandle_op(lambda v: v @ At.T, lambda u: u @ At.conj(), (40,), (24,), fro2=fro2)
    jop = jfxnhandle_op(lambda v: Aj @ v, lambda u: Aj.conj().T @ u, (40,), (24,), fro2=fro2)
    x, u = _crandn(rng, 2, 40), _crandn(rng, 2, 24)
    xv, uv = rng.random((2, 40)).astype(np.float32), rng.random((2, 24)).astype(np.float32)
    for fn, arg in zip(MAPS, (x, u, xv, uv)):
        got = getattr(op, fn)(T(arg)).numpy()
        for b in range(2):
            assert _rel(got[b], getattr(jop, fn)(jnp.asarray(arg[b]))) < 1e-5, fn
    op = fxnhandle_op(lambda v: At @ v, lambda w: At.mH @ w, (40,), (24,), key=torch.Generator().manual_seed(3),
                      n_probe=64)
    assert isinstance(op, FxnhandleOp) and 0.6 * fro2 < float(op.fro2) < 1.5 * fro2
    assert float(op.sq_mv(torch.ones(40)).sum()) == pytest.approx(float(op.fro2), rel=1e-4)
    assert fxnhandle_op(lambda v: v, lambda v: v, (3,), (3,), device="cpu").fro2 > 0


def test_random_unitary_op_structure_and_distribution():
    """Unitary to float32 roundoff; the phase fix makes the diagonal of
    Qᴴ·G (R) real and positive for the Gaussian G drawn from the same
    generator state; over 50 draws E|Q_ij|² = 1/n within 4 standard errors."""
    g = torch.Generator().manual_seed(1)
    state = g.get_state()
    Q = ops.random_unitary_op(g, 12).A
    np.testing.assert_allclose((Q.mH @ Q).numpy(), np.eye(12), atol=1e-5)
    g.set_state(state)
    G = torch.randn(12, 12, generator=g, dtype=torch.complex64)
    d = torch.diagonal(Q.mH @ G)
    assert float(d.imag.abs().max()) < 1e-4 and float(d.real.min()) > 0
    e = torch.stack([ops.random_unitary_op(g, 8).A.abs() ** 2 for _ in range(50)]).double()
    assert abs(float(e.mean()) - 1 / 8) < 4 * float(e.std()) / math.sqrt(e.numel())


@pytest.mark.parametrize("signed", [False, True])
def test_sparse_random_ops_structure_and_distribution(signed):
    """``expander_graph_op`` and ``sparse_signed_op``: exactly d nonzeros a
    column at distinct rows, the values 1/√d (unit column norms) or
    ±√(nz/(d·nx)); over the whole matrix each row is hit d·n/m times on
    average (within 4 standard errors) and, for the signs, half are
    positive; the adjoint contract holds."""
    m, n, d = 64, 400, 5
    g = torch.Generator().manual_seed(7)
    A = (ops.sparse_signed_op(g, m, n, d) if signed else ops.expander_graph_op(g, m, n, d)).A.numpy()
    assert A.shape == (m, n) and A.dtype == np.float32
    np.testing.assert_array_equal((A != 0).sum(0), d)
    scale = math.sqrt(m / (d * n)) if signed else 1 / math.sqrt(d)
    np.testing.assert_allclose(np.abs(A[A != 0]), scale, rtol=1e-6)
    if not signed:
        np.testing.assert_allclose(np.linalg.norm(A, axis=0), 1.0, atol=1e-6)
    hits = (A != 0).sum(1)
    p = d / m
    assert abs(hits.mean() - n * p) < 1e-9 and hits.std() < 4 * math.sqrt(n * p * (1 - p))
    if signed:
        pos = float((A > 0).sum()) / (n * d)
        assert abs(pos - 0.5) < 4 * math.sqrt(0.25 / (n * d))
    op = ops.MatrixOp(T(A))
    x, y = np.random.default_rng(0).standard_normal(n), np.random.default_rng(1).standard_normal(m)
    lhs = float(y @ op.mv(T(x.astype(np.float32))).numpy())
    assert lhs == pytest.approx(float(op.rmv(T(y.astype(np.float32))).numpy() @ x), rel=1e-4)


def test_rbf_kernel_and_genie_matvec_match_jax():
    """The RBF Gram and the genie normal matvec against JAX's on the same
    inputs (1e-5 relative), and the matvec against the explicit
    (A_S·A_Sᴴ + reg·I)·x."""
    rng = np.random.default_rng(2)
    X = rng.standard_normal((6, 3)).astype(np.float32)
    K = ops.rbf_kernel_op(T(X), gamma=0.7).A.numpy()
    assert _rel(K, jops.rbf_kernel_op(jnp.asarray(X), gamma=0.7).A) < 1e-5
    np.testing.assert_allclose(np.diag(K), 1.0, atol=1e-5)
    A = (_crandn(rng, 12, 24) / np.sqrt(12)).astype(np.complex64)
    support = rng.random(24) < 0.3
    x = _crandn(rng, 12)
    got = ops.genie_normal_matvec(ops.MatrixOp(T(A)), 0.07, T(support))(T(x)).numpy()
    want = jops.genie_normal_matvec(jops.MatrixOp(jnp.asarray(A)), 0.07, jnp.asarray(support))(jnp.asarray(x))
    assert _rel(got, want) < 1e-5
    S = support
    np.testing.assert_allclose(got, (A[:, S] @ A[:, S].conj().T + 0.07 * np.eye(12)) @ x, rtol=1e-4, atol=1e-5)


def test_interop_carries_the_new_operators():
    """JAX's operators through ``op_to_torch`` equal the port's built
    directly, and ``op_to_numpy`` round-trips them."""
    rng = np.random.default_rng(4)
    A1, A2, Ab = _crandn(rng, 5, 4), _crandn(rng, 3, 4), _crandn(rng, 2, 3, 4)
    idx = (1, 5, 9, 9, 60)
    cases = [jops.ConcatOp((jops.MatrixOp(jnp.asarray(A1)), jops.MatrixOp(jnp.asarray(A2)))),
             jops.BlockDiagOp(jnp.asarray(Ab)), jops.CenterOp(4), jops.TVOp(4), jops.HaarOp(4, 2),
             jops.MedImageOp(8, 8, 2, idx)]
    for jop in cases:
        op = interop.op_to_torch(jop)
        again = interop.op_to_torch(interop.op_to_numpy(op))
        x = _crandn(rng, *op.in_shape)
        want = jop.mv(jnp.asarray(x))
        want = want if isinstance(want, tuple) else (want,)
        for got in (op.mv(T(x)), again.mv(T(x))):
            for g_, w_ in zip(got if isinstance(got, tuple) else (got,), want):
                assert _rel(g_.numpy(), w_) < 1e-5
    assert interop.op_to_torch(cases[-1]).mask_idx.dtype == torch.int64


# -- DisDist and weibull_grid -----------------------------------------------------------------------


def test_weibull_grid_and_disdist_match_jax():
    """The grid and its normalized pdf, and DisDist's normalization, mean and
    variance, against JAX's to float32 roundoff."""
    x, p = weibull_grid(2.0, 1.0, device="cpu")
    jx, jp = jweibull_grid(2.0, 1.0)
    assert _rel(x.numpy(), jx) < 1e-6 and _rel(p.numpy(), jp) < 1e-6
    m, v = DisDist(x, p).mean_var()
    jm, jv = JDisDist(jx, jp).mean_var()
    assert float(m) == pytest.approx(float(jm), rel=1e-5) and float(v) == pytest.approx(float(jv), rel=1e-5)
    np.testing.assert_allclose(DisDist(torch.tensor([0.0, 1.0]), torch.tensor([2.0, 2.0])).px.numpy(), [0.5, 0.5])


def test_disdist_samples_at_the_ensemble_level():
    """Weibull(2, 1): the distribution's moments (Γ(1.5) = 0.8862, Γ(2) −
    Γ(1.5)² = 0.2146) within 0.01, as JAX's test, and 20000 inverse-CDF
    draws (``searchsorted(side="right")``) within 0.02 of them; every
    grid point's share within 4 standard errors of its probability over
    200000 draws of a 5-point distribution."""
    x, p = weibull_grid(2.0, 1.0, device="cpu")
    d = DisDist(x, p)
    m, v = d.mean_var()
    assert abs(float(m) - 0.8862) < 0.01 and abs(float(v) - 0.2146) < 0.01
    s = d.sample(torch.Generator().manual_seed(0), 20_000)
    assert abs(float(s.mean()) - float(m)) < 0.02 and abs(float(s.var()) - float(v)) < 0.02
    pts = torch.tensor([0.0, 1.0, 2.0, 3.0, 4.0])
    pr = torch.tensor([0.1, 0.0, 0.4, 0.3, 0.2])
    n = 200_000
    s = DisDist(pts, pr).sample(torch.Generator().manual_seed(1), n)
    for k in range(5):
        share = float((s == pts[k]).float().mean())
        assert abs(share - float(pr[k])) <= 4 * math.sqrt(float(pr[k]) * (1 - float(pr[k])) / n)
