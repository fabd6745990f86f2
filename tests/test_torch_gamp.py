"""The port's GAMP path against the JAX package on the same numpy inputs: the
estimators' moments and utilities, the lean ``gamp`` (fixed and adaptive
step), ``amp``, ``fista`` and ``sure_amp``, and ``gamp_est`` in several
option sets, the warm start included.  The port solves a batch of B=2
problems in one call; JAX solves each in its own call."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.ops.base import MatrixOp as JMatrixOp  # noqa: E402
from jstsp19_tpu.ops.fourier import FWHTOp as JFWHTOp  # noqa: E402
from jstsp19_tpu.ops.structured import SubsetOp as JSubsetOp  # noqa: E402
from jstsp19_tpu.solvers import estim as jestim  # noqa: E402
from jstsp19_tpu.solvers.gamp import amp as jamp, fista as jfista, gamp as jgamp_lean  # noqa: E402
from jstsp19_tpu.solvers.gamp import sure_amp as jsure_amp  # noqa: E402
from jstsp19_tpu.solvers import gamp_full as jfull  # noqa: E402
from jstsp19_torch import interop  # noqa: E402
from jstsp19_torch.harness import hadamard_cs as hcs  # noqa: E402
from jstsp19_torch.ops.base import MatrixOp  # noqa: E402
from jstsp19_torch.solvers import estim  # noqa: E402
from jstsp19_torch.solvers import gamp as pgamp  # noqa: E402
from jstsp19_torch.solvers.gamp_full import GampOptions, gamp_est  # noqa: E402

T = torch.from_numpy


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# -- estimators ------------------------------------------------------------------


def _priors(cplx):
    """(JAX prior, port prior) pairs with the parameters the tests use."""
    base = (jestim.CAwgnPrior(jnp.asarray(0.3 + 0.1j, jnp.complex64), jnp.float32(2.0)) if cplx
            else jestim.AwgnPrior(jnp.float32(0.3), jnp.float32(2.0)))
    out = [base, jestim.SparsePrior(base, jnp.float32(0.1))]
    return [(j, interop.estimator_to_torch(j)) for j in out]


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_priors_match_jax(cplx):
    """estim, init_moments, val_neg_kl, loglikey and the max-sum pair at
    1e-5 of the largest value: float32 logs and exps, which may round
    differently by an ulp."""
    rng = np.random.default_rng(int(cplx))
    r = rng.standard_normal(64) * 2
    if cplx:
        r = r + 1j * rng.standard_normal(64) * 2
    r = r.astype(np.complex64 if cplx else np.float32)
    v = (rng.random(64) + 0.05).astype(np.float32)
    for jp, pp in _priors(cplx):
        xh, xv = pp.estim(T(r), T(v))
        jxh, jxv = jp.estim(r, v)
        assert _rel(xh.numpy(), jxh) < 1e-5 and _rel(xv.numpy(), jxv) < 1e-5
        for got, want in zip(pp.init_moments(), jp.init_moments()):
            assert _rel(np.asarray(got), want) < 1e-6
        kl = pp.val_neg_kl(T(r), T(v), xh, xv).numpy()
        assert _rel(kl, jp.val_neg_kl(r, v, jxh, jxv)) < 1e-5
        if hasattr(jp, "loglikey"):
            assert _rel(pp.loglikey(T(r), T(v)).numpy(), jp.loglikey(r, v)) < 1e-5
        if hasattr(jp, "estim_map"):
            assert _rel(pp.estim_map(T(r), T(v))[0].numpy(), jp.estim_map(r, v)[0]) < 1e-5
            assert _rel(pp.val_map(T(r)).numpy(), jp.val_map(r)) < 1e-5


def test_sparse_prior_with_one_activity_per_realization():
    """Parameters shaped (B, 1) act per realization: the same as one JAX
    call per row with that row's scalars (1e-5, as above)."""
    rng = np.random.default_rng(3)
    r = rng.standard_normal((2, 32)).astype(np.float32) * 3
    v = np.full((2, 32), 0.2, np.float32)
    p1, var0 = np.array([[0.05], [0.3]], np.float32), np.array([[4.0], [0.5]], np.float32)
    pp = estim.SparsePrior(estim.AwgnPrior(0.0, T(var0)), T(p1))
    xh, xv = pp.estim(T(r), T(v))
    for b in range(2):
        jp = jestim.SparsePrior(jestim.AwgnPrior(0.0, var0[b, 0]), p1[b, 0])
        jxh, jxv = jp.estim(r[b], v[b])
        assert _rel(xh[b].numpy(), jxh) < 1e-5 and _rel(xv[b].numpy(), jxv) < 1e-5
        assert _rel(pp.val_neg_kl(T(r), T(v), xh, xv)[b].numpy(), jp.val_neg_kl(r[b], v[b], jxh, jxv)) < 1e-5


@pytest.mark.parametrize("cplx", [False, True], ids=["real y", "complex y"])
def test_awgn_likelihood_matches_jax(cplx):
    """estim, estim_map, loglike, logscale and both noise-variance updates
    at 1e-5 (float32); the updates are one per realization in the port, the
    mean over one JAX call's vector."""
    rng = np.random.default_rng(5 + int(cplx))
    mk = (lambda *s: (rng.standard_normal(s) + 1j * rng.standard_normal(s)).astype(np.complex64)) if cplx \
        else (lambda *s: rng.standard_normal(s).astype(np.float32))
    y, ph = mk(2, 48), mk(2, 48)
    pv = (rng.random((2, 48)) + 0.1).astype(np.float32)
    wvar = np.array([[0.05], [0.2]], np.float32)
    pl = estim.CAwgnLikelihood(T(y), T(wvar))
    for b in range(2):
        jl = jestim.CAwgnLikelihood(jnp.asarray(y[b]), jnp.float32(wvar[b, 0]))
        for fn in ("estim", "estim_map"):
            for got, want in zip(getattr(pl, fn)(T(ph), T(pv)), getattr(jl, fn)(ph[b], pv[b])):
                assert _rel(got[b].numpy(), want) < 1e-5
        assert _rel(pl.loglike(T(ph), T(pv))[b].numpy(), jl.loglike(ph[b], pv[b])) < 1e-5
        assert _rel(pl.logscale(T(ph), T(pv), T(ph))[b].numpy(), jl.logscale(ph[b], pv[b], ph[b])) < 1e-5
        assert _rel(pl.tune_wvar_ml(T(ph), T(pv) * 0.01)[b].numpy(), jl.tune_wvar_ml(ph[b], pv[b] * 0.01)) < 1e-5
        assert _rel(pl.tune_wvar_em(T(ph), T(pv))[b].numpy(), jl.tune_wvar_em(ph[b], pv[b])) < 1e-5


# -- problems -----------------------------------------------------------------------


def _dense(seed, cplx=False, m=96, n=192, eps=0.1, wvar=1e-3):
    """Two sparse problems through one dense Gaussian A (shared, so each
    JAX call traces once per option set)."""
    rng = np.random.default_rng(seed)
    if cplx:
        A = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))) / np.sqrt(2 * m)
        X = (rng.random((2, n)) < eps) * (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))) \
            / np.sqrt(2 * eps)
        W = np.sqrt(wvar / 2) * (rng.standard_normal((2, m)) + 1j * rng.standard_normal((2, m)))
        A, X, Y = A.astype(np.complex64), X.astype(np.complex64), (X @ A.T + W).astype(np.complex64)
        base_j, base_p = jestim.CAwgnPrior(jnp.asarray(0j, jnp.complex64), 1.0 / eps), estim.CAwgnPrior(0j, 1.0 / eps)
    else:
        A = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
        X = ((rng.random((2, n)) < eps) * rng.standard_normal((2, n)) / np.sqrt(eps)).astype(np.float32)
        Y = (X @ A.T + np.sqrt(wvar) * rng.standard_normal((2, m))).astype(np.float32)
        base_j, base_p = jestim.AwgnPrior(0.0, 1.0 / eps), estim.AwgnPrior(0.0, 1.0 / eps)
    jprior, pprior = jestim.SparsePrior(base_j, eps), estim.SparsePrior(base_p, eps)
    jl = [jestim.CAwgnLikelihood(jnp.asarray(Y[b]), wvar) for b in range(2)]
    return dict(X=X, jprior=jprior, pprior=pprior, jop=JMatrixOp(jnp.asarray(A)), pop=MatrixOp(T(A)), jlike=jl,
                plike=estim.CAwgnLikelihood(T(Y), wvar), wvar=wvar)


def _hadamard(seed=0, n=256):
    """Two partial-Hadamard problems of harness/hadamard_cs.py, each with
    its own row set."""
    prob = hcs.hadamard_cs_problem(seed=seed, batch=2, n=n)
    pprior, plike, pop = hcs.hadamard_cs_torch(prob, "cpu")
    jprior = jestim.SparsePrior(jestim.AwgnPrior(0.0, 1.0 / hcs.EPS), hcs.EPS)
    jl = [jestim.CAwgnLikelihood(jnp.asarray(prob["y"][b]), jnp.float32(prob["wvar"][b])) for b in range(2)]
    jops = [JSubsetOp(JFWHTOp(n), tuple(int(i) for i in prob["idx"][b])) for b in range(2)]
    return dict(X=prob["x"], jprior=jprior, pprior=pprior, jop=jops, pop=pop, jlike=jl, plike=plike)


def _jop(p, b):
    return p["jop"][b] if isinstance(p["jop"], list) else p["jop"]


# -- the lean solvers -------------------------------------------------------------


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed step", "adaptive step"])
def test_gamp_matches_jax(adaptive):
    """50 iterations of the lean gamp on the partial-Hadamard problems:
    max|Δx| ≤ 1e-4·max|x| per realization (measured ≤ 1.6e-7: float32
    rounding carried through the iteration)."""
    p = _hadamard(seed=1)
    got = pgamp.gamp(p["pprior"], p["plike"], p["pop"], nit=50, step=0.9, adaptive=adaptive)
    for b in range(2):
        want = jgamp_lean(p["jprior"], p["jlike"][b], _jop(p, b), nit=50, step=0.9, adaptive=adaptive)
        assert _rel(got.x[b].numpy(), want.x) < 1e-4
        assert _rel(got.rvar[b].numpy(), want.rvar) < 1e-4
    if not adaptive:  # the lean adaptive mode stalls on one of them, in JAX too
        assert np.all(hcs.nmse_db(got.x.numpy(), p["X"]) < -35)


def test_amp_and_sure_amp_match_jax():
    """amp (30 iterations) and sure_amp (30 iterations, 32 thresholds) on
    the dense real problems, per realization at 1e-4·max|x| (measured
    ≤ 6.0e-7: float32; the SURE argmin picks the same grid point)."""
    p = _dense(seed=2)
    got_amp = pgamp.amp(p["plike"].y, p["pop"], p["pprior"], nit=30).numpy()
    got_sure = pgamp.sure_amp(p["plike"].y, p["pop"], nit=30).numpy()
    for b in range(2):
        y = p["jlike"][b].y
        assert _rel(got_amp[b], jamp(y, p["jop"], p["jprior"], nit=30)) < 1e-4
        assert _rel(got_sure[b], jsure_amp(y, p["jop"], nit=30)) < 1e-4


def test_fista_matches_jax():
    """fista (50 iterations, λ=0.02, the power-iteration Lipschitz
    constant) on the dense real problems: complex64 iterates, as in JAX, at
    1e-4·max|x| (measured 6.4e-7)."""
    p = _dense(seed=3)
    got = pgamp.fista(p["plike"].y, p["pop"], 0.02, nit=50).numpy()
    for b in range(2):
        assert _rel(got[b], jfista(p["jlike"][b].y, p["jop"], 0.02, nit=50)) < 1e-4


# -- gamp_est ---------------------------------------------------------------------------

OPTION_SETS = [
    ("defaults, partial Hadamard", "hadamard", dict(nit=50)),
    ("defaults, complex", "complex", dict(nit=50)),
    ("adapt_step_bethe", "real", dict(nit=50, adapt_step_bethe=True)),
    ("max_sum", "gauss", dict(nit=50, max_sum=True)),
    ("tune_wvar", "real", dict(nit=50, tune_wvar=True)),
    ("uniform_variance", "real", dict(nit=50, uniform_variance=True)),
    ("bb_step", "real", dict(nit=50, bb_step=True)),
    ("rvar_step, var_norm, fixed step", "real", dict(nit=40, adapt_step=False, step=0.8, rvar_step=True,
                                                       var_norm=True)),
]


def _problem(kind, seed):
    if kind == "hadamard":
        return _hadamard(seed)
    p = _dense(seed, cplx=kind == "complex")
    if kind == "gauss":  # max-sum needs a prior with a MAP branch
        p.update(jprior=jestim.AwgnPrior(0.0, 1.0), pprior=estim.AwgnPrior(0.0, 1.0))
    return p


@pytest.mark.parametrize("label,kind,kw", OPTION_SETS, ids=[o[0] for o in OPTION_SETS])
def test_gamp_est_matches_jax(label, kind, kw):
    """The batched port (B=2) against two JAX calls: the same iteration
    count per realization and max|Δx̂| ≤ 1e-4·max|x̂| (measured ≤ 2.9e-6:
    float32 rounding; the adaptive step takes the same accept/reject
    decisions), the step to 1e-5 (measured equal), and the utility to
    1e-3 of its size: a sum over m terms that cancel (measured ≤ 7.1e-5)."""
    p = _problem(kind, seed=10 + len(label))
    fin, st, _ = gamp_est(p["pprior"], p["plike"], p["pop"], GampOptions(**kw))
    for b in range(2):
        jfin, jst, _ = jfull.gamp_est(p["jprior"], p["jlike"][b], _jop(p, b), jfull.GampOptions(**kw))
        assert int(fin.nit[b]) == int(jfin.nit)
        assert _rel(fin.xhat[b].numpy(), jfin.xhat) < 1e-4
        assert _rel(fin.zhat[b].numpy(), jfin.zhat) < 1e-4
        assert abs(float(fin.val[b]) - float(jfin.val)) <= 1e-3 * abs(float(jfin.val)) + 1e-6
        assert abs(float(fin.step[b]) - float(jfin.step)) <= 1e-5
        if kw.get("tune_wvar"):
            assert _rel(st.likelihood.wvar[b].numpy(), jst.likelihood.wvar) < 1e-4


def test_gamp_est_warm_start_is_exact():
    """nit=15, then nit=25 from its state, equals nit=40 straight, bit for
    bit (the reference's warmStart contract, as
    tests/test_gamp_full.py::test_warm_start_exact); and a JAX state carried
    over by interop continues in the port to JAX's own nit=40 at 1e-4."""
    p = _dense(seed=4)
    kw = dict(tol=-1.0, step_tol=-1.0)
    fin40, st40, _ = gamp_est(p["pprior"], p["plike"], p["pop"], GampOptions(nit=40, **kw))
    _, st15, _ = gamp_est(p["pprior"], p["plike"], p["pop"], GampOptions(nit=15, **kw))
    fin_res, st_res, _ = gamp_est(p["pprior"], p["plike"], p["pop"], GampOptions(nit=25, **kw), state_in=st15)
    assert torch.equal(fin40.xhat, fin_res.xhat) and torch.equal(st40.shat, st_res.shat)
    assert torch.equal(st40.step, st_res.step) and torch.equal(fin_res.nit, torch.tensor([40, 40], dtype=torch.int32))
    jst15 = [jfull.gamp_est(p["jprior"], p["jlike"][b], p["jop"], jfull.GampOptions(nit=15, **kw))[1]
             for b in range(2)]
    carried = interop.gamp_state_to_torch(jst15)
    fin_c, _, _ = gamp_est(p["pprior"], p["plike"], p["pop"], GampOptions(nit=25, **kw), state_in=carried)
    back = interop.gamp_state_to_torch(interop.gamp_state_to_numpy(carried))
    assert torch.equal(back.xhat, carried.xhat) and back.likelihood.wvar.shape == (2, 1)
    for b in range(2):
        jfin40, _, _ = jfull.gamp_est(p["jprior"], p["jlike"][b], p["jop"], jfull.GampOptions(nit=40, **kw))
        assert _rel(fin_c.xhat[b].numpy(), jfin40.xhat) < 1e-4


def test_gamp_est_stop_fn_histories_and_xvar0auto():
    """stop_fn freezes each realization at it ≥ 10 and reproduces nit=10
    exactly; save_hist keeps (nit, B, …) histories and hist_intvl takes
    every k-th of them exactly; xvar0auto from the true x matches JAX's
    derived xvar0 at 1e-4 and converges."""
    from jstsp19_tpu.solvers.gamp_full import _xvar0_auto as jxvar0_auto

    from jstsp19_torch.solvers.gamp_full import _xvar0_auto

    p = _dense(seed=5)
    args = (p["pprior"], p["plike"], p["pop"])
    fin_stop, _, _ = gamp_est(*args, GampOptions(nit=80, tol=-1.0, stop_fn=lambda st: st.it >= 10))
    fin_10, _, _ = gamp_est(*args, GampOptions(nit=10, tol=-1.0))
    assert torch.equal(fin_stop.nit, torch.tensor([10, 10], dtype=torch.int32))
    assert torch.equal(fin_stop.xhat, fin_10.xhat)
    _, _, hist = gamp_est(*args, GampOptions(nit=30, save_hist=True, tol=-1.0))
    _, _, hist3 = gamp_est(*args, GampOptions(nit=30, save_hist=True, tol=-1.0, hist_intvl=10))
    assert hist["xhat"].shape == (30, 2, 192) and hist["zhat"].shape == (30, 2, 96)
    assert hist["val"].shape == (30, 2) and hist["passed"].dtype == torch.bool
    assert torch.equal(hist3["xhat"], hist["xhat"][9::10])
    opts = GampOptions(nit=50, xvar0auto=True)
    xv = _xvar0_auto(*args, T(p["X"]), opts)
    for b in range(2):
        want = jxvar0_auto(p["jprior"], p["jlike"][b], p["jop"], jnp.asarray(p["X"][b]), jfull.GampOptions(**vars(opts)))
        assert _rel(xv[b].numpy(), want) < 1e-4
    fin, _, _ = gamp_est(*args, opts, x_init=T(p["X"]))
    err = ((fin.xhat.numpy() - p["X"]) ** 2).sum(-1) / (p["X"] ** 2).sum(-1)
    assert np.all(err < 1e-2)


def test_gamp_est_remove_mean_waits_for_the_long_tail():
    """remove_mean, which waited for the GAMP long tail, now runs: on the
    dense real problems (B=2, 50 iterations) it equals two JAX calls at
    max|Δx̂| ≤ 1e-4·max|x̂| with the same iteration counts, in the original
    coordinates (tests/test_torch_gamp_demean.py holds the rest)."""
    p = _dense(seed=6)
    fin, st, _ = gamp_est(p["pprior"], p["plike"], p["pop"], GampOptions(nit=50, remove_mean=True))
    assert fin.xhat.shape == (2, 192) and st.xhat.shape == (2, 194)
    for b in range(2):
        jfin, _, _ = jfull.gamp_est(p["jprior"], p["jlike"][b], p["jop"], jfull.GampOptions(nit=50, remove_mean=True))
        assert int(fin.nit[b]) == int(jfin.nit)
        assert _rel(fin.xhat[b].numpy(), jfin.xhat) < 1e-4
