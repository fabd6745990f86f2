"""Mean removal in the port's GAMP core against the JAX package on the same
numpy inputs: ``DemeanRCOp``'s four maps and its expansion helpers against
JAX's ``demean_rc`` (a real and a complex ``MatrixOp``, and
``SubsetOp(FWHTOp(1024))`` with three row sets, one per realization), and
``gamp_est(remove_mean=True)`` per element at a fixed iteration count, alone
and with uniform variance, noise tuning, the Bethe utility and the
partial-Hadamard operator; the rescue of a mean-heavy operator; the
expansion of a user's initial state; and the exact warm start.  The port
solves a batch in one call; JAX solves each realization in its own."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.ops.base import MatrixOp as JMatrixOp  # noqa: E402
from jstsp19_tpu.ops.fourier import FWHTOp as JFWHTOp  # noqa: E402
from jstsp19_tpu.ops.structured import SubsetOp as JSubsetOp, demean_rc as jdemean_rc  # noqa: E402
from jstsp19_tpu.solvers import estim as jestim  # noqa: E402
from jstsp19_tpu.solvers import gamp_full as jfull  # noqa: E402
from jstsp19_torch import interop  # noqa: E402
from jstsp19_torch.harness import hadamard_cs as hcs  # noqa: E402
from jstsp19_torch.ops.base import MatrixOp  # noqa: E402
from jstsp19_torch.ops.fourier import FWHTOp  # noqa: E402
from jstsp19_torch.ops.structured import DemeanRCOp, SubsetOp, demean_rc  # noqa: E402
from jstsp19_torch.solvers import estim  # noqa: E402
from jstsp19_torch.solvers.gamp_full import GampOptions, gamp_est  # noqa: E402

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These batches are small: one intra-op thread each, so that the suite's
    parallel workers do not oversubscribe the cores (OpenMP threads spinning
    on small linear-algebra calls made these tests 100 times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- DemeanRCOp against JAX's demean_rc ------------------------------------------------


def _operators(kind):
    """(port operator, [JAX operator per realization], B, dtype)."""
    rng = np.random.default_rng({"real": 1, "complex": 2, "fwht": 3}[kind])
    if kind == "fwht":
        n, m, B = 1024, 256, 3
        idx = np.stack([np.sort(rng.choice(n, m, replace=False)) for _ in range(B)])
        return (SubsetOp(FWHTOp(n), T(idx)), [JSubsetOp(JFWHTOp(n), tuple(int(i) for i in r)) for r in idx], B,
                np.float32)
    m, n, B = 24, 40, 2
    A = rng.standard_normal((B, m, n)) + 2.0 + rng.standard_normal((B, 1, n))  # row and column offsets
    dt = np.float32
    if kind == "complex":
        A = A + 1j * (rng.standard_normal((B, m, n)) - 1.0)
        dt = np.complex64
    A = A.astype(dt)
    return MatrixOp(T(A)), [JMatrixOp(jnp.asarray(a)) for a in A], B, dt


def _vec(rng, shape, dt):
    x = rng.standard_normal(shape)
    if dt == np.complex64:
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dt)


@pytest.mark.parametrize("kind", ["real", "complex", "fwht"])
def test_demean_rc_matches_jax(kind):
    """demean_rc's means and scalars per realization, the four maps on
    random inputs and the expand/contract helpers, at 1e-5 of the largest
    reference value for the linear maps and fields, 1e-4 for the variance
    maps (differences of terms up to n times larger); JAX's operator
    carried over by interop gives the same maps."""
    pop, jops, B, dt = _operators(kind)
    dm = demean_rc(pop, (B,))
    assert isinstance(dm, DemeanRCOp) and dm.gam.shape[0] == B and dm.b12.shape == (B, 1)
    (n,), (m,) = pop.in_shape, pop.out_shape
    rng = np.random.default_rng(7)
    xd, sd = _vec(rng, (B, n + 2), dt), _vec(rng, (B, m + 2), dt)
    xv, sv = rng.random((B, n + 2)).astype(np.float32), rng.random((B, m + 2)).astype(np.float32)
    x = _vec(rng, (B, n), dt)
    got = dict(mv=dm.mv(T(xd)), rmv=dm.rmv(T(sd)), sq_mv=dm.sq_mv(T(xv)), sq_rmv=dm.sq_rmv(T(sv)),
               expand_xhat=dm.expand_xhat(T(x)), expand_xvar=dm.expand_xvar(T(xv[:, :n])),
               expand_out=dm.expand_out(T(sd[:, :m]), 1.5), contract=dm.contract(T(xd)),
               contract_out=dm.contract_out(T(sd)))
    for b, jop in enumerate(jops):
        jd = jdemean_rc(jop)
        for f in ("gam", "col", "b12", "b21", "b13", "b31"):
            assert _rel(getattr(dm, f)[b].numpy().reshape(np.shape(getattr(jd, f))), getattr(jd, f)) <= 1e-5, f
        want = dict(mv=jd.mv(xd[b]), rmv=jd.rmv(sd[b]), sq_mv=jd.sq_mv(xv[b]), sq_rmv=jd.sq_rmv(sv[b]),
                    expand_xhat=jd.expand_xhat(x[b]), expand_xvar=jd.expand_xvar(xv[b, :n]),
                    expand_out=jd.expand_out(sd[b, :m], 1.5), contract=jd.contract(xd[b]),
                    contract_out=jd.contract_out(sd[b]))
        for k, w in want.items():
            tol = 1e-4 if k.startswith("sq_") else 1e-5
            assert _rel(got[k][b].numpy(), w) <= tol, (k, b)
        carried = interop.op_to_torch(jd)
        assert _rel(carried.sq_rmv(T(sv[b])).numpy(), want["sq_rmv"]) <= 1e-4
        assert _rel(carried.mv(T(xd[b])).numpy(), want["mv"]) <= 1e-5
    # the constraint rows of Ad·expand(x) are zero and the core reproduces A·x
    z = dm.mv(dm.expand_xhat(T(x)))
    assert _rel(z[:, :m].numpy(), pop.mv(T(x)).numpy()) <= 1e-5
    assert float(z[:, m:].abs().max()) <= 1e-4 * float(z[:, :m].abs().max())


# -- gamp_est(remove_mean=True) ------------------------------------------------------------


def _mean_heavy(seeds=(3, 13), n=128, m=64, k=8, wvar=1e-3):
    """The real problem of tests/test_gamp_full.py::_bg_problem with a +1
    offset on A (seed 3 is test_mean_removal_rescues_mean_heavy_operator's),
    rebuilt with numpy, one realization per seed: x (B, n), A (B, m, n),
    y (B, m)."""
    X, A, Y = [], [], []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        a = rng.standard_normal((m, n)) / np.sqrt(m)
        x = np.zeros(n)
        x[rng.choice(n, k, False)] = rng.standard_normal(k)
        w = np.sqrt(wvar) * rng.standard_normal(m)
        a = a + 1.0
        X.append(x), A.append(a), Y.append(a @ x + w)
    X, A, Y = (np.stack(v) for v in (X, A, Y))
    jprior = jestim.SparsePrior(jestim.AwgnPrior(mean0=0.0, var0=1.0), p1=k / n)
    return dict(X=X, jprior=jprior, pprior=interop.estimator_to_torch(jprior),
                jop=[JMatrixOp(jnp.asarray(a, jnp.float32)) for a in A], pop=MatrixOp(T(A.astype(np.float32))),
                jlike=[jestim.CAwgnLikelihood(y=jnp.asarray(y, jnp.float32), wvar=wvar) for y in Y],
                plike=estim.CAwgnLikelihood(T(Y.astype(np.float32)), wvar))


def _hadamard(seed=4, n=256):
    prob = hcs.hadamard_cs_problem(seed=seed, batch=2, n=n)
    pprior, plike, pop = hcs.hadamard_cs_torch(prob, "cpu")
    jprior = jestim.SparsePrior(jestim.AwgnPrior(0.0, 1.0 / hcs.EPS), hcs.EPS)
    jl = [jestim.CAwgnLikelihood(jnp.asarray(prob["y"][b]), jnp.float32(prob["wvar"][b])) for b in range(2)]
    jops = [JSubsetOp(JFWHTOp(n), tuple(int(i) for i in prob["idx"][b])) for b in range(2)]
    return dict(X=prob["x"], jprior=jprior, pprior=pprior, jop=jops, pop=pop, jlike=jl, plike=plike)


def _nmse_db(xhat, x):
    return 10 * np.log10(((np.asarray(xhat) - x) ** 2).sum(-1) / (x**2).sum(-1))


OPTION_SETS = [
    ("remove_mean", "mean_heavy", dict(nit=40, tol=-1.0, remove_mean=True)),
    ("remove_mean, uniform_variance", "mean_heavy", dict(nit=40, tol=-1.0, remove_mean=True, uniform_variance=True)),
    # on the partial-Hadamard problems: on the mean-heavy ones the second
    # realization's tuned noise variance climbs to 0.4 in both packages (the
    # tune/accept feedback), which amplifies float32 rounding to 7e-4 by
    # iteration 40
    ("remove_mean, tune_wvar", "hadamard", dict(nit=30, tol=-1.0, remove_mean=True, tune_wvar=True)),
    ("remove_mean, adapt_step_bethe", "mean_heavy", dict(nit=40, tol=-1.0, remove_mean=True, adapt_step_bethe=True)),
    ("remove_mean, partial Hadamard", "hadamard", dict(nit=30, tol=-1.0, remove_mean=True)),
]


@pytest.mark.parametrize("label,kind,kw", OPTION_SETS, ids=[o[0] for o in OPTION_SETS])
def test_gamp_est_remove_mean_matches_jax(label, kind, kw):
    """The batched port (B=2) against two JAX calls at a fixed iteration
    count (tol −1): max|Δx̂| and max|Δẑ| ≤ 1e-4 of the largest value (float32
    rounding carried through the iteration; the adaptive step takes the
    same decisions), the contracted shapes (n,) and (m,), the step to 1e-5,
    the utility to 1e-3 of its size (a sum over m terms that cancel) and,
    with tune_wvar, the tuned noise variance of the first block at 1e-4."""
    p = _mean_heavy() if kind == "mean_heavy" else _hadamard()
    fin, st, _ = gamp_est(p["pprior"], p["plike"], p["pop"], GampOptions(**kw))
    (n,), (m,) = p["pop"].in_shape, p["pop"].out_shape
    assert fin.xhat.shape == (2, n) and fin.zhat.shape == (2, m) and st.xhat.shape == (2, n + 2)
    for b in range(2):
        jfin, jst, _ = jfull.gamp_est(p["jprior"], p["jlike"][b], p["jop"][b], jfull.GampOptions(**kw))
        assert int(fin.nit[b]) == int(jfin.nit)
        for f in ("xhat", "zhat", "rhat", "axhat"):
            assert _rel(getattr(fin, f)[b].numpy(), getattr(jfin, f)) <= 1e-4, f
        assert abs(float(fin.val[b]) - float(jfin.val)) <= 1e-3 * abs(float(jfin.val)) + 1e-6
        assert abs(float(fin.step[b]) - float(jfin.step)) <= 1e-5
        if kw.get("tune_wvar"):
            assert _rel(st.likelihood.likes[0].wvar[b].numpy(), jst.likelihood.likes[0].wvar) <= 1e-4


def test_mean_removal_rescues_the_mean_heavy_operator():
    """As in tests/test_gamp_full.py: 100 iterations with mean removal are
    at least 20 dB better than without it in each realization, and below
    −25 dB on that test's problem (seed 3; seed 13 reaches −24.8 dB); the
    port's NMSE equals JAX's within 0.05 dB both ways."""
    p = _mean_heavy()
    fin_plain, _, _ = gamp_est(p["pprior"], p["plike"], p["pop"], GampOptions(nit=100))
    fin_dm, _, _ = gamp_est(p["pprior"], p["plike"], p["pop"], GampOptions(nit=100, remove_mean=True))
    plain, dm = _nmse_db(fin_plain.xhat.numpy(), p["X"]), _nmse_db(fin_dm.xhat.numpy(), p["X"])
    assert dm[0] < -25.0 and np.all(plain - dm >= 20.0), (plain, dm)
    for b in range(2):
        for opts, got in ((jfull.GampOptions(nit=100), plain[b]), (jfull.GampOptions(nit=100, remove_mean=True), dm[b])):
            jfin, _, _ = jfull.gamp_est(p["jprior"], p["jlike"][b], p["jop"][b], opts)
            assert abs(got - _nmse_db(np.asarray(jfin.xhat), p["X"][b])) <= 0.05


def test_remove_mean_expands_the_initial_state():
    """A user's x_init and xvar_init (one per realization) expand exactly
    into the two augmented entries (nit=0: the state is the expansion), and
    20 iterations from there, and from x_init with xvar0auto, match JAX at
    1e-4."""
    p = _mean_heavy()
    rng = np.random.default_rng(9)
    x0 = (0.5 * p["X"] + 0.01 * rng.standard_normal(p["X"].shape)).astype(np.float32)
    v0 = (0.1 + rng.random(p["X"].shape)).astype(np.float32)
    args = (p["pprior"], p["plike"], p["pop"])
    _, st0, _ = gamp_est(*args, GampOptions(nit=0, remove_mean=True), x_init=T(x0), xvar_init=T(v0))
    fin, _, _ = gamp_est(*args, GampOptions(nit=20, tol=-1.0, remove_mean=True), x_init=T(x0), xvar_init=T(v0))
    fin_auto, _, _ = gamp_est(*args, GampOptions(nit=20, tol=-1.0, remove_mean=True, xvar0auto=True), x_init=T(x0))
    _, st_def, _ = gamp_est(*args, GampOptions(nit=0, remove_mean=True))
    for b in range(2):
        jargs = (p["jprior"], p["jlike"][b], p["jop"][b])
        _, jst0, _ = jfull.gamp_est(*jargs, jfull.GampOptions(nit=0, remove_mean=True), x_init=x0[b], xvar_init=v0[b])
        assert _rel(st0.xhat[b].numpy(), jst0.xhat) <= 1e-5 and _rel(st0.xvar[b].numpy(), jst0.xvar) <= 1e-5
        _, jst_def, _ = jfull.gamp_est(*jargs, jfull.GampOptions(nit=0, remove_mean=True))
        assert _rel(st_def.xvar[b].numpy(), jst_def.xvar) <= 1e-5 and _rel(st_def.xhat[b].numpy(), jst_def.xhat) <= 1e-5
        jfin, _, _ = jfull.gamp_est(*jargs, jfull.GampOptions(nit=20, tol=-1.0, remove_mean=True), x_init=x0[b],
                                    xvar_init=v0[b])
        assert _rel(fin.xhat[b].numpy(), jfin.xhat) <= 1e-4
        jauto, _, _ = jfull.gamp_est(*jargs, jfull.GampOptions(nit=20, tol=-1.0, remove_mean=True, xvar0auto=True),
                                     x_init=x0[b])
        assert _rel(fin_auto.xhat[b].numpy(), jauto.xhat) <= 1e-4


def test_remove_mean_warm_start_is_exact():
    """nit=15, then nit=25 from its (augmented) state, equals nit=40
    straight, bit for bit, with and without uniform variance."""
    p = _mean_heavy()
    args = (p["pprior"], p["plike"], p["pop"])
    for uv in (False, True):
        kw = dict(tol=-1.0, step_tol=-1.0, remove_mean=True, uniform_variance=uv)
        fin40, st40, _ = gamp_est(*args, GampOptions(nit=40, **kw))
        _, st15, _ = gamp_est(*args, GampOptions(nit=15, **kw))
        fin_res, st_res, _ = gamp_est(*args, GampOptions(nit=25, **kw), state_in=st15)
        assert torch.equal(fin40.xhat, fin_res.xhat) and torch.equal(st40.shat, st_res.shat)
        assert torch.equal(st40.step, st_res.step) and torch.equal(fin_res.nit, torch.tensor([40, 40], dtype=torch.int32))
