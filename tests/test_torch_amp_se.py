"""The port's ``amp_est`` (with S-AMP), GAMP's state evolution
(``solvers/gamp_se.py``), VAMP-SLM with its state evolutions
(``solvers/vamp_slm.py``) and the VAMP-GLM tail (``r1_init``, ``track_x0``,
``vamp_glm_se`` and the output-stage averages) against the JAX package on
the same numpy inputs.  The port solves a batch of problems in one call;
JAX solves each in its own call.  Tolerances are stated at each test: the
deterministic maps to float32 roundoff, the iterative solvers per element
over a short horizon (the float32 iterations of both packages drift apart
at the ulp level and the recursions amplify it), the samplers at the
ensemble level."""
import importlib
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.core import prng as jprng  # noqa: E402
from jstsp19_tpu.ops import KronDictOp as JKronDictOp, MatrixOp as JMatrixOp, ScaledOp as JScaledOp  # noqa: E402
from jstsp19_tpu.ops.fourier import FWHTOp as JFWHTOp  # noqa: E402
from jstsp19_tpu.ops.structured import SubsetOp as JSubsetOp  # noqa: E402
from jstsp19_tpu.solvers import estim as jestim  # noqa: E402
jse = importlib.import_module("jstsp19_tpu.solvers.gamp_se")  # noqa: E402 (the package rebinds the name)
from jstsp19_tpu.solvers import vamp as jvamp  # noqa: E402
from jstsp19_tpu.solvers.gamp import amp_est as jamp_est  # noqa: E402
from jstsp19_tpu.solvers.vamp_slm import amp_se as jamp_se, vamp_slm as jvamp_slm  # noqa: E402
from jstsp19_tpu.solvers.vamp_slm import vamp_slm_se as jvamp_slm_se  # noqa: E402
from jstsp19_torch import interop  # noqa: E402
from jstsp19_torch.core import prng  # noqa: E402
from jstsp19_torch.harness import amp_sparse as aps  # noqa: E402
from jstsp19_torch.harness import hadamard_cs as hcs  # noqa: E402
from jstsp19_torch.ops.base import MatrixOp  # noqa: E402
from jstsp19_torch.ops.kron import KronDictOp  # noqa: E402
from jstsp19_torch.solvers import estim  # noqa: E402
from jstsp19_torch.solvers import gamp_se as pse  # noqa: E402
from jstsp19_torch.solvers import vamp as pvamp  # noqa: E402
from jstsp19_torch.solvers.gamp import _median, amp, amp_est  # noqa: E402
from jstsp19_torch.solvers.gamp_full import GampOptions, gamp_est  # noqa: E402
from jstsp19_torch.solvers.vamp_slm import amp_se, vamp_slm, vamp_slm_se  # noqa: E402

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


def _nmse(xh, x):
    xh, x = np.asarray(xh), np.asarray(x)
    return ((xh - x) ** 2).sum(-1) / (x**2).sum(-1)


def _jprior():
    return jestim.SparsePrior(base=jestim.AwgnPrior(mean0=0.0, var0=1.0), p1=aps.SPEC_K / aps.SPEC_N)


def _crandn(rng, *shape, var=1.0):
    return (np.sqrt(var / 2) * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(np.complex64)


# -- amp_est -------------------------------------------------------------------------

BRANCHES = {
    "mean": dict(rvar_method="mean"),
    "median": dict(rvar_method="median"),
    "wvar": dict(rvar_method="wvar", wvar=aps.SPEC_WVAR),
    "s_amp": dict(wvar=aps.SPEC_WVAR, damp=0.5),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_amp_est_matches_jax_per_element(branch):
    """Three flat-spectrum problems (numpy seeds 0-2), 20 iterations of every
    variance branch: the port's batch against JAX's calls per element.
    Tolerance 1e-4·max|x| for the standard branches (measured ~5e-7) and
    5e-4 for S-AMP (~5e-5: the nested float32 bisections end within a few
    ulps of their roots in each package); 20 iterations reach the noise
    floor on these problems."""
    sp = aps.spectrum_problems((0, 1, 2), cond=1.0)
    kw = dict(BRANCHES[branch])
    jkw = dict(kw)
    if branch == "s_amp":
        kw["evals_aah"], jkw["evals_aah"] = T(sp["evals"]), None
    got = amp_est(T(sp["y"]), MatrixOp(T(sp["A"])), aps.spectrum_prior(), nit=20, **kw).numpy()
    want = np.stack([np.asarray(jamp_est(jnp.asarray(sp["y"][b]), JMatrixOp(jnp.asarray(sp["A"][b])), _jprior(),
                                         nit=20, **(dict(jkw, evals_aah=jnp.asarray(sp["evals"][b]))
                                                    if branch == "s_amp" else jkw)))
                     for b in range(3)])
    assert _rel(got, want) < (5e-4 if branch == "s_amp" else 1e-4)


def test_amp_est_rvar_methods_agree_on_flat_spectrum():
    """The JAX package's test of ``ampEst.m``'s variance branches
    (``tests/test_gamp.py``), on the port: all four recover a
    well-conditioned problem to NMSE < 1e-3 in 60 iterations."""
    sp = aps.spectrum_problems((0,), cond=1.0)
    for kw in (dict(rvar_method="mean"), dict(rvar_method="median"), dict(rvar_method="wvar", wvar=aps.SPEC_WVAR),
               dict(evals_aah=T(sp["evals"]), wvar=aps.SPEC_WVAR)):
        xh = amp_est(T(sp["y"]), MatrixOp(T(sp["A"])), aps.spectrum_prior(), nit=60, **kw)
        assert _nmse(xh.numpy(), sp["x"])[0] < 1e-3, kw


def test_s_amp_recovers_where_standard_amp_fails():
    """The JAX package's S-AMP test on the port: on the condition-10
    ensemble plain AMP fails and S-AMP (200 iterations, damp 0.5) recovers
    to the noise level, NMSE < 1e-3."""
    sp = aps.spectrum_problems((0,))
    y, op = T(sp["y"]), MatrixOp(T(sp["A"]))
    assert _nmse(amp(y, op, aps.spectrum_prior(), nit=100).numpy(), sp["x"])[0] > 0.5
    xs = amp_est(y, op, aps.spectrum_prior(), nit=aps.SAMP_NIT, wvar=aps.SPEC_WVAR, evals_aah=T(sp["evals"]),
                 damp=aps.SAMP_DAMP)
    assert _nmse(xs.numpy(), sp["x"])[0] < 1e-3


@pytest.mark.parametrize("n", [7, 8])
def test_median_is_numpys(n):
    """An even count averages the two middle values, as ``jnp.median``."""
    v = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    np.testing.assert_allclose(_median(T(v)).numpy()[:, 0], np.median(v, -1), rtol=1e-6)


def test_amp_est_on_partial_hadamard_matches_jax():
    """The slice as a whole at a small size: ``amp_est`` on two partial
    Walsh–Hadamard problems (n = 1024) through the port's plain FWHT against
    JAX's on each problem, 'mean' and 'median': per element within
    1e-4·max|x| over 20 iterations (measured ~1e-6) and the NMSE at 50
    iterations within 0.05 dB."""
    prob = hcs.hadamard_cs_problem(batch=2, n=1024)
    y, op, prior, _ = aps.hadamard_amp_torch(prob, "cpu")
    jprior = jestim.SparsePrior(jestim.AwgnPrior(0.0, 1.0 / hcs.EPS), hcs.EPS)
    for method in ("mean", "median"):
        for nit in (20, aps.AMP_NIT):
            got = amp_est(y, op, prior, nit=nit, rvar_method=method).numpy()
            want = np.stack([np.asarray(jamp_est(
                jnp.asarray(prob["y"][b] * 2.0),
                JScaledOp(JSubsetOp(JFWHTOp(1024), tuple(int(i) for i in prob["idx"][b])), jnp.float32(2.0)),
                jprior, nit=nit, rvar_method=method)) for b in range(2)])
            if nit == 20:
                assert _rel(got, want) < 1e-4, method
            else:
                np.testing.assert_allclose(hcs.nmse_db(got, prob["x"]), hcs.nmse_db(want, prob["x"]), atol=0.05)
    assert hcs.nmse_db(got, prob["x"]).max() < -30.0  # it recovers


# -- s_transform ---------------------------------------------------------------------


def test_s_transform_matches_jax_and_the_references_endpoints():
    """A flat spectrum (S = 1/c inside), a random low-rank one and the
    endpoints, against JAX's on the same inputs to float32 roundoff
    (1e-5 relative); a spectrum per realization equals each row's."""
    c, N = 2.5, 64
    eigs = np.full(N, c, np.float32)
    y = np.array([-0.9, -0.5, -0.1, -0.01], np.float32)
    np.testing.assert_allclose(pse.s_transform(T(y), T(eigs), N).numpy(), 1.0 / c, rtol=1e-4)
    assert float(pse.s_transform(0.0, T(eigs), N)) == 1.0
    assert math.isinf(float(pse.s_transform(-1.0, T(eigs), N)))
    rng = np.random.default_rng(3)
    N, R = 32, 20
    eigs = (np.sort(rng.random(R).astype(np.float32))[::-1] * 3.0).copy()
    ys = (np.array([-0.6, -0.3, -0.05, 0.0, -R / N, -0.9, 0.1]) * np.array([R / N] * 3 + [1] * 4)).astype(np.float32)
    got = pse.s_transform(T(ys), T(eigs), N).numpy()
    want = np.asarray(jse.s_transform(jnp.asarray(ys), eigs, N))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)
    eigs2 = np.stack([eigs, eigs * 0.5])
    rows = pse.s_transform(T(ys[:3].reshape(1, 3).repeat(2, 0)), T(eigs2), N).numpy()
    for b in range(2):
        np.testing.assert_allclose(rows[b], pse.s_transform(T(ys[:3]), T(eigs2[b]), N).numpy(), rtol=1e-6)


# -- GAMP state evolution ----------------------------------------------------------------


def test_gamp_se_matches_jax_on_its_draws():
    """JAX's ``EstimInAvg`` (its x and w) through ``interop``: the whole SE
    trajectory (mse, taux, taup, taur) with the AWGN output average equals
    JAX's to 1e-4 relative (float32 means over 65536 samples)."""
    p1, wvar = 0.1, 1e-4
    jprior = jestim.SparsePrior(base=jestim.AwgnPrior(mean0=0.0, var0=1.0), p1=p1)
    javg = jse.estim_in_avg(jprior, jax.random.PRNGKey(0), n_samp=65536, sampler=jse.bg_sampler(p1))
    want = jse.gamp_se(javg, jse.AwgnOutAvg(wvar=wvar), beta=2.0, nit=24)
    got = pse.gamp_se(interop.estim_in_avg_to_torch(javg), pse.AwgnOutAvg(wvar=wvar), beta=2.0, nit=24)
    for k in ("mse", "taux", "taup", "taur"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, err_msg=k)


def test_mc_out_avg_matches_jax_at_the_ensemble_level():
    """The probit output average (32768 samples) against JAX's at three
    forward variances: within 3% (the Monte-Carlo error of the two
    independent sample sets is ~1%); each call draws the same samples."""
    wvar = 1e-2

    def jchannel(key, z):
        return (z + jnp.sqrt(wvar) * jax.random.normal(key, z.shape) > 0).astype(jnp.float32)

    def channel(gen, z):
        return (z + wvar**0.5 * torch.randn(z.shape, generator=gen) > 0).to(torch.float32)

    javg = jse.MCOutAvg(like_factory=lambda y: jestim.ProbitLikelihood(y=y, wvar=wvar), channel=jchannel,
                        key=jax.random.PRNGKey(1), n_samp=32768)
    avg = pse.MCOutAvg(like_factory=lambda y: estim.ProbitLikelihood(y=y, wvar=wvar), channel=channel,
                       key=torch.Generator().manual_seed(1), n_samp=32768)
    for taup in (0.05, 0.3, 1.0):
        got = float(avg.svar_avg(taup, 1.25))
        assert got == float(avg.svar_avg(taup, 1.25))
        assert got == pytest.approx(float(javg.svar_avg(jnp.float32(taup), jnp.float32(1.25))), rel=0.03)


def test_gamp_se_matches_empirical_awgn():
    """The JAX package's SE-against-``gamp_est`` test (``tests/test_gamp_se.py``)
    on the port, on that test's own draws (made by JAX, handed over as numpy):
    three Bernoulli–Gaussian problems (m 512, n 1024, one batch) track the SE
    trajectory within 2 dB above the noise floor and at the end."""
    p1, wvar, m, n = 0.1, 1e-4, 512, 1024
    jprior = jestim.SparsePrior(base=jestim.AwgnPrior(mean0=0.0, var0=1.0), p1=p1)
    javg = jse.estim_in_avg(jprior, jax.random.PRNGKey(0), n_samp=65536, sampler=jse.bg_sampler(p1, 1.0))
    se = pse.gamp_se(interop.estim_in_avg_to_torch(javg), pse.AwgnOutAvg(wvar=wvar), beta=n / m, nit=24)
    A, x, y = [], [], []
    for s in range(3):
        ka, kx, kw = jax.random.split(jax.random.PRNGKey(10 + s), 3)
        A.append(np.asarray(jax.random.normal(ka, (m, n)) / jnp.sqrt(m)))
        x.append(np.asarray(jse.bg_sampler(p1, 1.0)(kx, n)))
        y.append(np.asarray(A[-1] @ x[-1] + jnp.sqrt(wvar) * jax.random.normal(kw, (m,))))
    x = T(np.stack(x))
    _, _, hist = gamp_est(estim.SparsePrior(estim.AwgnPrior(0.0, 1.0), p1),
                          estim.CAwgnLikelihood(T(np.stack(y)), wvar), MatrixOp(T(np.stack(A))),
                          GampOptions(nit=25, adapt_step=False, step=1.0, tol=-1.0, save_hist=True))
    emp_db = 10 * np.log10(((hist["xhat"] - x).abs() ** 2).mean(-1).mean(-1).numpy() + 1e-12)
    se_db = 10 * np.log10(se["mse"].numpy() + 1e-12)
    best = min(np.abs(emp_db[2 + max(0, s):12 + min(0, s)] - se_db[2 + max(0, -s):12 + min(0, -s)]).max()
               for s in (-1, 0, 1))
    assert best < 2.0, (emp_db[:12], se_db[:12])
    assert abs(emp_db[-1] - se_db[len(emp_db) - 1]) < 2.0


@pytest.mark.parametrize("cplx", [False, True])
def test_bg_sampler_and_estim_in_avg_at_the_ensemble_level(cplx):
    """Bernoulli–Gaussian draws: the active share and E|x|² within 4 standard
    errors of p1 and p1·var0; ``estim_in_avg``'s noise is circular complex
    where x is."""
    p1, var0, n = 0.2, 3.0, 200000
    x = pse.bg_sampler(p1, var0, cplx=cplx)(torch.Generator().manual_seed(4), n)
    assert x.is_complex() == cplx
    share = float((x != 0).float().mean())
    assert abs(share - p1) < 4 * math.sqrt(p1 * (1 - p1) / n)
    e2 = (x.abs() ** 2).double()
    assert abs(float(e2.mean()) - p1 * var0) < 4 * float(e2.std()) / math.sqrt(n)
    avg = pse.estim_in_avg(estim.SparsePrior(estim.AwgnPrior(0.0, var0), p1), torch.Generator().manual_seed(5),
                           4096, sampler=pse.bg_sampler(p1, var0, cplx=cplx))
    assert avg.x.shape == avg.w.shape == (4096,) and avg.w.is_complex() == cplx


# -- VAMP-SLM and the state evolutions -----------------------------------------------------


def _kron_problems(B, seed=0, Gr=24, K=12, N=32, M=40, beta=0.1, nv=0.01):
    """B spike-slab problems y = A·X·B + CN(0, nv), numpy complex64."""
    rng = np.random.default_rng(seed)
    A = _crandn(rng, B, N, Gr) / np.float32(np.sqrt(N))
    Bm = _crandn(rng, B, K, M) / np.float32(np.sqrt(K))
    X = np.where(rng.random((B, Gr, K)) < beta, _crandn(rng, B, Gr, K, var=1 / beta), 0).astype(np.complex64)
    Y = (A @ X @ Bm + _crandn(rng, B, N, M, var=nv)).astype(np.complex64)
    return A, Bm, X, Y


def _spike_slab(beta, torch_side=True):
    if torch_side:
        return estim.SparsePrior(estim.CAwgnPrior(0.0, 1.0 / beta), beta)
    return jestim.SparsePrior(jestim.CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.float32(1 / beta)), jnp.float32(beta))


def test_vamp_slm_matches_jax_per_element():
    """Two problems, 10 iterations (the horizon the VAMP-GLM tests hold VAMP to: its
    float32 iteration amplifies one-ulp differences later): x, gam1, r1 and
    the mse track within 1e-3·max (measured ~1e-6), one noise precision per
    realization."""
    A, Bm, X, Y = _kron_problems(2)
    gamw = np.array([100.0, 50.0], np.float32)
    got = vamp_slm(_spike_slab(0.1), T(Y), KronDictOp(T(A), T(Bm)), T(gamw)[:, None, None], nit=10)
    for b in range(2):
        want = jvamp_slm(_spike_slab(0.1, False), jnp.asarray(Y[b]), JKronDictOp(jnp.asarray(A[b]), jnp.asarray(Bm[b])),
                         jnp.float32(gamw[b]), nit=10)
        assert _rel(got.x[b].numpy(), want.x) < 1e-3
        assert _rel(got.r1[b].numpy(), want.r1) < 1e-3
        assert _rel(got.gam1[b].numpy().ravel(), np.asarray(want.gam1).ravel()) < 1e-3
        assert _rel(got.mse_track[b].numpy(), want.mse_track) < 1e-3


def test_vamp_slm_gaussian_prior_equals_lmmse():
    """The JAX package's LMMSE test on the port: with a Gaussian prior the
    fixed point is the LMMSE estimate, within 1e-3 relative."""
    rng = np.random.default_rng(1)
    A, Bm = _crandn(rng, 12, 8), _crandn(rng, 6, 20)
    X, nv = _crandn(rng, 8, 6), 0.1
    Y = (A @ X @ Bm + _crandn(rng, 12, 20, var=nv)).astype(np.complex64)
    res = vamp_slm(estim.CAwgnPrior(0.0, 1.0), T(Y), KronDictOp(T(A), T(Bm)), 1.0 / nv, nit=100)
    K2 = np.kron(Bm.T, A).astype(np.complex128)
    xl = np.linalg.solve(K2.conj().T @ K2 + nv * np.eye(48), K2.conj().T @ Y.flatten(order="F")).reshape(8, 6, order="F")
    assert np.linalg.norm(res.x.numpy() - xl) / np.linalg.norm(xl) < 1e-3


def test_vamp_slm_sparse_recovery_and_se_agreement():
    """The JAX package's VAMP-SLM/SE overlay on the port: it recovers (MSE <
    0.1) and lies within 3× the SE prediction plus 0.01."""
    A, Bm, X, Y = _kron_problems(1, seed=2, beta=0.1)
    op = KronDictOp(T(A), T(Bm))
    res = vamp_slm(_spike_slab(0.1), T(Y), op, 100.0, nit=40)
    emp = float(((res.x - T(X)).abs() ** 2).mean())
    assert emp < 0.1

    def sampler(gen, n):
        act = torch.rand(n, generator=gen) < 0.1
        return torch.where(act, prng.complex_normal(gen, (n,), var=10.0), 0)

    se = vamp_slm_se(sampler, _spike_slab(0.1), op.gram_in_eig()[2].reshape(-1), 100.0, nit=40)
    assert float(se[-1]) < 0.1 and emp < 3 * float(se[-1]) + 0.01


def _jax_se_draws(sampler, n, seed=0):
    key = jprng.experiment_key(seed)
    return (np.asarray(sampler(key, n)), np.asarray(jprng.complex_normal(jax.random.fold_in(key, 1), (n,), var=1.0)))


def _jax_bg(beta):
    def sample(key, n):
        m = jax.random.uniform(key, (n,)) < beta
        return jnp.where(m, jprng.complex_normal(jax.random.fold_in(key, 1), (n,), var=1 / beta), 0.0)

    return sample


def test_vamp_slm_se_and_amp_se_match_jax_on_its_draws():
    """JAX's draws (x⁰ from its sampler, its unit noise) handed to the port:
    both trajectories equal JAX's to 1e-4 relative."""
    beta, n = 0.1, 4096
    x0, w = _jax_se_draws(_jax_bg(beta), n)
    d = np.linspace(0.0, 2.0, 288).astype(np.float32)
    want = jvamp_slm_se(_jax_bg(beta), _spike_slab(beta, False), jnp.asarray(d), 100.0, nit=20, n_samples=n)
    got = vamp_slm_se(None, _spike_slab(beta), T(d), 100.0, nit=20, draws=(T(x0), T(w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    x0, w = _jax_se_draws(_jax_bg(beta), 8192)
    want = jamp_se(_jax_bg(beta), _spike_slab(beta, False), delta=0.5, wvar=jnp.float32(1e-3), nit=20)
    got = amp_se(None, _spike_slab(beta), 0.5, 1e-3, nit=20, draws=(T(x0), T(w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


def test_amp_matches_state_evolution():
    """The JAX package's AMP/SE test on the port: the empirical AMP MSE within
    10× the SE prediction (plus 1e-4), which is below 0.05."""
    rng = np.random.default_rng(7)
    m, n, k = 256, 512, 25
    A = _crandn(rng, m, n) / np.float32(np.sqrt(m))
    x = np.zeros(n, np.complex64)
    x[rng.choice(n, k, False)] = _crandn(rng, k, var=n / k)
    yc = A @ x
    nv = float(np.mean(np.abs(yc) ** 2)) * 10 ** (-2.5)
    y = (yc + _crandn(rng, m, var=nv)).astype(np.complex64)
    beta = k / n
    xh = amp(T(y)[None], MatrixOp(T(A)), _spike_slab(beta), nit=40)
    emp = float(((xh[0] - T(x)).abs() ** 2).sum()) / n

    def sampler(gen, ns):
        return torch.where(torch.rand(ns, generator=gen, device=gen.device) < beta,
                           prng.complex_normal(gen, (ns,), var=1 / beta), 0)

    pred = float(amp_se(sampler, _spike_slab(beta), m / n, nv, nit=40, device="cpu")[-1])
    assert emp < 10 * pred + 1e-4 and pred < 0.05


# -- VAMP-GLM: r1_init, track_x0, the state evolution and the output averages -------------


def test_vamp_glm_r1_init_and_track_x0_match_jax():
    """A start r1 and a tracked truth, two problems, 10 iterations: x and the
    tracked MSE per iteration within 1e-3·max of JAX's (measured ~1e-6)."""
    A, Bm, X, Y = _kron_problems(2, seed=3, Gr=32, K=16, N=24, M=12, beta=0.15)
    r1 = (0.1 * _crandn(np.random.default_rng(9), 2, 32, 16)).astype(np.complex64)
    like = estim.CAwgnLikelihood(T(Y), 0.01)
    got = pvamp.vamp_glm(_spike_slab(0.15), like, KronDictOp(T(A), T(Bm)), nit=10, damp=0.9, r1_init=T(r1),
                         track_x0=T(X))
    assert got.mse_track.shape == (2, 10)
    for b in range(2):
        want = jvamp.vamp_glm(_spike_slab(0.15, False), jestim.CAwgnLikelihood(jnp.asarray(Y[b]), jnp.float32(0.01)),
                              JKronDictOp(jnp.asarray(A[b]), jnp.asarray(Bm[b])), nit=10, damp=0.9,
                              r1_init=jnp.asarray(r1[b]), track_x0=jnp.asarray(X[b]))
        assert _rel(got.x[b].numpy(), want.x) < 1e-3
        assert _rel(got.mse_track[b].numpy(), want.mse_track) < 1e-3


def test_vamp_glm_takes_its_dtype_from_r1_init_or_the_likelihood():
    """Without y the state's dtype comes from r1_init (promoted to complex),
    else from the likelihood's tensors as they are: a quantized channel's
    real edges give a real state, as in JAX."""
    rng = np.random.default_rng(4)
    A, Bm = rng.standard_normal((1, 6, 8)).astype(np.float32), rng.standard_normal((1, 5, 7)).astype(np.float32)
    z = A @ rng.standard_normal((1, 8, 5)).astype(np.float32) @ Bm
    like = estim.QuantizedLikelihood(T(np.floor(z)), T(np.floor(z) + 1.0))
    op = KronDictOp(T(A), T(Bm))
    res = pvamp.vamp_glm(estim.AwgnPrior(0.0, 1.0), like, op, nit=5)
    assert res.x.dtype == torch.float32 and bool(torch.isfinite(res.x).all())
    assert pvamp._x_dtype(like, torch.zeros(1, 8, 5))[0] == torch.complex64


def test_vamp_glm_se_matches_jax_on_its_draws():
    """JAX's draws handed to the port's ``vamp_glm_se`` with the closed-form
    AWGN output stage: the trajectory equals JAX's to 1e-4 relative."""
    beta, n, wvar = 0.15, 4096, 1e-2
    key = jprng.experiment_key(0)
    x0 = np.asarray(_jax_bg(beta)(key, n))
    noise = np.asarray(jprng.complex_normal(jax.random.fold_in(key, 1), (n,), var=1.0))
    d = np.outer(np.linspace(0.2, 2.0, 24), np.linspace(0.5, 1.5, 12)).ravel().astype(np.float32)
    want = jvamp.vamp_glm_se(_jax_bg(beta), _spike_slab(beta, False), jvamp.cawgn_likelihood_mse(wvar),
                             jnp.asarray(d), 512, 288 / 512, nit=25, n_samples=n)
    got = pvamp.vamp_glm_se(None, _spike_slab(beta), pvamp.cawgn_likelihood_mse(wvar), T(d), 512, 288 / 512,
                            nit=25, draws=(T(x0), T(noise)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


def _jcrandn(key, shape, var=1.0):
    k1, k2 = jax.random.split(key)
    return ((jax.random.normal(k1, shape) + 1j * jax.random.normal(k2, shape)) * np.sqrt(var / 2)).astype(jnp.complex64)


def test_vamp_glm_se_matches_the_empirical_spike_slab():
    """The JAX package's VampGlmSE overlay (``tests/test_vamp_glm_se.py``) on
    the port, on that test's problem (made by JAX from ``key(0)``): the
    solver converges, its settled tracked MSE lies within 0.25 decades of the
    SE's, and the SE decreases."""
    Gr, K, N, M, beta, wvar = 32, 16, 24, 12, 0.15, 1e-2
    kA, kB, kx, ka, kn = jax.random.split(jax.random.key(0), 5)
    A = np.asarray(_jcrandn(kA, (N, Gr)) / np.sqrt(N))
    Bm = np.asarray(_jcrandn(kB, (K, M)) / np.sqrt(K))
    X = np.asarray(jnp.where(jax.random.bernoulli(ka, beta, (Gr, K)), _jcrandn(kx, (Gr, K), var=1 / beta), 0.0))
    Y = (A @ X @ Bm + np.asarray(_jcrandn(kn, (N, M), var=wvar))).astype(np.complex64)
    res = pvamp.vamp_glm(_spike_slab(beta), estim.CAwgnLikelihood(T(Y)[None], wvar),
                         KronDictOp(T(A)[None], T(Bm)[None]), nit=25, damp=0.9, track_x0=T(X)[None])
    d = np.outer(np.linalg.eigvalsh(A @ A.conj().T), np.linalg.eigvalsh(Bm.conj().T @ Bm)).ravel()

    def sampler(gen, n):
        return torch.where(torch.rand(n, generator=gen) < beta, prng.complex_normal(gen, (n,), var=1 / beta), 0)

    se = pvamp.vamp_glm_se(sampler, _spike_slab(beta), pvamp.cawgn_likelihood_mse(wvar),
                           T(d.astype(np.float32)), Gr * K, N * M / (Gr * K), nit=25, n_samples=8192).numpy()
    emp = res.mse_track[0].numpy()
    x2 = float((np.abs(X) ** 2).mean())
    assert emp.min() / x2 < 0.1 * emp[0] / x2
    assert abs(np.log10(se[-5:].mean() / x2) - np.log10(emp.min() / x2)) < 0.25
    assert se[-1] <= se[0]


def test_mc_likelihood_mse_matches_jax_and_the_closed_form():
    """JAX's probe e handed to the port with the same channel noise: (E|ẑ−z|²,
    E[zvar]) equal JAX's to 1e-5 relative; and, drawn by the port, within
    5% / 15% of the AWGN closed form (the JAX package's test)."""
    wvar = 0.05
    rng = np.random.default_rng(8)
    phat = _crandn(rng, 4096, var=2.0)
    w = _crandn(rng, 4096, var=wvar)
    e = np.asarray(jprng.complex_normal(jax.random.fold_in(jprng.experiment_key(0), 7919), (4096,), var=1.0))
    jmc = jvamp.mc_likelihood_mse(lambda y: jestim.CAwgnLikelihood(y, jnp.float32(wvar)),
                                  lambda k, z: z + jnp.asarray(w), jnp.asarray(phat))
    mc = pvamp.mc_likelihood_mse(lambda y: estim.CAwgnLikelihood(y, wvar), lambda g, z: z + T(w), T(phat), draws=T(e))
    for pvar in (0.01, 0.3, 2.0):
        for a, b in zip(mc(torch.tensor(pvar)), jmc(jnp.float32(pvar))):
            assert float(a) == pytest.approx(float(b), rel=1e-5)
    mc = pvamp.mc_likelihood_mse(lambda y: estim.CAwgnLikelihood(y, wvar),
                                 lambda g, z: z + prng.complex_normal(g, z.shape, var=wvar), T(phat))
    for pvar in (0.01, 0.3, 2.0):
        mse, zvar = mc(torch.tensor(pvar))
        v = 1.0 / (1.0 / wvar + 1.0 / pvar)
        assert float(zvar) == pytest.approx(v, rel=0.05) and float(mse) == pytest.approx(v, rel=0.15)
        v2 = pvamp.cawgn_likelihood_mse(wvar)(pvar)
        assert v2[0] == v2[1] == pytest.approx(v)
