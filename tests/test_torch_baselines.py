"""The port's baselines and the unfused ADMM at the errorVSnrf shape against
the JAX package on the same numpy inputs: ls_estimate, omp_mmv (saturated
and greedy), KronDictOp, vamp_mmwave and proposed_admm with N > M."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.core import prng as jprng  # noqa: E402
from jstsp19_tpu.harness import pipeline as jpipe  # noqa: E402
from jstsp19_tpu.ops.kron import KronDictOp as JKron  # noqa: E402
from jstsp19_tpu.solvers import admm as jadmm  # noqa: E402
from jstsp19_tpu.solvers.lsq import ls_estimate as jls  # noqa: E402
from jstsp19_tpu.solvers.omp import omp_mmv as jomp  # noqa: E402
from jstsp19_tpu.solvers.vamp import vamp_mmwave as jvamp  # noqa: E402
from jstsp19_tpu.frontend import hbf as jhbf  # noqa: E402
from jstsp19_torch import interop  # noqa: E402
from jstsp19_torch.ops.kron import KronDictOp  # noqa: E402
from jstsp19_torch.solvers.admm import admm_hyperparams, proposed_admm  # noqa: E402
from jstsp19_torch.solvers.lsq import ls_estimate, pinv  # noqa: E402
from jstsp19_torch.solvers.omp import omp_mmv  # noqa: E402
from jstsp19_torch.solvers.vamp import vamp_mmwave  # noqa: E402

NV_5DB = 10 ** (-0.5)


def _c(rng, *s):
    return ((rng.standard_normal(s) + 1j * rng.standard_normal(s)) / np.sqrt(2)).astype(np.complex64)


def T(x):
    return torch.from_numpy(np.array(x))


def _relerr(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def conventional():
    """JAX draws one batch of conventional-branch inputs at the errorVSnrf
    point Mr=12 (T=5, +5 dB), where VAMP either converges or diverges:
    Y_c, A_c, B_c and Zbar under T_hbf."""
    pc = jpipe.PointConfig(Mr=12, T=5)
    keys = jprng.realization_keys(jprng.experiment_key(2), 0, 4)

    def one(key):
        ch, Psi, N, W = jpipe._system_realization(key, pc, NV_5DB)
        Th = pc.T_hbf
        Y_c, W_c = jhbf(ch.H, N[:, :Th], Psi[:, :, :Th], pc.Nr, W)
        A_c, B_c = jpipe._dictionaries(ch, W_c, Psi[:, :, :Th])
        return dict(Y_c=Y_c, A_c=A_c, B_c=B_c, Zbar=ch.Zbar)

    return {k: np.asarray(v) for k, v in jax.vmap(one)(keys).items()}


def test_ls_estimate_matches_jax(conventional):
    """rtol 1e-4 of max|S| (measured 2.7e-6: two float32 SVD-based pinvs)."""
    d = conventional
    t = interop.conventional_to_torch(d)
    want = np.asarray(jax.vmap(jls)(d["Y_c"], d["A_c"], d["B_c"]))
    assert _relerr(ls_estimate(t["Y_c"], t["A_c"], t["B_c"]).numpy(), want) < 1e-4


def test_omp_mmv_saturated_matches_jax(conventional):
    """m = Gr = 32 atoms (the errorVSnrf points take this shortcut): one LS
    solve, rtol 1e-4 of max|x| (measured 3.3e-6); the clip-padded support."""
    d = conventional
    t = interop.conventional_to_torch(d)
    V = np.asarray(jax.vmap(lambda y, b: y @ jnp.linalg.pinv(b))(d["Y_c"], d["B_c"]))
    want = jax.vmap(lambda a, v: jomp(a, v, 32))(d["A_c"], V)
    got = omp_mmv(t["A_c"], t["Y_c"] @ pinv(t["B_c"]), 32)
    assert _relerr(got.x.numpy(), np.asarray(want.x)) < 1e-4
    np.testing.assert_array_equal(got.support.numpy(), np.asarray(want.support))


def test_omp_mmv_greedy_matches_jax():
    """m = 8 < n = 32: the greedy loop picks the same supports, and the
    joint refit agrees to rtol 1e-4 of max|x| (measured 1.9e-7)."""
    rng = np.random.default_rng(4)
    A = _c(rng, 3, 24, 32)
    X0 = np.zeros((3, 32, 5), np.complex64)
    for b in range(3):
        X0[b, rng.choice(32, 6, replace=False)] = _c(rng, 6, 5)
    V = (A @ X0 + 0.05 * _c(rng, 3, 24, 5)).astype(np.complex64)
    want = jax.vmap(lambda a, v: jomp(a, v, 8))(A, V)
    got = omp_mmv(T(A), T(V), 8)
    np.testing.assert_array_equal(got.support.numpy(), np.asarray(want.support))
    assert _relerr(got.x.numpy(), np.asarray(want.x)) < 1e-4


def test_kron_dict_op_matches_jax():
    """mv and rmv (through dict_correlation) at rtol 1e-5 of the max
    (measured 1.2e-7, 1.8e-7); gram_out_eig's eigenvalues at 1e-4 of the
    largest (measured 4.6e-7) and, since eigenvector phases are arbitrary,
    the Gram it factorizes applied to Y at 1e-4 (measured 1.3e-6)."""
    rng = np.random.default_rng(5)
    A, B = _c(rng, 2, 32, 32), _c(rng, 2, 16, 16)
    S, Y = _c(rng, 2, 32, 16), _c(rng, 2, 32, 16)
    op = KronDictOp(T(A), T(B))
    assert op.in_shape == (32, 16) and op.out_shape == (32, 16)
    jmv = jax.vmap(lambda a, b, s: JKron(a, b).mv(s))(A, B, S)
    jrmv = jax.vmap(lambda a, b, y: JKron(a, b).rmv(y))(A, B, Y)
    assert _relerr(op.mv(T(S)).numpy(), np.asarray(jmv)) < 1e-5
    assert _relerr(op.rmv(T(Y)).numpy(), np.asarray(jrmv)) < 1e-5
    Ua, Ub, d = op.gram_out_eig()
    jd = np.asarray(jax.vmap(lambda a, b: JKron(a, b).gram_out_eig()[2])(A, B))
    assert np.abs(d.numpy() - jd).max() < 1e-4 * jd.max()
    applied = op.from_eigbasis(Ua, Ub, d * op.to_eigbasis(Ua, Ub, T(Y)))
    jgram = jax.vmap(lambda a, b, y: JKron(a, b).gram_out(y))(A, B, Y)
    assert _relerr(applied.numpy(), np.asarray(jgram)) < 1e-4


def test_vamp_mmwave_matches_jax_on_normal_equations(conventional):
    """The errorVSnrf VAMP call (normal equations, wvar=1, numOfnz=100,
    damping 0.85) per realization over the first 10 iterations: rtol 1e-3
    of max|x| (measured 4.2e-5).  Later iterations amplify float32
    rounding: the JAX function itself moves by 10-30% of max|x| at 100
    iterations when its input moves by one ulp, so at full depth the two
    packages are held together by ensemble (tests/test_torch_harness.py)."""
    d = conventional
    Yn = np.einsum("bnt,bkt->bnk", d["Y_c"], d["B_c"].conj()).astype(np.complex64)
    Bn = np.einsum("bkt,bjt->bkj", d["B_c"], d["B_c"].conj()).astype(np.complex64)
    want = np.asarray(jax.vmap(lambda y, a, b: jvamp(y, a, b, 1.0, 100, nit=10))(Yn, d["A_c"], Bn))
    got = vamp_mmwave(T(Yn), T(d["A_c"]), T(Bn), 1.0, 100, nit=10).numpy()
    assert _relerr(got, want) < 1e-3
    full = vamp_mmwave(T(Yn), T(d["A_c"]), T(Bn), 1.0, 100).numpy()
    assert full.shape == (4, 32, 16) and np.all(np.isfinite(full))


def test_vamp_mmwave_matches_jax_on_the_direct_model():
    """The direct model Y ≈ A·X·B with more observations than unknowns
    (vamp_normal_eq=False and T_hbf > L·Gt) takes VAMP's input-Gram branch:
    rtol 1e-3 of max|x| over the first 10 iterations, as above (measured
    1.8e-6; the estimate is within 0.5% of the true X in norm)."""
    rng = np.random.default_rng(7)
    A, B = _c(rng, 3, 32, 16), _c(rng, 3, 8, 24)
    X0 = _c(rng, 3, 16, 8) * (rng.random((3, 16, 8)) < 0.2)
    Y = (A @ X0 @ B + 0.1 * _c(rng, 3, 32, 24)).astype(np.complex64)
    want = np.asarray(jax.vmap(lambda y, a, b: jvamp(y, a, b, 0.01, 20, nit=10))(Y, A, B))
    got = vamp_mmwave(T(Y), T(A), T(B), 0.01, 20, nit=10).numpy()
    assert _relerr(got, want) < 1e-3
    assert np.linalg.norm(got - X0) < 0.01 * np.linalg.norm(X0)


@pytest.mark.parametrize("svt_method", ["eigh", "tracked"])
def test_unfused_admm_matches_jax_at_nrf_shape(svt_method):
    """The unfused solve with N > M (N=32, M=20: errorVSnrf's shape), B=2,
    Imax=25, use_kernels=False: max|ΔS| ≤ 2e-4·max|S| (measured 4.9e-7
    eigh, 8.0e-7 tracked)."""
    Bt, N, M, Gr, K = 2, 32, 20, 32, 16
    rng = np.random.default_rng(6)
    Omega = (rng.random((Bt, N, M)) < 0.5).astype(np.float32)
    subY = _c(rng, Bt, N, M) * Omega
    A = (_c(rng, Bt, N, Gr) / np.sqrt(N)).astype(np.complex64)
    B = (_c(rng, Bt, K, M) / np.sqrt(K)).astype(np.complex64)
    Z = _c(rng, Bt, Gr, K)
    hp = [np.asarray(h) for h in admm_hyperparams(T(subY), T(Z))]

    def f(sy, om, a, b, ty, ts, rh):
        return jadmm.proposed_admm(sy, om, a, b, 25, ty, ts, rh, svt_method=svt_method).S

    want = np.asarray(jax.vmap(f)(subY, Omega, A, B, *hp))
    got = proposed_admm(T(subY), T(Omega), T(A), T(B), 25, *map(T, hp),
                        svt_method=svt_method, use_kernels=False).S.numpy()
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()
    again = proposed_admm(T(subY), T(Omega), T(A), T(B), 25, *map(T, hp), svt_method=svt_method).S
    np.testing.assert_array_equal(again.numpy(), got)  # on the CPU the wrappers run the plain versions
