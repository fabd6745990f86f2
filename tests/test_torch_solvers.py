"""The port's solvers/ and ops/ against the JAX package on the same inputs.

Problems come from a numpy seed, as in tests/test_fused_admm.py:24-38
(canonical widths, Imax=25, B=2)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.ops import jacobi as jjac  # noqa: E402
from jstsp19_tpu.ops.tracked import make_tracked_svt as jmake  # noqa: E402
from jstsp19_tpu.solvers import admm as jadmm  # noqa: E402
from jstsp19_tpu.solvers.lowrank import svt as jsvt  # noqa: E402
from jstsp19_tpu.solvers.sparse import soft_threshold as jsoft  # noqa: E402
from jstsp19_torch import interop  # noqa: E402
from jstsp19_torch.ops import jacobi  # noqa: E402
from jstsp19_torch.ops.tracked import make_tracked_svt  # noqa: E402
from jstsp19_torch.solvers import admm  # noqa: E402
from jstsp19_torch.solvers.lowrank import svt  # noqa: E402
from jstsp19_torch.solvers.sparse import soft_threshold  # noqa: E402

Bt, N, M, Gr, K = 2, 32, 140, 32, 16
IMAX = 25


def T(x):
    return torch.from_numpy(np.array(x))


def _c(rng, *s):
    return (rng.standard_normal(s) + 1j * rng.standard_normal(s)).astype(np.complex64)


def _problem(seed=0):
    """numpy (subY, Omega, A, B, tau_Y, tau_S, rho), hyper-parameters by JAX."""
    rng = np.random.default_rng(seed)
    Omega = (rng.random((Bt, N, M)) < 0.5).astype(np.float32)
    subY = _c(rng, Bt, N, M) * Omega
    A = (_c(rng, Bt, N, Gr) / np.sqrt(N)).astype(np.complex64)
    B = (_c(rng, Bt, K, M) / np.sqrt(K)).astype(np.complex64)
    Z = _c(rng, Bt, Gr, K)
    hp = [jadmm.admm_hyperparams(jnp.asarray(subY[b]), jnp.asarray(Z[b])) for b in range(Bt)]
    tau_Y, tau_S, rho = (np.stack([np.asarray(h[i]) for h in hp]).astype(np.float32) for i in range(3))
    return subY, Omega, A, B, tau_Y, tau_S, rho


def _rank(seed=7):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(Gr * K).reshape(Gr, K) for _ in range(Bt)]).astype(np.int32)


def _jax_admm(args, rank=None, **kw):
    if rank is None:
        f = lambda sy, om, a, b, ty, ts, rh: jadmm.proposed_admm(sy, om, a, b, IMAX, ty, ts, rh, **kw).S  # noqa: E731
        return np.asarray(jax.vmap(f)(*args))
    f = lambda sy, om, a, b, ty, ts, rh, rk: jadmm.proposed_admm(  # noqa: E731
        sy, om, a, b, IMAX, ty, ts, rh, support_rank=rk, **kw).S
    return np.asarray(jax.vmap(f)(*args, rank))


def test_schedule_tables_equal_jax():
    for n in (2, 4, 16, 32):
        np.testing.assert_array_equal(jacobi._round_robin_schedule(n), jjac._round_robin_schedule(n))
        for a, b in zip(jacobi._schedule_gather_tables(n), jjac._schedule_gather_tables(n)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        jacobi._round_robin_schedule(5)


def test_soft_threshold_matches_jax():
    v = _c(np.random.default_rng(0), 3, 32, 16)
    tau = np.array([0.1, 0.5, 1.0], np.float32)
    got = soft_threshold(T(v), T(tau)[:, None, None]).numpy()
    want = np.asarray(jsoft(jnp.asarray(v), jnp.asarray(tau)[:, None, None]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("shape", [(32, 140), (40, 24)])
def test_svt_matches_jax(shape):
    """Eigh-based: PyTorch's and XLA's float32 Hermitian eigensolvers return
    bases that differ by phases and rounding; the shrunk matrix is basis-free
    and agrees to ~1e-6 relative, checked at 1e-4."""
    rng = np.random.default_rng(1)
    Y = _c(rng, 3, *shape)
    tau = np.array([1.0, 5.0, 20.0], np.float32)
    got = svt(T(Y), T(tau)).numpy()
    want = np.asarray(jsvt(jnp.asarray(Y), jnp.asarray(tau)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    Y[1, 0, 0] = np.nan  # the matrix-level NaN reset, per batch element
    out = svt(T(Y), T(tau)).numpy()
    assert np.all(out[1] == 0) and np.all(np.isfinite(out))


def test_admm_hyperparams_match_jax():
    """Eigh-based (ρ uses the 6th-largest Gram eigenvalue): 1e-4 relative,
    the agreement of two float32 eigensolvers; τ_Y, τ_S are sums (1e-5)."""
    rng = np.random.default_rng(2)
    for shape in ((32, 140), (140, 32), (4, 3)):
        Y, Z = _c(rng, 2, *shape), _c(rng, 2, 32, 16)
        got = admm.admm_hyperparams(T(Y), T(Z))
        want = jax.vmap(jadmm.admm_hyperparams)(Y, Z)
        for g, w, rtol in zip(got, want, (1e-5, 1e-5, 1e-4)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol)


@pytest.mark.parametrize("flip", [False, True])
def test_tracked_svt_step_matches_jax(flip):
    """One tracked step from the identity basis and from a rotated basis,
    including the thin-side transpose for N > M."""
    n, m = (24, 16) if flip else (16, 24)
    rng = np.random.default_rng(3)
    W = _c(rng, n, m)
    U0, step = make_tracked_svt(n, m, torch.complex64, 2)
    jU0, jstep = jmake(n, m, jnp.complex64, 2, "highest")
    X, U = step(T(W), 0.5, U0, 3)
    jX, jU = jstep(jnp.asarray(W), 0.5, jU0, 3)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(U.numpy(), np.asarray(jU), rtol=1e-5, atol=2e-6)
    X2, _ = step(T(W), 0.5, U, 4)
    jX2, _ = jstep(jnp.asarray(W), 0.5, jU, 4)
    np.testing.assert_allclose(X2.numpy(), np.asarray(jX2), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("svt_method", ["eigh", "tracked"])
@pytest.mark.parametrize("with_rank", [False, True])
def test_proposed_admm_matches_jax(svt_method, with_rank):
    """max|ΔS| < 2e-4·max|S| at Imax=25 (tests/test_fused_admm.py:51-53):
    the same fp32 iteration in two frameworks, sums in other orders."""
    args = _problem(int(with_rank))
    rank = _rank() if with_rank else None
    ref = _jax_admm(args, rank, svt_method=svt_method)
    S = admm.proposed_admm(
        *map(T, args[:4]), IMAX, *map(T, args[4:]), svt_method=svt_method,
        support_rank=None if rank is None else T(rank)).S.numpy()
    assert np.max(np.abs(S - ref)) < 2e-4 * np.max(np.abs(ref))


def test_proposed_admm_exact_mode_matches_jax():
    """Exact mode: pinv-based least squares (SVD-based pinv in both
    frameworks) on a denser mask; same tolerance as the approximate mode."""
    args = list(_problem(4))
    ref = _jax_admm(args, None, mode="exact")
    S = admm.proposed_admm(*map(T, args[:4]), IMAX, *map(T, args[4:]), mode="exact").S.numpy()
    assert np.max(np.abs(S - ref)) < 2e-4 * np.max(np.abs(ref))


@pytest.mark.parametrize("svt_method", ["eigh", "tracked"])
def test_warm_restart_30_plus_30_equals_60(svt_method):
    """The state carries U and the global iteration count, so a resumed
    run is the same computation (tests/test_admm.py:122,216)."""
    subY, Omega, A, B, tau_Y, tau_S, rho = map(T, _problem(5))
    kw = dict(svt_method=svt_method)
    full = admm.proposed_admm(subY, Omega, A, B, 60, tau_Y, tau_S, rho, **kw)
    half = admm.proposed_admm(subY, Omega, A, B, 30, tau_Y, tau_S, rho, **kw)
    assert half.state.it == 30 and (half.state.U is not None) == (svt_method == "tracked")
    # carried across the numpy bridge, as a JAX state would be
    state = interop.state_to_torch(interop.state_to_numpy(half.state))
    rest = admm.proposed_admm(subY, Omega, A, B, 30, tau_Y, tau_S, rho, init_state=state, **kw)
    assert rest.state.it == 60
    torch.testing.assert_close(rest.S, full.S, rtol=1e-6, atol=1e-6)


def test_warm_restart_from_jax_state_matches_jax():
    """A JAX tracked state after 10 iterations, carried across with interop,
    resumes in the port as JAX resumes it."""
    args = _problem(6)
    one = [jnp.asarray(a[0]) for a in args]
    half = jadmm.proposed_admm(*one[:4], 10, *one[4:], svt_method="tracked")
    ref = jadmm.proposed_admm(*one[:4], 15, *one[4:], svt_method="tracked", init_state=half.state)
    st = interop.state_to_torch(half.state)
    assert st.it == 10 and st.U.shape == (N, N)
    got = admm.proposed_admm(*(T(a[0]) for a in args[:4]), 15, *(T(a[0]) for a in args[4:]),
                             svt_method="tracked", init_state=st)
    ref_S = np.asarray(ref.S)
    assert np.max(np.abs(got.S.numpy() - ref_S)) < 2e-4 * np.max(np.abs(ref_S))


def test_convergence_log_matches_jax():
    """ε1, ε2 are spectral-norm ratios (eigh, 1e-3 relative after 25
    iterations of float32 drift); ε3 is the SD-step ratio."""
    args = _problem(8)
    one = [a[0] for a in args]
    ref = jadmm.proposed_admm(*map(jnp.asarray, one[:4]), IMAX, *map(jnp.asarray, one[4:]),
                              track_convergence=True, conv_norm="fro").convergence
    got = admm.proposed_admm(*map(T, one[:4]), IMAX, *map(T, one[4:]),
                             track_convergence=True, conv_norm="fro").convergence
    assert got.shape == (IMAX, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-7)


def test_support_rank_from_order_matches_jax():
    rng = np.random.default_rng(9)
    order = np.stack([rng.permutation(Gr * K) for _ in range(3)]).astype(np.int32)
    got = admm.support_rank_from_order(T(order), Gr * K).numpy()
    want = np.asarray(jax.vmap(lambda o: jadmm.support_rank_from_order(o, Gr * K))(order))
    np.testing.assert_array_equal(got, want)


def test_proposed_admm_angles_matches_jax():
    args = _problem(10)
    Z = _c(np.random.default_rng(11), Bt, Gr, K)
    indx = np.argsort(-np.abs(Z).reshape(Bt, -1), axis=-1, kind="stable").astype(np.int32)
    f = lambda sy, om, ix, a, b, ty, ts, rh: jadmm.proposed_admm_angles(  # noqa: E731
        sy, om, ix, a, b, IMAX, ty, ts, rh, svt_method="tracked").S
    ref = np.asarray(jax.vmap(f)(args[0], args[1], indx, *args[2:]))
    S = admm.proposed_admm_angles(T(args[0]), T(args[1]), T(indx), *map(T, args[2:4]), IMAX,
                                  *map(T, args[4:]), svt_method="tracked").S.numpy()
    assert np.max(np.abs(S - ref)) < 2e-4 * np.max(np.abs(ref))


def test_unported_and_unknown_options_raise():
    args = [T(a) for a in _problem(0)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        admm.proposed_admm(*args[:4], 1, *args[4:], svt_method="jacobi")
    with pytest.raises(ValueError):
        admm.proposed_admm(*args[:4], 1, *args[4:], svt_method="qr")
    with pytest.raises(ValueError):
        admm.proposed_admm(*args[:4], 1, *args[4:], mode="lu")
