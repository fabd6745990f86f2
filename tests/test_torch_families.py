"""The errorVSsnr families of the port against the JAX package: the Jacobi
eigensolver and its SVT, the proposed ADMM on 'jacobi', the greedy pursuits
(OMP on a Gram and on the implicit Kronecker Gram, single-vector OMP,
TD-OMP, CoSaMP), the SVT and ADMM completions, the omp_td/svt/tssr branches
of the pipeline, ``time_comparisons`` and ``bench_all`` on the CPU, and the
NaN of a VAMP point whose activity β exceeds 1.

Inputs come from numpy seeds (or JAX's own draws) and go through both
packages; ensemble checks hold the port to ``results/torch_families_jax.json``
(``tools/torch_families_reference.py``) within 4 combined standard errors."""
import importlib
import json
import math
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.core import prng as jprng  # noqa: E402
from jstsp19_tpu.core.metrics import clamped_nmse as jclamped  # noqa: E402
from jstsp19_tpu.frontend import hbf as jhbf  # noqa: E402
from jstsp19_tpu.harness import pipeline as jpipe  # noqa: E402
from jstsp19_tpu.ops import jacobi as jjac  # noqa: E402
from jstsp19_tpu.solvers import admm as jadmm  # noqa: E402
from jstsp19_tpu.solvers import estim as jestim  # noqa: E402
from jstsp19_tpu.solvers import lowrank as jlow  # noqa: E402
from jstsp19_tpu.solvers import vamp as jvamp  # noqa: E402
from jstsp19_torch import bench_all  # noqa: E402
from jstsp19_torch.core import prng  # noqa: E402
from jstsp19_torch.core.metrics import clamped_nmse  # noqa: E402
from jstsp19_torch.harness import pipeline  # noqa: E402
from jstsp19_torch.harness.experiments import EXPERIMENTS  # noqa: E402
from jstsp19_torch.ops import jacobi  # noqa: E402
from jstsp19_torch.solvers import admm, estim, lowrank, vamp  # noqa: E402

jomp = importlib.import_module("jstsp19_tpu.solvers.omp")  # the package re-exports a function `omp`
omp = importlib.import_module("jstsp19_torch.solvers.omp")

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = json.loads((ROOT / "results" / "torch_families_jax.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These batches are small: one intra-op thread each, so that the suite's
    parallel workers do not oversubscribe the cores (OpenMP threads spinning
    on small linear-algebra calls made these tests 100 times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def T(x):
    return torch.from_numpy(np.array(x))


def _c(rng, *s):
    return ((rng.standard_normal(s) + 1j * rng.standard_normal(s)) / np.sqrt(2)).astype(np.complex64)


def _herm(seed, batch, n):
    B = _c(np.random.default_rng(seed), batch, n, n)
    return ((B + np.conj(np.transpose(B, (0, 2, 1)))) / 2).astype(np.complex64)


# ---- the Jacobi eigensolver -----------------------------------------------------


def test_jacobi_eigh_matches_lapack_and_jax():
    """(4, 32, 32): eigenvalues within 2e-4·max|w| of LAPACK's (float64)
    and of JAX's jacobi_eigh; V·diag(w)·Vᴴ within 1e-4·max|A| of A and VᴴV
    within 1e-4 of I (as tests/test_jacobi.py holds the JAX solver)."""
    A = _herm(0, 4, 32)
    w, V = jacobi.jacobi_eigh(T(A), sweeps=10)
    w, V = w.numpy(), V.numpy()
    w_lapack = np.linalg.eigvalsh(A.astype(np.complex128))
    w_jax, _ = jjac.jacobi_eigh(jnp.asarray(A), sweeps=10)
    scale = np.abs(w_lapack).max()
    np.testing.assert_allclose(w, w_lapack, atol=2e-4 * scale)
    np.testing.assert_allclose(w, np.asarray(w_jax), atol=2e-4 * scale)
    assert np.all(np.diff(w, axis=-1) >= 0)
    Vh = np.conj(np.transpose(V, (0, 2, 1)))
    np.testing.assert_allclose((V * w[..., None, :]) @ Vh, A, atol=1e-4 * np.abs(A).max())
    np.testing.assert_allclose(Vh @ V, np.broadcast_to(np.eye(32), V.shape), atol=1e-4)


def test_jacobi_eigh_sorts_ties_stably_and_refuses_odd_n():
    """A diagonal matrix with repeated entries (ties in the sort, a_pq = 0
    in every rotation): the eigenvalues and the eigenvectors equal JAX's
    exactly, the tied columns in the order of jnp.argsort's stable sort;
    odd n raises, as in JAX."""
    d = np.array([3.0, 1.0, 3.0, 1.0, 2.0, 1.0], np.float32)
    A = np.diag(d).astype(np.complex64)[None]
    w, V = jacobi.jacobi_eigh(T(A))
    w_j, V_j = jjac.jacobi_eigh(jnp.asarray(A))
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))
    np.testing.assert_array_equal(V.numpy(), np.asarray(V_j))
    np.testing.assert_array_equal(w.numpy()[0], np.sort(d))
    with pytest.raises(ValueError, match="even"):
        jacobi.jacobi_eigh(T(_herm(1, 2, 5)))


@pytest.mark.parametrize("shape", [(3, 32, 140), (2, 40, 16)])
def test_svt_jacobi_matches_jax(shape):
    """Wide and tall inputs at τ = 5: within 2e-3·max|SVT| of JAX's
    svt_jacobi and of the eigh SVT (tests/test_jacobi.py's limit); a matrix
    with a NaN entry maps to zeros."""
    Y = _c(np.random.default_rng(2), *shape) * np.sqrt(2)
    got = jacobi.svt_jacobi(T(Y), 5.0, sweeps=10).numpy()
    want = np.asarray(jjac.svt_jacobi(jnp.asarray(Y), 5.0, sweeps=10))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-3 * scale)
    np.testing.assert_allclose(got, lowrank.svt(T(Y), 5.0).numpy(), atol=2e-3 * scale)
    Y[0, 1, 2] = np.nan
    out = jacobi.jacobi_svt_fn(T(Y), 5.0).numpy()
    assert np.all(out[0] == 0) and np.all(np.isfinite(out))
    assert jacobi.JACOBI_SVT_SWEEPS == jjac.JACOBI_SVT_SWEEPS


def test_proposed_admm_jacobi_matches_jax():
    """The proposed ADMM with svt_method='jacobi' at the canonical widths,
    B=2, Imax=5 (the kernels' plain versions on the CPU): S within
    2e-4·max|S| of JAX's (the limit of the port's other ADMM routes)."""
    imax = 5
    rng = np.random.default_rng(3)
    Bt, N, M, Gr, K = 2, 32, 140, 32, 16
    Om = (rng.random((Bt, N, M)) < 0.5).astype(np.float32)
    sub = _c(rng, Bt, N, M) * Om
    A, B, Z = _c(rng, Bt, N, Gr) / np.sqrt(N), _c(rng, Bt, K, M) / np.sqrt(K), _c(rng, Bt, Gr, K)
    hp = [jadmm.admm_hyperparams(jnp.asarray(sub[b]), jnp.asarray(Z[b])) for b in range(Bt)]
    args = [sub, Om, A.astype(np.complex64), B.astype(np.complex64),
            *(np.stack([np.asarray(h[i]) for h in hp]).astype(np.float32) for i in range(3))]
    f = lambda sy, om, a, b, ty, ts, rh: jadmm.proposed_admm(  # noqa: E731
        sy, om, a, b, imax, ty, ts, rh, svt_method="jacobi").S
    want = np.asarray(jax.vmap(f)(*args))
    got = admm.proposed_admm(*map(T, args[:4]), imax, *map(T, args[4:]), svt_method="jacobi").S.numpy()
    assert np.max(np.abs(got - want)) < 2e-4 * np.max(np.abs(want))


# ---- greedy pursuits ---------------------------------------------------------------


def _planted(seed, Bt=3, M=64, n=128, k=5, snr_db=40.0):
    """A (Bt, M, n) with unit columns, k-sparse x with coefficients ≈ 3 (a
    clear gap over the noise), v = A·x + noise."""
    rng = np.random.default_rng(seed)
    A = _c(rng, Bt, M, n)
    A /= np.linalg.norm(A, axis=-2, keepdims=True)
    x = np.zeros((Bt, n), np.complex64)
    supp = np.stack([rng.choice(n, k, replace=False) for _ in range(Bt)])
    for b in range(Bt):
        x[b, supp[b]] = _c(rng, k) * 3
    v = (np.einsum("bmn,bn->bm", A, x) + _c(rng, Bt, M) * 10 ** (-snr_db / 20)).astype(np.complex64)
    return A, x, v, supp


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("which", ["omp", "omp_gram"])
def test_omp_recovers_planted_support_as_jax_does(which):
    A, x, v, supp = _planted(0)
    if which == "omp":
        got = omp.omp(T(A), T(v), 5)
        want = jax.vmap(lambda a, y: jomp.omp(a, y, 5))(A, v)
    else:
        AhA = np.conj(np.transpose(A, (0, 2, 1))) @ A
        Ahv = np.einsum("bmn,bm->bn", A.conj(), v)
        got = omp.omp_gram(T(AhA), T(Ahv), 5)
        want = jax.vmap(lambda g, y: jomp.omp_gram(g, y, 5))(AhA, Ahv)
    np.testing.assert_array_equal(got.support.numpy(), np.asarray(want.support))
    assert all(set(s) == set(p) for s, p in zip(got.support.numpy(), supp))
    assert _rel(got.x.numpy(), np.asarray(want.x)) < 1e-4
    assert got.support.dtype == torch.int32 and got.x.shape == (3, 128)


def test_omp_td_recovers_planted_support_as_jax_does():
    """Three planted (Gr, K) entries, k = 3: the same support sequence and
    x within 1e-4 relative of JAX's, as the (Gr, K) matrix; omp_gram_kron
    on its own Grams gives the same atoms."""
    rng = np.random.default_rng(4)
    Bt, N, Gr, K, Tn = 3, 12, 8, 6, 10
    A, B = _c(rng, Bt, N, Gr), _c(rng, Bt, K, Tn)
    S = np.zeros((Bt, Gr, K), np.complex64)
    S[:, 1, 2], S[:, 5, 0], S[:, 3, 4] = 2.0, -1.5j, 1 + 1j
    Y = A @ S @ B
    got = omp.omp_td(T(A), T(B), T(Y), 3)
    want = jax.vmap(lambda a, b, y: jomp.omp_td(a, b, y, 3))(A, B, Y)
    assert got.x.shape == (Bt, Gr, K)
    np.testing.assert_array_equal(got.support.numpy(), np.asarray(want.support))
    assert _rel(got.x.numpy(), np.asarray(want.x)) < 1e-4
    assert _rel(got.x.numpy(), S) < 1e-4
    GA = np.conj(np.transpose(A, (0, 2, 1))) @ A
    GB = np.conj(B @ np.conj(np.transpose(B, (0, 2, 1))))
    C0 = np.conj(np.transpose(A, (0, 2, 1))) @ Y @ np.conj(np.transpose(B, (0, 2, 1)))
    kron = omp.omp_gram_kron(T(GA), T(GB), T(C0), 3)
    np.testing.assert_array_equal(kron.support.numpy(), got.support.numpy())


def test_omp_gram_kron_matches_dense_kron_and_jax():
    """Random (not sparse) data, 25 steps: the implicit-Kronecker core picks
    the dense-Gram core's atoms in the same order, and JAX's, with
    coefficients within 1e-4 relative (tests/test_omp.py's check)."""
    rng = np.random.default_rng(17)
    na, nb, M, Tn, k = 16, 8, 12, 20, 25
    A, B, Y = _c(rng, M, na), _c(rng, nb, Tn), _c(rng, M, Tn)
    GA = A.conj().T @ A
    GB = np.conj(B @ B.conj().T)
    C0 = A.conj().T @ Y @ B.conj().T
    got = omp.omp_gram_kron(T(GA), T(GB), T(C0), k)
    dense = omp.omp_gram(T(np.kron(GA, GB)), T(C0.reshape(-1)), k)
    want = jomp.omp_gram_kron(jnp.asarray(GA), jnp.asarray(GB), jnp.asarray(C0), k)
    np.testing.assert_array_equal(got.support.numpy(), dense.support.numpy())
    np.testing.assert_array_equal(got.support.numpy(), np.asarray(want.support))
    assert _rel(got.x.numpy(), dense.x.numpy()) < 1e-4
    assert _rel(got.x.numpy(), np.asarray(want.x)) < 1e-4


def test_omp_gram_degenerate_atoms_guarded():
    """Duplicated atoms (columns j and j+6 equal) drive the Schur complement
    to 0: the rank guard keeps x finite and A·x = v within 1e-4, as
    tests/test_omp.py::test_omp_gram_degenerate_atoms_guarded holds JAX."""
    rng = np.random.default_rng(5)
    M, n = 24, 12
    half = rng.standard_normal((M, n // 2)) + 1j * rng.standard_normal((M, n // 2))
    A = (np.concatenate([half, half], axis=1) / np.sqrt(2 * M)).astype(np.complex64)
    x = np.zeros(n, np.complex64)
    x[1], x[4] = 2.0, -1.0 + 0.5j
    v = (A @ x).astype(np.complex64)
    res = omp.omp(T(A)[None], T(v)[None], 6)
    xh = res.x.numpy()[0]
    assert np.all(np.isfinite(xh))
    assert np.linalg.norm(A @ xh - v) / np.linalg.norm(v) < 1e-4
    want = jomp.omp(jnp.asarray(A), jnp.asarray(v), 6)
    assert np.linalg.norm(A @ np.asarray(want.x) - v) / np.linalg.norm(v) < 1e-4


def test_cosamp_recovers_planted_support_as_jax_does():
    A, x, v, supp = _planted(6, snr_db=30.0)
    got = omp.cosamp(T(A), T(v), 5).numpy()
    want = np.asarray(jax.vmap(lambda a, y: jomp.cosamp(a, y, 5))(A, v))
    for b in range(3):
        assert set(np.flatnonzero(got[b])) == set(np.flatnonzero(want[b])) == set(supp[b])
    assert _rel(got, want) < 1e-4


def test_omp_td_on_canonical_draws_matches_jax():
    """JAX's conventional-branch draws of the canonical point (4
    realizations, 0 dB, T_hbf = 16): TD-OMP with num_nonzero = 100 atoms
    over 512.  Per-realization clamped NMSE within 2e-3 of JAX's (measured
    5.4e-7 on these draws, whose 100-atom supports equal JAX's; on other
    draws the supports may part where two scores nearly tie)."""
    pc = jpipe.PointConfig()
    keys = jprng.realization_keys(jprng.experiment_key(2), 0, 4)
    Th = pc.T_hbf

    def draw(key):
        ch, Psi, N, W = jpipe._system_realization(key, pc, jnp.float32(1.0))
        Y, W_c = jhbf(ch.H, N[:, :Th], Psi[:, :, :Th], pc.Nr, W)
        A, B = jpipe._dictionaries(ch, W_c, Psi[:, :, :Th])
        return Y, A, B, ch.Zbar

    Y, A, B, Zbar = (np.asarray(a) for a in jax.vmap(draw)(keys))
    want = np.asarray(jax.vmap(lambda y, a, b, z: jclamped(jomp.omp_td(a, b, y, 100).x, z))(Y, A, B, Zbar))
    got = clamped_nmse(omp.omp_td(T(A), T(B), T(Y), 100).x, T(Zbar)).numpy()
    assert np.all(np.isfinite(got)) and np.all((got >= 0) & (got <= 1))
    assert np.max(np.abs(got - want)) < 2e-3


# ---- completions ------------------------------------------------------------------


def _completion(seed=3, Bt=2, N=16, M=40):
    rng = np.random.default_rng(seed)
    X0 = (_c(rng, Bt, N, 3) @ _c(rng, Bt, 3, M) / 3).astype(np.complex64)
    Om = (rng.uniform(size=(Bt, N, M)) < 0.6).astype(np.float32)
    OH = (Om * X0).astype(np.complex64)
    tau = (1.0 / np.sum(np.abs(OH) ** 2, axis=(-2, -1))).astype(np.float32)
    return X0, OH, Om, tau


@pytest.mark.parametrize("svt_method", ["eigh", "tracked", "jacobi"])
def test_mc_svt_matches_jax(svt_method):
    """Imax=10, ρ = 0.1, τ per realization: X within 1e-4·max|X| of JAX's."""
    _, OH, Om, tau = _completion()
    want = np.asarray(jax.vmap(lambda o, m, t: jlow.mc_svt(o, m, 10, t, 0.1, svt_method=svt_method))(OH, Om, tau))
    got = lowrank.mc_svt(T(OH), T(Om), 10, T(tau), 0.1, svt_method=svt_method).numpy()
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("svt_method", ["eigh", "tracked", "jacobi"])
def test_mc_admm_matches_jax(svt_method):
    """Imax=10, ρ = 1 and τ per realization: X within 1e-4·max|X| of JAX's
    and the per-iteration NMSE, laid out (batch, Imax), within 1e-4."""
    X0, OH, Om, tau = _completion(5)
    rho = np.array([1.0, 0.5], np.float32)
    Xj, ej = jax.vmap(lambda h, o, m, t, r: jlow.mc_admm(h, o, m, 10, t, r, svt_method=svt_method))(
        X0, OH, Om, tau, rho)
    X, e = lowrank.mc_admm(T(X0), T(OH), T(Om), 10, T(tau), T(rho), svt_method=svt_method)
    assert e.shape == (2, 10)
    assert _rel(X.numpy(), np.asarray(Xj)) < 1e-4
    np.testing.assert_allclose(e.numpy(), np.asarray(ej), atol=1e-4)


def test_completions_refuse_an_unknown_svt():
    _, OH, Om, tau = _completion()
    for fn in (lambda: lowrank.mc_svt(T(OH), T(Om), 2, T(tau), 0.1, svt_method="qr"),
               lambda: lowrank.mc_admm(T(OH), T(OH), T(Om), 2, T(tau), 1.0, svt_method="fused")):
        with pytest.raises(ValueError, match="unknown svt_method"):
            fn()


# ---- the pipeline, the recipe and the bench -------------------------------------


def _z(got: np.ndarray, ref_mean, ref_sd, ref_n) -> float:
    se = math.sqrt(ref_sd**2 / ref_n + got.var(ddof=1) / got.size)
    return (got.mean() - ref_mean) / se


def test_realization_errors_runs_the_new_families_within_4_se_of_jax():
    """omp_td, svt and tssr at the canonical 0 dB point, B=32, on CPU
    generators ('eigh', as error_vs_snr runs them): finite values in [0, 1],
    tssr = svt where 2·nnz saturates at Gr, each batch mean within 4 SE of
    results/torch_families_jax.json; 'tracked' gives the same completion
    NMSE within 1e-3."""
    gens = prng.realization_generators(0, 5, "cpu")
    pc = pipeline.PointConfig(methods=("omp_td", "svt", "tssr"))
    out = {m: e.double().numpy() for m, e in pipeline.realization_errors(gens, pc, 1.0, 32).items()}
    ref = REF["error_vs_snr"]["curves"]
    i = REF["error_vs_snr"]["sweep"]["snr_db"].index(0.0)
    for m in pc.methods:
        e = out[m]
        assert e.shape == (32,) and np.all(np.isfinite(e)) and e.min() >= 0 and e.max() <= 1
        assert abs(_z(e, ref[m]["mean"][i], ref[m]["sd"][i], ref[m]["n"][i])) < 4, m
    np.testing.assert_allclose(out["tssr"], out["svt"], atol=1e-5)
    tr = pipeline.realization_errors(prng.realization_generators(0, 5, "cpu"),
                                     pipeline.PointConfig(methods=("svt",), svt_method="tracked"), 1.0, 32)
    np.testing.assert_allclose(tr["svt"].double().numpy(), out["svt"], atol=1e-3)


def test_mc_admm_family_within_4_se_of_jax():
    """bench_all's mc_admm family at the canonical 0 dB point, B=32, CPU
    generators: within 4 SE of the JAX family's mean (n 256)."""
    e = bench_all.mc_admm_errors(prng.realization_generators(0, 0, "cpu"), 1.0, 32).double().numpy()
    r = REF["mc_admm"]
    assert np.all(np.isfinite(e)) and e.min() >= 0 and e.max() <= 1
    assert abs(_z(e, r["mean"], r["sd"], r["n"])) < 4


def test_fastest_point_config_names_the_card_routes():
    """'fused' for the proposed methods (where JAX names 'tracked'),
    'tracked' for svt/tssr as JAX, 'eigh' for the rest as JAX."""
    for m in ("ls", "vamp", "omp_mmv", "omp_td", "svt", "tssr", "proposed", "proposed_angles"):
        got, want = pipeline.fastest_point_config(m), jpipe.fastest_point_config(m)
        assert got.methods == want.methods == (m,)
        assert got.svt_method == ("fused" if m.startswith("proposed") else want.svt_method)


def test_time_comparisons_on_the_cpu():
    res = EXPERIMENTS["time_comparisons"](n_mc=2, device="cpu", reps=1)
    assert set(res.curves) == {"ls", "vamp", "omp_mmv", "proposed", "proposed_angles", "svt", "tssr"}
    assert all(len(v) == 1 and v[0] > 0 for v in res.curves.values())
    assert res.extras["device"] == "cpu" and "bench_all" in res.extras["note"]
    assert "est/s" not in res.extras["note"]


def test_bench_all_writes_its_table_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "b.json"
    rc = bench_all.main(["--cpu", "--batch", "2", "--reps", "1", "--batches", "1",
                         "--methods", "omp_td,mc_admm", "--out", str(out)])
    assert rc == 0
    d = json.loads(out.read_text())
    assert set(d["methods"]) == {"omp_td", "mc_admm"}
    for row in d["methods"].values():
        assert row["est_per_sec"] > 0 and row["vs_matlab"] == row["est_per_sec"]
        assert row["reps"] == 1 and set(row["latency_best_s"]) == {"1"}
    assert "omp_td" in capsys.readouterr().out
    assert bench_all.main(["--cpu", "--methods", "nope"]) == 1


# ---- β > 1: NaN, as in JAX -------------------------------------------------------


def test_sparse_prior_with_activity_above_one_gives_nan_as_jax():
    """β = num_nonzero/(2·Gr·K) = 100/64 = 1.56 (Gr=8, K=4): log1p(−β) is
    NaN in JAX; the port's SparsePrior and vamp_mmwave now give NaN where
    JAX's do, instead of raising a math domain error."""
    beta = 100 / (2 * 8 * 4)
    rng = np.random.default_rng(9)
    r = _c(rng, 2, 8)
    xj, _ = jestim.SparsePrior(jestim.CAwgnPrior(0.0, 1.0 / beta), beta).estim(jnp.asarray(r), 0.5)
    xt, _ = estim.SparsePrior(estim.CAwgnPrior(0.0, 1.0 / beta), beta).estim(T(r), 0.5)
    assert np.all(np.isnan(np.asarray(xj))) and torch.isnan(xt).all()
    Y, A, Bm = _c(rng, 2, 8, 16), _c(rng, 2, 8, 8), _c(rng, 2, 4, 16)
    want = np.asarray(jax.vmap(lambda y, a, b: jvamp.vamp_mmwave(y, a, b, 1.0, 100, nit=3))(Y, A, Bm))
    got = vamp.vamp_mmwave(T(Y), T(A), T(Bm), 1.0, 100, nit=3)
    assert got.shape == (2, 8, 4)
    np.testing.assert_array_equal(torch.isnan(got).numpy(), np.isnan(want))
    assert np.isnan(want).any()
