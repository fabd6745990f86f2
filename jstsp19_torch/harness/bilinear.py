"""The problems and settings of the bilinear solvers' checks.

Each problem is made as numpy, one seed a realization, so that the JAX
reference tool (``tools/torch_bilinear_reference.py``), the tests and
``chip_smoke.py`` solve the same inputs.  Every problem set holds B = 256
realizations at the sizes the repo's examples and tests document, nothing
cut:

* :func:`mc_problems`: ``examples/matrix_completion.py:23-37`` (48 × 64,
  rank 3, half observed, noise variance 1e-3) for ``bigamp_mc``;
* :func:`dl_mc_problems`: ``examples/dictionary_learning.py:36-54`` (64 ×
  64, rank 4, half observed, 1e-4) for ``em_bigamp_mc`` and ``bigamp_lite``,
  and the same construction (``tests/test_bigamp_full.py:17-57``) for
  ``bigamp_pev``;
* :func:`dl_problems`: ``examples/dictionary_learning.py:63-73`` (24 × 400,
  5 atoms, activity 0.15, 40 dB) for ``em_bigamp_dl``;
* :func:`rpca_problems`: ``tests/test_bigamp.py:52-70`` (40 × 50, rank 2, 5%
  outliers of variance 50) for ``bigamp_rpca``;
* :func:`x2_problems`: ``tests/test_bigamp_full.py:60-96`` (64 × 64, rank
  4, a known 64 × 32 A2 with 10%-sparse X2) for ``bigamp_pev``'s X2 branch;
* :func:`hsi_problems`: ``examples/hyperspectral_unmixing.py:30-50`` (600
  pixels, 48 bands, 3 endmembers, Dirichlet abundances with 5 pure pixels a
  material, 40 dB) for ``hutamp``;
* :func:`calib_problems`: ``examples/self_calibration.py:34-60`` (M = 96
  gains, Nc = 128, k = 8, gain variance 0.05, 40 dB) for ``pbigamp`` and
  ``em_pbigamp``; the (M, M, Nc) tensor A[m] = e_m·Φ_mᵀ is built from Φ by
  :func:`calib_tensor`;
* :func:`rank_one_problems`: ``examples/rank_one_factorization.py:34-61``
  (m, n = 1000, 500, Gaussian u, the sparse-exponential v on the discrete
  grid of ``rankOneSE.m:53-66``), at 0, 5 and 10 dB.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

BATCH = 256
# one tag a problem set, so that the sets draw from disjoint streams
_TAG = dict(mc=1, dl_mc=2, dl=3, rpca=4, x2=5, hsi=6, calib=7, rank_one=8)

MC = dict(L=48, M=64, R=3, frac=0.5, nv=1e-3)
MC_KW = dict(nit=300, step=0.5)
DL_MC = dict(L=64, M=64, R=4, frac=0.5, nv=1e-4)
EM_MC_KW = dict(max_rank=8, nit=300, n_em=3, step=0.5)
LITE_KW = dict(nit=400, step=0.05)
PEV_NIT, X2_NIT = 300, 400
DL = dict(L=24, R=5, M=400, lam=0.15, snr_db=40.0)
RPCA = dict(L=40, M=50, R=2, frac=0.05, outlier_var=50.0, nv=1e-3)
RPCA_NIT = 300
X2 = dict(L=64, M=64, R=4, N2=32, frac=0.1, nv=1e-4)
HSI = dict(N=600, T=48, R=3, pure=5, snr_db=40.0)
HUTAMP_KW = dict(nit=150, n_em=3, step=0.3)
CALIB = dict(M=96, Nc=128, k=8, gain_var=0.05, snr_db=40.0)
PBIGAMP_KW = dict(nit=200, step=0.5)
RANK_ONE = dict(m=1000, n=500, snrs_db=(0.0, 5.0, 10.0), nit=10, n_samples=8192)

# the JAX tests' own thresholds (NMSE of Z in dB; the rank-one fit's
# squared correlations within 0.1 of the SE), printed as shares
THRESHOLDS_DB = dict(
    bigamp_mc=10 * np.log10(1e-3), em_bigamp_mc=10 * np.log10(1e-2), bigamp_lite=-40.0,
    em_bigamp_dl=10 * np.log10(0.05), bigamp_rpca=10 * np.log10(5e-2), bigamp_pev=-40.0,
    bigamp_pev_x2=-45.0, hutamp=10 * np.log10(0.01), pbigamp=10 * np.log10(0.02), em_pbigamp=-40.0,
)


def _rng(name: str, b: int) -> np.random.Generator:
    return np.random.default_rng([_TAG[name], b])


def _cplx(rng, *shape, var=1.0):
    return np.sqrt(var / 2) * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))


def _stack(probs):
    return {k: np.stack([p[k] for p in probs]) for k in probs[0]}


def nmse_db(zhat, z) -> np.ndarray:
    """Per-realization 10·log10(‖ẑ − z‖² / ‖z‖²) over all but the leading axis."""
    zhat, z = (np.asarray(v).astype(np.complex128).reshape(len(v), -1) for v in (zhat, z))
    return 10 * np.log10((np.abs(zhat - z) ** 2).sum(-1) / (np.abs(z) ** 2).sum(-1))


def _completion(name: str, b: int, L, M, R, frac, nv):
    """Y = mask·(A·X + CN(0, nv)), A and X CN(0, 1), mask Bernoulli(frac)."""
    rng = _rng(name, b)
    A, X = _cplx(rng, L, R), _cplx(rng, R, M)
    Z = A @ X
    mask = (rng.random((L, M)) < frac).astype(np.float32)
    Y = (Z + _cplx(rng, L, M, var=nv)) * mask
    return dict(Y=Y.astype(np.complex64), mask=mask, Z=Z)


def mc_problems(batch: int = BATCH) -> Dict[str, np.ndarray]:
    """``bigamp_mc``'s problems: Y, mask (B, 48, 64), Z (complex128)."""
    return _stack([_completion("mc", b, **MC) for b in range(batch)])


def dl_mc_problems(batch: int = BATCH) -> Dict[str, np.ndarray]:
    """``em_bigamp_mc``'s, ``bigamp_lite``'s and ``bigamp_pev``'s problems:
    Y, mask (B, 64, 64), Z."""
    return _stack([_completion("dl_mc", b, **DL_MC) for b in range(batch)])


def dl_problems(batch: int = BATCH) -> Dict[str, np.ndarray]:
    """``em_bigamp_dl``'s problems: Y (B, 24, 400) = D·C + noise at 40 dB,
    C Bernoulli(0.15)-Gaussian; Z = D·C."""
    probs = []
    for b in range(batch):
        rng = _rng("dl", b)
        D = _cplx(rng, DL["L"], DL["R"])
        C = (rng.random((DL["R"], DL["M"])) < DL["lam"]) * _cplx(rng, DL["R"], DL["M"])
        Z = D @ C
        nv = 10 ** (-DL["snr_db"] / 10) * np.mean(np.abs(Z) ** 2)
        probs.append(dict(Y=(Z + _cplx(rng, DL["L"], DL["M"], var=nv)).astype(np.complex64), Z=Z))
    return _stack(probs)


def rpca_problems(batch: int = BATCH) -> Dict[str, np.ndarray]:
    """``bigamp_rpca``'s problems: Y (B, 40, 50) = A·X + E + CN(0, 1e-3), E
    CN(0, 50) on 5% of the entries; Z = A·X."""
    p = RPCA
    probs = []
    for b in range(batch):
        rng = _rng("rpca", b)
        Z = _cplx(rng, p["L"], p["R"]) @ _cplx(rng, p["R"], p["M"])
        E = np.where(rng.random((p["L"], p["M"])) < p["frac"], _cplx(rng, p["L"], p["M"], var=p["outlier_var"]), 0)
        Y = Z + E + _cplx(rng, p["L"], p["M"], var=p["nv"])
        probs.append(dict(Y=Y.astype(np.complex64), Z=Z))
    return _stack(probs)


def x2_problems(batch: int = BATCH) -> Dict[str, np.ndarray]:
    """``bigamp_pev``'s X2 problems: Y (B, 64, 64) = A·X + A2·X2 + noise,
    A2 (B, 64, 32) CN(0, 1/L), X2 10%-sparse CN(0, 1); Z, X2 (complex128)."""
    p = X2
    probs = []
    for b in range(batch):
        rng = _rng("x2", b)
        A2 = _cplx(rng, p["L"], p["N2"], var=1.0 / p["L"])
        X2t = (rng.random((p["N2"], p["M"])) < p["frac"]) * _cplx(rng, p["N2"], p["M"])
        Z = _cplx(rng, p["L"], p["R"]) @ _cplx(rng, p["R"], p["M"]) + A2 @ X2t
        Y = Z + _cplx(rng, p["L"], p["M"], var=p["nv"])
        probs.append(dict(Y=Y.astype(np.complex64), A2=A2.astype(np.complex64), Z=Z, X2=X2t))
    return _stack(probs)


def endmembers(T: int = HSI["T"]) -> np.ndarray:
    """The example's three smooth positive spectra, (3, T) float32."""
    t = np.linspace(0, 1, T)
    return np.stack([
        0.2 + np.exp(-0.5 * ((t - 0.25) / 0.08) ** 2),
        0.3 + 0.8 * np.exp(-0.5 * ((t - 0.6) / 0.15) ** 2),
        0.1 + 0.5 * t + 0.4 * np.exp(-0.5 * ((t - 0.9) / 0.1) ** 2),
    ]).astype(np.float32)


def hsi_problems(batch: int = BATCH) -> Dict[str, np.ndarray]:
    """``hutamp``'s problems: Y (B, 600, 48) float32 = S·A + N(0, nv), S
    Dirichlet(1, 1, 1) rows with the first 5 rows of each material pure;
    Z = S·A (float64)."""
    p = HSI
    A = endmembers(p["T"]).astype(np.float64)
    probs = []
    for b in range(batch):
        rng = _rng("hsi", b)
        e = rng.exponential(size=(p["N"], p["R"]))
        S = e / e.sum(1, keepdims=True)
        for r in range(p["R"]):
            S[r * p["pure"]:(r + 1) * p["pure"]] = np.eye(p["R"])[r]
        Z = S @ A
        nv = 10 ** (-p["snr_db"] / 10) * np.mean(Z**2)
        probs.append(dict(Y=(Z + np.sqrt(nv) * rng.standard_normal(Z.shape)).astype(np.float32), Z=Z))
    return _stack(probs)


def calib_problem(seed: int) -> Dict[str, np.ndarray]:
    """One self-calibration problem: y = b ∘ (Φ·c) + noise at 40 dB, Φ
    CN(0, 1/M) (M, Nc), c Bernoulli(k/Nc)-CN(0, Nc/k), b = 1 + CN(0, 0.05);
    Phi and y complex64, z, b, c complex128."""
    p = CALIB
    rng = np.random.default_rng([_TAG["calib"], seed])
    beta = p["k"] / p["Nc"]
    Phi = _cplx(rng, p["M"], p["Nc"], var=1.0 / p["M"])
    c = (rng.random(p["Nc"]) < beta) * _cplx(rng, p["Nc"], var=1.0 / beta)
    bg = 1.0 + _cplx(rng, p["M"], var=p["gain_var"])
    z = bg * (Phi @ c)
    nv = 10 ** (-p["snr_db"] / 10) * np.mean(np.abs(z) ** 2)
    y = z + _cplx(rng, p["M"], var=nv)
    return dict(Phi=Phi.astype(np.complex64), y=y.astype(np.complex64), z=z, b=bg, c=c)


def calib_problems(batch: int = BATCH) -> Dict[str, np.ndarray]:
    """:func:`calib_problem` for the first ``batch`` seeds from 0 up whose c
    is not zero (a zero c has z = 0 and no NMSE), stacked, with the seeds
    under ``seed``."""
    probs, seed = [], 0
    while len(probs) < batch:
        p = calib_problem(seed)
        if np.any(p["c"] != 0):
            probs.append(dict(p, seed=np.int64(seed)))
        seed += 1
    return _stack(probs)


def calib_tensor(Phi):
    """A[m] = e_m·Φ_mᵀ: (…, M, M, Nc) from Φ (…, M, Nc), as the example
    builds it; numpy or torch (on Φ's device)."""
    M = Phi.shape[-2]
    if isinstance(Phi, np.ndarray):
        A = np.zeros(Phi.shape[:-1] + (M, Phi.shape[-1]), Phi.dtype)
    else:
        A = torch.zeros(Phi.shape[:-1] + (M, Phi.shape[-1]), dtype=Phi.dtype, device=Phi.device)
    i = np.arange(M)
    A[..., i, i, :] = Phi
    return A


def v_prior_grid():
    """The sparse-exponential grid of ``rankOneSE.m:53-66``: atoms and
    weights (101,) float32."""
    nx = 100
    x = np.linspace(1 / nx, 2, nx)
    px = np.exp(-x)
    px = 0.1 * px / px.sum()
    return (np.concatenate([[0.0], x]).astype(np.float32), np.concatenate([[0.9], px]).astype(np.float32))


def rank_one_moments():
    """(usq0, vsq0): E u² of N(0, 1) and E v² of the grid."""
    atoms, weights = v_prior_grid()
    w = weights.astype(np.float64)
    w /= w.sum()
    return 1.0, float((w * atoms.astype(np.float64) ** 2).sum())


def rank_one_wvar(snr_db: float) -> float:
    """wvar = usq0·vsq0·10^(−SNR/10) (``rankOneSE.m:101``)."""
    usq0, vsq0 = rank_one_moments()
    return usq0 * vsq0 * 10 ** (-0.1 * snr_db)


def rank_one_problems(batch: int = BATCH) -> Dict[str, np.ndarray]:
    """u0 (B, m), v0 (B, n) and W (B, m, n), float32: the matrix at an SNR
    is outer(u0, v0) + √(m·wvar)·W (:func:`rank_one_matrix`)."""
    p = RANK_ONE
    atoms, weights = v_prior_grid()
    w = weights.astype(np.float64)
    w /= w.sum()
    u0 = np.empty((batch, p["m"]), np.float32)
    v0 = np.empty((batch, p["n"]), np.float32)
    W = np.empty((batch, p["m"], p["n"]), np.float32)
    for b in range(batch):
        rng = _rng("rank_one", b)
        u0[b] = rng.standard_normal(p["m"])
        v0[b] = atoms[rng.choice(len(atoms), p["n"], p=w)]
        W[b] = rng.standard_normal((p["m"], p["n"]), dtype=np.float32)
    return dict(u0=u0, v0=v0, W=W)


def rank_one_matrix(prob, snr_db: float):
    """outer(u0, v0) + √(m·wvar)·W at ``snr_db``, numpy or torch as the
    problem's arrays are."""
    m = prob["u0"].shape[-1]
    return prob["u0"][:, :, None] * prob["v0"][:, None, :] + (m * rank_one_wvar(snr_db)) ** 0.5 * prob["W"]


def sq_corr(a, b) -> np.ndarray:
    """Per-realization squared correlation |⟨a, b⟩|² / (‖a‖²‖b‖²)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) ** 2 / ((a * a).sum(-1) * (b * b).sum(-1))
