"""Bilinear GAMP (BiG-AMP): joint estimation of both factors of Z = A·X
(counterpart of ``jstsp19_tpu/solvers/bigamp.py``).

The Parker–Schniter recursion with uniform (scalar) variances — the
``BiGAMP_Lite`` regime of the reference's ``MPbased_solvers/BiGAMP/`` —
behind the matrix completion, robust PCA and dictionary learning wrappers
(``EMBiGAMP_MC``, ``EMBiGAMP_RPCA``, ``EMBiGAMP_DL``):

    Z (L×M) = A (L×R) · X (R×M),  observed through an elementwise
    likelihood (AWGN with optional mask → matrix completion).

Batched over a leading realization axis: Y (B, L, M), A (B, L, R), X (B, R,
M).  Every scalar JAX reduces over its one problem (the factors' mean
energies, the variances' means, the EM statistics, |Y|²'s mean) is one a
realization here, shaped (B, 1, 1) beside the matrices, and the JAX
``lax.scan`` is a Python loop with the same carry.  ``key`` is a
``torch.Generator`` where JAX takes a key; the real dtype is Y's.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from jstsp19_torch.core import prng
from jstsp19_torch.solvers.bigamp_full import _per_realization, _rand_init
from jstsp19_torch.solvers.estim import CAwgnPrior, OutlierLikelihood, SparsePrior
from jstsp19_torch.solvers.gamp import _median


class BigAmpResult(NamedTuple):
    A: torch.Tensor
    X: torch.Tensor
    Z: torch.Tensor
    # final input-stage pseudo-data for X (Rx ≈ X + N(0, rvar_x)), rvar_x
    # (B, 1, 1): lets EM wrappers form exact posterior quantities
    Rx: torch.Tensor = None
    rvar_x: torch.Tensor = None


def _mean(v: torch.Tensor) -> torch.Tensor:
    """Mean over each realization's matrix, kept as (B, 1, 1)."""
    return v.mean((1, 2), keepdim=True)


def bigamp(
    Y: torch.Tensor,
    mask,
    rank: int,
    prior_a,
    prior_x,
    noise_var,
    key,
    nit: int = 50,
    step: float = 0.7,
    var_floor: float = 1e-9,
    likelihood=None,
    init_A=None,
    init_X=None,
) -> BigAmpResult:
    """Run BiG-AMP on (masked) observations ``Y ≈ mask ∘ (A·X)``.

    Y: (B, L, M); mask: of Y's shape or (L, M), in {0,1} (all-ones = full
    observation); ``noise_var`` a number or one a realization; ``key`` a
    ``torch.Generator`` seeding the random factor initialization (the
    bilinear problem is invariant to A·X ↦ (A·G)(G⁻¹·X), so the output is
    the product Z plus one arbitrary factorization).  ``likelihood``:
    optional elementwise output estimator replacing the default AWGN (e.g.
    ``OutlierLikelihood`` for robust PCA).
    """
    B, L, M = Y.shape
    R = rank
    cdt = Y.dtype
    rdt = Y.real.dtype
    dev = Y.device

    kA, kX = prng.split(key, 2)
    # random init scaled to the prior's second moment (or caller-provided
    # spectral init); real observations keep a real state
    ma, va = prior_a.init_moments()
    mx, vx = prior_x.init_moments()
    Ahat = init_A if init_A is not None else _rand_init(kA, (B, L, R), ma, va, cdt, dev)
    Xhat = init_X if init_X is not None else _rand_init(kX, (B, R, M), mx, vx, cdt, dev)
    Avar = _per_realization(va, B, 2, rdt, dev)
    Xvar = _per_realization(vx, B, 2, rdt, dev)
    Shat = torch.zeros((B, L, M), dtype=cdt, device=dev)

    nv = _per_realization(noise_var, B, 2, rdt, dev)
    m = torch.as_tensor(mask, device=dev).to(rdt)
    Rx, rvar_x = Xhat, _per_realization(vx, B, 2, rdt, dev)

    for _ in range(nit):
        # one a realization: a2, x2, mean(zvar0_eff), mean(Avar_n), mean(Xvar_n)
        a2 = _mean(Ahat.abs() ** 2)
        x2 = _mean(Xhat.abs() ** 2)

        # --- output linear stage (scalar-variance BiG-AMP) --------------
        zvar_bar = R * (a2 * Xvar + Avar * x2)  # plug-in variance
        zvar = zvar_bar + R * Avar * Xvar
        Phat = Ahat @ Xhat - Shat * zvar_bar
        zvar = torch.clamp(zvar, min=var_floor)

        # --- output nonlinear (masked; AWGN or custom likelihood) -------
        if likelihood is not None:
            Z0, zvar0 = likelihood.estim(Phat, zvar)
        else:
            gain = zvar / (zvar + nv)
            Z0 = Phat + gain * (Y - Phat)
            zvar0 = gain * nv
        # unobserved entries carry no information
        Z0 = m * Z0 + (1 - m) * Phat
        zvar0_eff = m * zvar0 + (1 - m) * zvar
        Shat_new = (Z0 - Phat) / zvar
        svar = torch.clamp((1.0 - _mean(zvar0_eff) / zvar) / zvar, min=var_floor)
        Shat_new = step * Shat_new + (1 - step) * Shat

        # --- input linear stages (.mH, never .T, on the batched factors) ---
        rvar_x = 1.0 / torch.clamp(L * svar * a2, min=var_floor)
        Rx = Xhat * (1.0 - rvar_x * L * svar * Avar) + rvar_x * (Ahat.mH @ Shat_new)
        rvar_a = 1.0 / torch.clamp(M * svar * x2, min=var_floor)
        Ra = Ahat * (1.0 - rvar_a * M * svar * Xvar) + rvar_a * (Shat_new @ Xhat.mH)

        # --- input nonlinear --------------------------------------------
        Xn, Xvar_n = prior_x.estim(Rx, rvar_x)
        An, Avar_n = prior_a.estim(Ra, rvar_a)
        Xhat = step * Xn + (1 - step) * Xhat
        Ahat = step * An + (1 - step) * Ahat
        Avar = torch.clamp(_mean(Avar_n), min=var_floor)
        Xvar = torch.clamp(_mean(Xvar_n), min=var_floor)
        Shat = Shat_new

    return BigAmpResult(A=Ahat, X=Xhat, Z=Ahat @ Xhat, Rx=Rx, rvar_x=rvar_x)


def _gauss_priors():
    return CAwgnPrior(0j, 1.0), CAwgnPrior(0j, 1.0)


def bigamp_mc(Y, mask, rank, noise_var, key, nit=100, step=0.7):
    """Matrix completion via BiG-AMP (the ``EMBiGAMP_MC`` capability):
    Gaussian priors on both factors."""
    pa, px = _gauss_priors()
    return bigamp(Y, mask, rank, pa, px, noise_var, key, nit=nit, step=step)


def bigamp_rpca(Y, rank, noise_var, outlier_var, outlier_frac, key, nit=300, step=0.05):
    """Robust PCA via BiG-AMP (the ``EMBiGAMP_RPCA`` capability): low-rank
    plus sparse-outlier decomposition.  Returns the BigAmpResult; the
    outlier field is ``Y − Z`` thresholded by the caller.  The spectral init
    makes the solve deterministic: ``key`` is not read (as in JAX)."""
    B = Y.shape[0]
    rdt, dev = Y.real.dtype, Y.device
    pa, px = _gauss_priors()
    lik = OutlierLikelihood(Y, *(_per_realization(v, B, 2, rdt, dev) for v in (noise_var, outlier_var, outlier_frac)))
    mask = torch.ones(Y.shape, dtype=rdt, device=dev)
    # Spectral initialization robust to gross outliers: winsorize |Y| at
    # 3x its median, truncated SVD -> rank-R factors.  The median is one a
    # realization and, as jnp.median, the mean of the two middle values of
    # an even count (torch.median takes the lower one).  The SVD fixes each
    # column only up to a unit-modulus phase, so compare Z, not A or X.
    mag = Y.abs()
    med = _median(mag.reshape(B, -1))[:, :, None]
    Yw = torch.where(mag > 3 * med, Y / torch.clamp(mag, min=1e-30) * 3 * med, Y)
    U, sv, Vh = torch.linalg.svd(Yw, full_matrices=False)
    root = torch.sqrt(sv[:, :rank])
    init_A = (U[..., :rank] * root[:, None, :]).to(Y.dtype)
    init_X = (root[:, :, None] * Vh[:, :rank]).to(Y.dtype)
    return bigamp(Y, mask, rank, pa, px, noise_var, key, nit=nit, step=step,
                  likelihood=lik, init_A=init_A, init_X=init_X)


class EmBigAmpResult(NamedTuple):
    A: torch.Tensor  # (B, L, max_rank), zero past each realization's rank
    X: torch.Tensor  # (B, max_rank, M), zero past each realization's rank
    Z: torch.Tensor
    noise_var: torch.Tensor  # (B,)
    rank: torch.Tensor  # (B,) selected rank, int64
    bic: torch.Tensor  # (B, max_rank) BIC of each candidate rank, float64


def em_bigamp_mc(
    Y,
    mask,
    max_rank: int,
    key,
    nit: int = 100,
    n_em: int = 3,
    step: float = 0.7,
):
    """EM-wrapped BiG-AMP matrix completion with rank selection — the
    ``EMBiGAMP_MC`` capability (``BiGAMP/EMBiGAMP_MC.m``): for each
    candidate rank the noise variance is EM-refit from the masked
    residual, and the rank is selected by BIC (observed-data Gaussian
    log-likelihood + complex-parameter-count penalty).  The scalar-variance
    BiG-AMP core is only stable near the true rank, so the explicit rank
    sweep doubles as the stabilizer.

    The rank is selected per realization.  Each candidate rank runs batched
    across the B realizations; each realization keeps its own BIC, with its
    own observed count, residual (float64, as in JAX: diverged ranks
    overflow float32) and noise variance, and skips its own non-finite
    BICs.  ``rank`` is (B,) int64, ``bic`` (B, max_rank) float64,
    ``noise_var`` (B,); A and X are the selected rank's factors padded with
    zeros to (B, L, max_rank) and (B, max_rank, M), so A·X is Z exactly.
    A ``RuntimeError`` names the realizations whose every rank diverged.
    """
    B, L, M = Y.shape
    rdt, dev = Y.real.dtype, Y.device
    m = torch.broadcast_to(torch.as_tensor(mask, device=dev).to(rdt), Y.shape)
    # per realization: the observed count and |Y|²'s mean over it
    n_obs = torch.clamp(m.sum((1, 2), keepdim=True).double(), min=1.0)
    y_energy = ((Y.abs() ** 2 * m).sum((1, 2), keepdim=True) / n_obs).to(rdt)
    pa, px = _gauss_priors()
    y64 = Y.to(torch.complex128)
    m64 = m.double()

    best_bic = torch.full((B,), math.inf, dtype=torch.float64, device=dev)
    best_rank = torch.zeros((B,), dtype=torch.int64, device=dev)
    best_A = torch.zeros((B, L, max_rank), dtype=Y.dtype, device=dev)
    best_X = torch.zeros((B, max_rank, M), dtype=Y.dtype, device=dev)
    best_Z = torch.zeros_like(Y)
    best_nv = torch.zeros((B,), dtype=torch.float64, device=dev)
    bics = []
    for r in range(1, max_rank + 1):
        nv = y_energy / 101.0
        k = prng.fold_in(key, r)
        res = None
        for _ in range(n_em):
            res = bigamp(Y, mask, r, pa, px, nv, k, nit=nit, step=step)
            resid = (y64 - res.Z.to(torch.complex128)) * m64
            nv = torch.clamp((resid.abs() ** 2).sum((1, 2), keepdim=True) / n_obs, min=1e-12)
            k = prng.fold_in(k, 1)
        # BIC: n·ln(σ̂²) + k_params·ln(n); complex factor entries = 2 reals
        k_params = 2 * r * (L + M)
        bic = (n_obs * torch.log(nv) + k_params * torch.log(n_obs)).reshape(B)
        bics.append(bic)
        better = torch.isfinite(bic) & (bic < best_bic)
        b3 = better[:, None, None]
        best_bic = torch.where(better, bic, best_bic)
        best_rank = torch.where(better, r, best_rank)
        best_A[:, :, :r] = torch.where(b3, res.A, best_A[:, :, :r])
        best_X[:, :r, :] = torch.where(b3, res.X, best_X[:, :r, :])
        best_Z = torch.where(b3, res.Z, best_Z)
        best_nv = torch.where(better, nv.reshape(B), best_nv)
    lost = torch.nonzero(best_rank == 0).flatten().tolist()
    if lost:
        raise RuntimeError(f"all candidate ranks diverged in realizations {lost}")
    return EmBigAmpResult(
        A=best_A, X=best_X, Z=best_Z, noise_var=best_nv.to(rdt), rank=best_rank,
        bic=torch.stack(bics, -1),
    )


class EmBigAmpDlResult(NamedTuple):
    A: torch.Tensor  # learned dictionary (B, L, R)
    X: torch.Tensor  # sparse codes (B, R, M)
    Z: torch.Tensor  # reconstruction A·X
    sparsity: torch.Tensor  # learned activity rate λ, (B,)
    slab_var: torch.Tensor  # learned active-coefficient variance θ, (B,)
    noise_var: torch.Tensor  # learned noise variance ψ, (B,)


def _dl_polish(Y, A0, X0, rank, tau0, tau1, iters=80, inner=5):
    """Alternating sparse-coding / LS-dictionary polish with soft-threshold
    continuation (τ decays geometrically τ0 → τ1, per realization: tau0
    and tau1 are (B, 1, 1)).  The scalar-variance BiG-AMP core recovers the
    product A·X essentially exactly but leaves the R×R rotation ambiguity
    unresolved; the continuation drives the factorization to the sparse
    rotation.  The shrink is of the complex magnitude, G/|G|·max(|G| − τ/Lc,
    0), not the re/im soft threshold of ``kernels/softthresh.py``.
    """
    R = rank
    eyeR = torch.eye(R, dtype=Y.dtype, device=Y.device)
    A, X = A0, X0
    for it in range(iters):
        # the schedule's exponent is it/(iters − 1) exactly
        tau = tau0 * (tau1 / tau0) ** (it / max(iters - 1, 1))
        # the spectral norm of each realization's A
        Lc = torch.clamp(torch.linalg.matrix_norm(A, ord=2) ** 2, min=1e-12)[:, None, None]
        for _ in range(inner):
            G = X + (A.mH @ (Y - A @ X)) / Lc
            mag = G.abs()
            X = torch.where(mag > 0, G / torch.clamp(mag, min=1e-30) * torch.clamp(mag - tau / Lc, min=0.0),
                            torch.zeros((), dtype=G.dtype, device=G.device))
        XXh = X @ X.mH + 1e-9 * eyeR
        A = torch.linalg.solve(XXh.mH, (Y @ X.mH).mH).mH
        nrm = torch.clamp(torch.linalg.vector_norm(A, dim=-2), min=1e-12)
        A, X = A / nrm[:, None, :], X * nrm[:, :, None]
    return A, X


def em_bigamp_dl(
    Y,
    rank: int,
    key,
    nit: int = 150,
    n_em: int = 4,
    step: float = 0.5,
    init_sparsity: float = 0.2,
    polish_iters: int = 80,
):
    """EM-wrapped BiG-AMP dictionary learning — the ``EMBiGAMP_DL``
    capability (``BiGAMP/EMBiGAMP_DL.m``): Y ≈ A·X with a Gaussian prior
    on the dictionary A and a Bernoulli-Gaussian (spike-slab) prior on the
    codes X whose activity rate λ, slab variance θ, and the noise variance
    ψ are all EM-learned, each per realization:

      λ ← mean posterior activity  E[π | Rx]
      θ ← Σ π·E[|x|² | active] / Σ π      (slab second moment)
      ψ ← mean observed-residual power

    During the EM rounds the posterior activity/moments are computed
    exactly from the final input-stage pseudo-data (Rx, rvar_x) returned
    by :func:`bigamp` (``SparseScaEstim.m:77-115``), as tensor operations on
    Y's device.  A final :func:`_dl_polish` continuation resolves the
    rotation ambiguity of the scalar-variance core, and the reported
    hyperparameters are re-fit on the polished factors.
    """
    B, L, M = Y.shape
    rdt, dev = Y.real.dtype, Y.device

    def mean(v):
        return v.mean((1, 2), keepdim=True)

    y_energy = mean(Y.abs() ** 2)
    pa = CAwgnPrior(0j, 1.0)
    ones = torch.ones(Y.shape, dtype=rdt, device=dev)
    y64 = Y.to(torch.complex128)

    lam = torch.full((B, 1, 1), float(init_sparsity), dtype=rdt, device=dev)
    # scale the slab so the product matches the observed energy:
    # E|y|² ≈ R·λ·θ·E|a|² (+ψ)
    theta = torch.clamp(y_energy / (rank * lam), min=1e-12)
    nv = y_energy / 101.0

    res = None
    for it in range(n_em):
        px = SparsePrior(CAwgnPrior(0j, theta), lam)
        res = bigamp(Y, ones, rank, pa, px, nv, prng.fold_in(key, it), nit=nit, step=step)
        # exact spike-slab posterior from the final pseudo-data
        Rx, rvx = res.Rx, torch.clamp(res.rvar_x, min=1e-12)
        r2 = Rx.abs() ** 2
        ll1 = -(math.log(math.pi) + torch.log(theta + rvx) + r2 / (theta + rvx))
        ll0 = -(math.log(math.pi) + torch.log(rvx) + r2 / rvx)
        exparg = torch.clamp(ll0 - ll1 + torch.log1p(-lam) - torch.log(lam), -500, 500)
        pi = 1.0 / (1.0 + torch.exp(exparg))
        gain = theta / (theta + rvx)
        ex2_active = (gain * Rx).abs() ** 2 + gain * rvx
        lam = torch.clamp(mean(pi), 1e-4, 1 - 1e-4)
        theta = torch.clamp((pi * ex2_active).sum((1, 2), keepdim=True)
                            / torch.clamp(pi.sum((1, 2), keepdim=True), min=1e-9), min=1e-12)
        nv = torch.clamp(mean((y64 - res.Z.to(torch.complex128)).abs() ** 2), min=1e-12).to(rdt)

    # sparsifying-rotation polish + hyperparameter re-fit
    rms = torch.sqrt(y_energy)
    A_fin, X_fin = _dl_polish(Y, res.A, res.X, rank, 0.5 * rms, 0.02 * rms, iters=polish_iters)
    active = (X_fin.abs() > 0).to(rdt)
    lam = torch.clamp(mean(active), 1e-4, 1 - 1e-4)
    theta = torch.clamp((X_fin.abs() ** 2).sum((1, 2), keepdim=True)
                        / torch.clamp(active.sum((1, 2), keepdim=True), min=1), min=1e-12)
    Z_fin = A_fin @ X_fin
    nv = torch.clamp(mean((y64 - Z_fin.to(torch.complex128)).abs() ** 2), min=1e-12)
    return EmBigAmpDlResult(
        A=A_fin, X=X_fin, Z=Z_fin, sparsity=lam.reshape(B), slab_var=theta.reshape(B),
        noise_var=nv.to(rdt).reshape(B),
    )
