"""Singular-value thresholding and matrix completion
(counterpart of ``jstsp19_tpu/solvers/lowrank.py``).

Shrinkage through a Hermitian eigendecomposition of the thin-side Gram:
``X Xᴴ = U diag(σ²) Uᴴ  ⇒  shrink(X) = U diag(max(σ−τ,0)/σ) Uᴴ X``.
The completions are batched: the Monte-Carlo batch leads every matrix, and
τ and ρ are numbers or tensors of the batch shape.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _shrink_factors(sig2: torch.Tensor, tau) -> torch.Tensor:
    """max(σ−τ, 0)/σ with σ = sqrt(σ²), guarded at σ→0."""
    sig = torch.sqrt(torch.clamp(sig2, min=0.0))
    pos = sig > 0
    return torch.where(
        pos, torch.clamp(sig - tau, min=0.0) / torch.where(pos, sig, torch.ones_like(sig)), 0.0
    )


def svt(Y: torch.Tensor, tau) -> torch.Tensor:
    """Singular-value soft-thresholding prox of the nuclear norm
    (``svt.m:5-13``), batched over leading dimensions; ``tau`` may be a
    tensor of the batch shape.  Any non-finite entry maps the WHOLE matrix
    to zeros, per batch element — ``svt.m``'s matrix-level NaN guard."""
    n, m = Y.shape[-2], Y.shape[-1]
    ok = torch.all(
        torch.isfinite(Y.real) & torch.isfinite(Y.imag), dim=-1, keepdim=True
    ).all(dim=-2, keepdim=True)
    Yc = torch.where(ok, Y, torch.zeros_like(Y))
    tau = torch.as_tensor(tau, dtype=Y.real.dtype, device=Y.device)[..., None]
    if n <= m:
        sig2, U = torch.linalg.eigh(Yc @ Yc.mH)
        f = _shrink_factors(sig2, tau)
        return (U * f[..., None, :]) @ (U.mH @ Yc)
    sig2, V = torch.linalg.eigh(Yc.mH @ Yc)
    f = _shrink_factors(sig2, tau)
    return (Yc @ V) * f[..., None, :] @ V.mH


def _resolve_svt_fn(svt_method: str):
    """The untracked prox of :func:`mc_svt` and :func:`mc_admm`: 'eigh' →
    :func:`svt`, 'jacobi' → ``ops/jacobi.py::jacobi_svt_fn`` (the sweep
    count the proposed ADMM's 'jacobi' uses); anything else raises."""
    if svt_method == "jacobi":
        from jstsp19_torch.ops.jacobi import jacobi_svt_fn

        return jacobi_svt_fn
    if svt_method == "eigh":
        return svt
    raise ValueError(f"unknown svt_method {svt_method!r}")


def _col(x, like: torch.Tensor) -> torch.Tensor:
    """A number or a batch scalar as a (..., 1, 1) real tensor that
    broadcasts over matrices."""
    return torch.as_tensor(x, dtype=like.real.dtype, device=like.device)[..., None, None]


def _tracked(OH: torch.Tensor, track_rounds: int, track_precision: str):
    """The tracked-SVT step and its identity basis, one per matrix of OH."""
    from jstsp19_torch.ops.tracked import make_tracked_svt

    N, M = OH.shape[-2:]
    U0, step = make_tracked_svt(N, M, OH.dtype, track_rounds, track_precision, device=OH.device)
    return U0.expand(OH.shape[:-2] + U0.shape).clone(), step


def mc_svt(OH: torch.Tensor, Omega: torch.Tensor, Imax: int, tau, rho,
           svt_method: str = "eigh", track_rounds: int = 1,
           track_precision: str = "default") -> torch.Tensor:
    """Cai–Candès–Shen SVT matrix completion (``mc_svt.m:7-10``), batched.

    Iterates ``X = svt(Y, τ/ρ); Y += ρ(OH − Ω∘X)`` and returns the X of the
    Imax-th loop body, i.e. the SVT of Y after Imax−1 updates (the
    reference's last Y update is discarded there and skipped here).
    ``svt_method``: 'eigh', 'jacobi' or 'tracked' (the warm-started rotation
    chain of ``ops/tracked.py``, its round index running 0 .. Imax−1)."""
    thr = torch.as_tensor(tau, dtype=OH.real.dtype, device=OH.device) / torch.as_tensor(
        rho, dtype=OH.real.dtype, device=OH.device)
    rho_c = _col(rho, OH)
    Y = torch.zeros_like(OH)
    if svt_method == "tracked":
        U, step = _tracked(OH, track_rounds, track_precision)
        for i in range(Imax - 1):
            X, U = step(Y, thr, U, i)
            Y = Y + rho_c * (OH - Omega * X)
        return step(Y, thr, U, Imax - 1)[0]
    svt_fn = _resolve_svt_fn(svt_method)
    for _ in range(Imax - 1):
        Y = Y + rho_c * (OH - Omega * svt_fn(Y, thr))
    return svt_fn(Y, thr)


def mc_admm(
    Htrue: torch.Tensor,
    OH: torch.Tensor,
    Omega: torch.Tensor,
    Imax: int,
    tau,
    rho,
    svt_method: str = "eigh",
    track_rounds: int = 1,
    track_precision: str = "default",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADMM matrix completion (``mc_admm.m``), batched; returns (X, NMSE of
    each iteration laid out (..., Imax)).

    The reference's mask normal matrix is diagonal, so its solve is an
    elementwise division by Ω + ρ.  The NMSE against ``Htrue`` is the
    Frobenius ratio (the reference's spectral norm would cost one more
    eigendecomposition an iteration).  ``svt_method`` as in :func:`mc_svt`."""
    thr = torch.as_tensor(tau, dtype=OH.real.dtype, device=OH.device) / torch.as_tensor(
        rho, dtype=OH.real.dtype, device=OH.device)
    rho_c = _col(rho, OH)
    denom = Omega + rho_c
    if svt_method == "tracked":
        U, step = _tracked(OH, track_rounds, track_precision)
    else:
        svt_fn = _resolve_svt_fn(svt_method)
    h2 = torch.sum(Htrue.abs() ** 2, dim=(-2, -1))
    X = Y = Z = torch.zeros_like(OH)
    errs = []
    for i in range(Imax):
        W = Y - Z / rho_c
        if svt_method == "tracked":
            X, U = step(W, thr, U, i)
        else:
            X = svt_fn(W, thr)
        Y = (OH + Z + rho_c * X) / denom
        Z = Z + rho_c * (X - Y)
        errs.append(torch.sum((X - Htrue).abs() ** 2, dim=(-2, -1)) / h2)
    return X, torch.stack(errs, dim=-1)
