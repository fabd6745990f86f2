"""Singular-value thresholding (counterpart of ``jstsp19_tpu/solvers/lowrank.py:18-50``).

Shrinkage through a Hermitian eigendecomposition of the thin-side Gram:
``X Xᴴ = U diag(σ²) Uᴴ  ⇒  shrink(X) = U diag(max(σ−τ,0)/σ) Uᴴ X``.
"""
from __future__ import annotations

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
