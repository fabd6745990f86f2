"""Error metrics (counterpart of ``jstsp19_tpu/core/metrics.py:16-42``).

NMSE convention: ``norm(S-Zbar)^2/norm(Zbar)^2`` with MATLAB's default
matrix norm — the spectral norm — and a clamp at 1 per realization
(``plot_errorVSsnr.m:138-141``).  Batched over leading dimensions.
"""
from __future__ import annotations

import torch


def _sq_norm(X: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "fro":
        return torch.sum(X.abs() ** 2, dim=(-2, -1))
    if kind == "spectral":
        # largest singular value squared == largest eigenvalue of the
        # thin-side Gram
        n, m = X.shape[-2], X.shape[-1]
        G = X @ X.mH if n <= m else X.mH @ X
        ev = torch.linalg.eigvalsh(G)
        return torch.clamp(ev[..., -1], min=0.0)
    raise ValueError(f"unknown norm kind {kind!r}")


def nmse(est: torch.Tensor, ref: torch.Tensor, kind: str = "spectral") -> torch.Tensor:
    """Normalized matrix error ``‖est−ref‖² / ‖ref‖²``."""
    return _sq_norm(est - ref, kind) / _sq_norm(ref, kind)


def clamped_nmse(est: torch.Tensor, ref: torch.Tensor, kind: str = "spectral") -> torch.Tensor:
    """NMSE clamped at 1, as in every reference script (``plot_errorVSsnr.m:139``)."""
    return torch.clamp(nmse(est, ref, kind), max=1.0)
