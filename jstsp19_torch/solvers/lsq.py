"""Least-squares baseline estimator (counterpart of ``jstsp19_tpu/solvers/lsq.py``).

``S_ls = pinv(A)·Y·pinv(B)`` (``plot_errorVSsnr.m:83``) — the kron-pinv
factorization makes this the exact LS solution of ``Y ≈ A·S·B``.  Batched
over leading dimensions.
"""
from __future__ import annotations

import torch


def pinv(X: torch.Tensor, rcond=None) -> torch.Tensor:
    """Batched pseudo-inverse with ``jnp.linalg.pinv``'s default cutoff:
    singular values at or below ``10·max(m, n)·eps`` times the largest are
    dropped (torch's own default is ten times smaller)."""
    if rcond is None:
        rcond = 10.0 * max(X.shape[-2:]) * torch.finfo(X.real.dtype).eps
    return torch.linalg.pinv(X, rtol=rcond)


def ls_estimate(Y: torch.Tensor, A: torch.Tensor, B: torch.Tensor, rcond=None) -> torch.Tensor:
    return pinv(A, rcond) @ Y @ pinv(B, rcond)
