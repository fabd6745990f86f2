"""Joint-sparsity (MMV) orthogonal matching pursuit
(counterpart of ``jstsp19_tpu/solvers/omp.py::omp_mmv`` and ``_masked_ls``).

The reference runs sparse-plex's ``spx.pursuit.joint.OrthogonalMatchingPursuit``
(``plot_errorVSsnr.m:116-118``).  As in the JAX package the support is a
fixed-size index array, the LS refit a masked-Gram solve with identity
padding on unused slots, and the m ≥ n (saturated) case one full LS solve.
Batched: every array has the Monte-Carlo batch as its leading dimension and
the greedy loop selects one atom per realization per step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class OmpResult(NamedTuple):
    x: torch.Tensor  # (..., n, T) sparse estimate
    support: torch.Tensor  # (..., m) selected atom indices (int32)


def _masked_ls(AhA_sel: torch.Tensor, Ahv_sel: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Solve (Gram over the selected atoms) x = rhs with identity padding on
    inactive slots.  AhA_sel (..., m, m), Ahv_sel (..., m, T), active (..., m)."""
    m = AhA_sel.shape[-1]
    eye = torch.eye(m, dtype=AhA_sel.dtype, device=AhA_sel.device)
    mask2 = active[..., :, None] & active[..., None, :]
    G = torch.where(mask2, AhA_sel, eye)
    return torch.linalg.solve(G, Ahv_sel * active[..., :, None])


def omp_mmv(A: torch.Tensor, V: torch.Tensor, m: int) -> OmpResult:
    """Joint-sparsity OMP, the ``spx.pursuit.joint`` analog: atoms are
    scored by the l2 norm of their correlation row across the measurement
    vectors, and the LS refit is joint over columns.
    A (..., M, n), V (..., M, T) → x (..., n, T)."""
    n = A.shape[-1]
    AhA = A.mH @ A
    AhV = A.mH @ V  # (..., n, T)
    batch = torch.broadcast_shapes(AhA.shape[:-2], AhV.shape[:-2])
    dev = A.device

    if m >= n:
        # the spx saturation regime (plot_errorVSsnr.m:116-121 passes
        # numOfnz >= Gr): every atom enters the support, so the greedy loop
        # reduces to one full LS refit in a permuted order
        coef = _masked_ls(AhA, AhV, torch.ones(n, dtype=torch.bool, device=dev))
        support = torch.clamp(torch.arange(m, dtype=torch.int32, device=dev), max=n - 1)
        return OmpResult(x=coef, support=support.expand(*batch, m))

    AhA = AhA.expand(*batch, n, n)
    AhV = AhV.expand(*batch, n, AhV.shape[-1])
    T = AhV.shape[-1]
    slots = torch.arange(m, device=dev)
    idx = torch.zeros(*batch, m, dtype=torch.long, device=dev)
    coef = torch.zeros(*batch, m, T, dtype=A.dtype, device=dev)
    for t in range(m):
        cols = torch.gather(AhA, -1, idx[..., None, :].expand(*batch, n, m))  # AhA[:, idx]
        corr = AhV - cols @ coef
        selected = torch.zeros(*batch, n + 1, dtype=torch.bool, device=dev).scatter(
            -1, torch.where(slots < t, idx, n), True)[..., :n]
        score = torch.where(selected, -torch.inf, torch.sum(corr.abs() ** 2, dim=-1))
        idx[..., t] = torch.argmax(score, dim=-1)
        rows = torch.gather(AhA, -2, idx[..., :, None].expand(*batch, m, n))  # AhA[idx, :]
        Gsel = torch.gather(rows, -1, idx[..., None, :].expand(*batch, m, m))
        rhs = torch.gather(AhV, -2, idx[..., :, None].expand(*batch, m, T))
        coef = _masked_ls(Gsel, rhs, slots <= t)
    X = torch.zeros(*batch, n, T, dtype=A.dtype, device=dev).scatter_add(
        -2, idx[..., :, None].expand(*batch, m, T), coef)
    return OmpResult(x=X, support=idx.to(torch.int32))
