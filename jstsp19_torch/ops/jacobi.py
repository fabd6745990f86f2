"""Batched Hermitian eigensolver: parallel-ordering cyclic Jacobi
(counterpart of ``jstsp19_tpu/ops/jacobi.py``).

Two-sided Jacobi with a round-robin ("tournament") ordering applies n/2
disjoint rotations a round; a round is applied as the JAX package applies
it, as the dense round matrix ``Gᴴ·A·G`` and ``V·G``, batched over the
leading dimensions.  The schedule tables are shared with the tracked SVT
(``ops/tracked.py``) and the fused ADMM kernel's wrapper.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from jstsp19_torch.solvers.lowrank import _shrink_factors


@functools.lru_cache(maxsize=None)
def _round_robin_schedule(n: int) -> np.ndarray:
    """(n-1, 2, n//2) int32: per round, the p/q index vectors of the
    disjoint pair set (circle method; player 0 fixed, others rotate)."""
    if n % 2:
        raise ValueError("parallel Jacobi needs even n")
    others = list(range(1, n))
    rounds = []
    for _ in range(n - 1):
        arr = [0] + others
        pairs = [(arr[i], arr[n - 1 - i]) for i in range(n // 2)]
        rounds.append(([min(p) for p in pairs], [max(p) for p in pairs]))
        others = [others[-1]] + others[:-1]
    return np.asarray(rounds, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _schedule_gather_tables(n: int):
    """Gather tables applying one round as elementwise row/column
    combinations: (partner, slot, is_p), each (n-1, n) — the index paired
    with i, the pair slot of i, and whether i is the smaller ("p") member."""
    sched = _round_robin_schedule(n)
    partner = np.empty((n - 1, n), np.int32)
    slot = np.empty((n - 1, n), np.int32)
    is_p = np.zeros((n - 1, n), bool)
    for r in range(n - 1):
        for k in range(n // 2):
            p, q = sched[r, 0, k], sched[r, 1, k]
            partner[r, p], partner[r, q] = q, p
            slot[r, p] = slot[r, q] = k
            is_p[r, p] = True
    return partner, slot, is_p


def _round_tables(n: int, device):
    """(n−1, 3n/2) flat indices of each round's (p, p), (q, q) and (p, q)
    entries, and (n−1, 2n) flat indices of the entries its rotation sets:
    (p, p), (q, q), (p, q), (q, p)."""
    sched = torch.as_tensor(_round_robin_schedule(n), dtype=torch.long, device=device)
    p, q = sched[:, 0], sched[:, 1]
    read = torch.cat([p * n + p, q * n + q, p * n + q], dim=-1)
    write = torch.cat([p * n + p, q * n + q, p * n + q, q * n + p], dim=-1)
    return read, write


def jacobi_eigh(A: torch.Tensor, sweeps: int = 10):
    """Eigendecomposition of batched Hermitian matrices.

    A: (..., n, n) complex Hermitian, n even (odd n raises) → (eigenvalues
    ascending (..., n), eigenvectors (..., n, n)) with ``A ≈ V·diag(w)·Vᴴ``.
    Each rotation's angle is ½·atan2(2|a_pq|, a_pp − a_qq) with the unit
    phase of a_pq (1 where a_pq = 0); the eigenvalues are sorted stably, as
    ``jnp.argsort`` sorts."""
    n = A.shape[-1]
    read, write = _round_tables(n, A.device)
    h = n // 2
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    V = eye
    for _ in range(sweeps):
        for r in range(n - 1):
            ent = A.flatten(-2)[..., read[r]]
            app, aqq, apq = ent[..., :h].real, ent[..., h:2 * h].real, ent[..., 2 * h:]
            mag = apq.abs()
            pos = mag > 0
            phase = torch.where(pos, apq / torch.where(pos, mag, torch.ones_like(mag)), 1.0 + 0.0j)
            theta = 0.5 * torch.atan2(2.0 * mag, app - aqq)
            c = torch.cos(theta).to(A.dtype)
            s = torch.sin(theta) * phase
            # G = I with [[c, −s], [s̄, c]] at (p, p), (p, q), (q, p), (q, q)
            G = eye.flatten(-2).clone()
            G[..., write[r]] = torch.cat([c, c, -s, s.conj()], dim=-1)
            G = G.unflatten(-1, (n, n))
            A = G.mH @ A @ G
            V = V @ G
    w = torch.diagonal(A, dim1=-2, dim2=-1).real
    order = torch.argsort(w, dim=-1, stable=True)
    return torch.gather(w, -1, order), torch.gather(V, -1, order[..., None, :].expand(V.shape))


def svt_jacobi(Y: torch.Tensor, tau, sweeps: int = 10) -> torch.Tensor:
    """Singular-value soft thresholding through :func:`jacobi_eigh`, an
    eigh-free stand-in for :func:`jstsp19_torch.solvers.lowrank.svt` where
    the thin side is even, with its matrix-level NaN reset (any non-finite
    entry zeroes the whole matrix, ``svt.m``'s ``if(~isnan(...))``)."""
    n, m = Y.shape[-2], Y.shape[-1]
    ok = torch.all(
        torch.isfinite(Y.real) & torch.isfinite(Y.imag), dim=-1, keepdim=True
    ).all(dim=-2, keepdim=True)
    Yc = torch.where(ok, Y, torch.zeros_like(Y))
    tau = torch.as_tensor(tau, dtype=Y.real.dtype, device=Y.device)[..., None]
    if n <= m:
        sig2, U = jacobi_eigh(Yc @ Yc.mH, sweeps=sweeps)
        f = _shrink_factors(sig2, tau)
        return (U * f[..., None, :]) @ (U.mH @ Yc)
    sig2, V = jacobi_eigh(Yc.mH @ Yc, sweeps=sweeps)
    f = _shrink_factors(sig2, tau)
    return (Yc @ V) * f[..., None, :] @ V.mH


# One sweep count for svt_jacobi wherever it stands in for the eigh prox of
# an iterative solver (the proposed ADMM, mc_svt, mc_admm), so that a
# jacobi-against-eigh comparison in one solver holds for the others.
JACOBI_SVT_SWEEPS = 8


def jacobi_svt_fn(Y: torch.Tensor, tau) -> torch.Tensor:
    """``svt_jacobi`` at the solvers' shared sweep count."""
    return svt_jacobi(Y, tau, sweeps=JACOBI_SVT_SWEEPS)
