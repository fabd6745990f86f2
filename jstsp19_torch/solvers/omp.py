"""Greedy pursuit: OMP on a Gram, single-vector, time-domain (implicit
Kronecker dictionary) and joint-sparsity (MMV) OMP, and CoSaMP
(counterpart of ``jstsp19_tpu/solvers/omp.py``).

The reference runs ``OMP.m`` and sparse-plex's
``spx.pursuit.joint.OrthogonalMatchingPursuit`` (``plot_errorVSsnr.m:116-118``).
As in the JAX package the support is a fixed-size index array; the
single-vector cores refit through the bordered (Schur-complement) inverse of
the active Gram, MMV-OMP through a masked-Gram solve with identity padding
on unused slots, and MMV's m ≥ n (saturated) case is one full LS solve.
Batched: every array has the Monte-Carlo batch as its leading dimension and
the greedy loop selects one atom per realization per step, through
``gather``/``scatter`` with a Python step counter, so a loop holds no host
synchronisation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class OmpResult(NamedTuple):
    x: torch.Tensor  # (..., n), (..., n, T) or, from omp_td, (..., Gr, K) sparse estimate
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


def _bordered_update(inv, g, d, t: int, slots):
    """Grow the active-Gram inverse ``inv`` (..., m, m) by slot t, whose
    border row is g (..., m) (zero from slot t on) and diagonal d (...,).

    Rank guard: an atom (numerically) inside the active span has a Schur
    complement s_raw ≤ 1e-6·max(d, 1e-30); its slot gets a zero row and
    column (and inv_tt = 0) instead of an exploding inverse."""
    u = (inv @ g[..., None])[..., 0]
    s_raw = d - torch.sum(g.conj() * u, dim=-1).real
    tiny = s_raw <= 1e-6 * torch.clamp(d, min=1e-30)
    s = torch.where(tiny, torch.ones_like(s_raw), s_raw).to(inv.dtype)[..., None]
    u = torch.where(tiny[..., None], torch.zeros_like(u), u)
    inv = inv + u[..., :, None] * u.conj()[..., None, :] / s[..., None]
    inv_tt = torch.where(tiny[..., None], torch.zeros_like(s), 1.0 / s)
    row_t = torch.where(slots < t, -u.conj() / s, torch.zeros_like(u))
    row_t[..., t] = inv_tt[..., 0]
    inv[..., t, :] = row_t
    inv[..., :, t] = row_t.conj()
    return inv


def _scatter_support(n: int, idx, coef):
    """(..., n) vector with coef (..., m) added at the atoms idx (..., m)."""
    return torch.zeros(idx.shape[:-1] + (n,), dtype=coef.dtype, device=coef.device).scatter_add(-1, idx, coef)


def omp_gram(AhA: torch.Tensor, Ahv: torch.Tensor, m: int) -> OmpResult:
    """OMP on a precomputed dictionary Gram ``AhA`` (..., n, n) and
    correlation ``Ahv`` (..., n): the dictionary never appears, so implicit
    (e.g. Kronecker) dictionaries plug in.  The LS refit keeps the active
    Gram's inverse by the bordered rank-1 update (:func:`_bordered_update`)."""
    n = AhA.shape[-1]
    batch = torch.broadcast_shapes(AhA.shape[:-2], Ahv.shape[:-1])
    AhA = AhA.expand(*batch, n, n)
    Ahv = Ahv.expand(*batch, n)
    dev = AhA.device
    slots = torch.arange(m, device=dev)
    idx = torch.zeros(*batch, m, dtype=torch.long, device=dev)
    coef = torch.zeros(*batch, m, dtype=AhA.dtype, device=dev)
    inv = torch.eye(m, dtype=AhA.dtype, device=dev).expand(*batch, m, m).clone()
    sel = torch.zeros(*batch, n, dtype=torch.bool, device=dev)
    for t in range(m):
        cols = torch.gather(AhA, -1, idx[..., None, :].expand(*batch, n, m))  # AhA[:, idx]
        corr = Ahv - (cols @ coef[..., None])[..., 0]
        new = torch.argmax(torch.where(sel, -torch.inf, corr.abs()), dim=-1, keepdim=True)
        col_new = torch.gather(AhA, -1, new[..., None].expand(*batch, n, 1))[..., 0]  # AhA[:, new]
        g = torch.where(slots < t, torch.gather(col_new, -1, idx), torch.zeros_like(coef))
        d = torch.gather(col_new, -1, new)[..., 0].real
        inv = _bordered_update(inv, g, d, t, slots)
        idx[..., t] = new[..., 0]
        sel = sel.scatter(-1, new, True)
        coef = (inv @ torch.where(slots <= t, torch.gather(Ahv, -1, idx), torch.zeros_like(coef))[..., None])[..., 0]
    return OmpResult(x=_scatter_support(n, idx, coef), support=idx.to(torch.int32))


def omp_gram_kron(GA: torch.Tensor, GB: torch.Tensor, C0: torch.Tensor, m: int) -> OmpResult:
    """OMP on the implicit Kronecker Gram ``kron(GA, GB)`` (Hermitian GA
    (..., na, na), GB (..., nb, nb)) with initial correlations C0 (..., na, nb);
    atom j = r·nb + c.  The correlations are ``C0 − GAr·(coef ⊙ GBcᵀ)`` over
    the carried buffers GAr (na, m) = GA[:, r_idx], GBc (nb, m) = GB[:, c_idx]
    and rhs (m,) = vec(C0)[idx], each grown by one column a step; the border
    row is conj(GAr[r_new, t]·GBc[c_new, t]).  Refit and rank guard as in
    :func:`omp_gram`."""
    na, nb = GA.shape[-1], GB.shape[-1]
    n = na * nb
    batch = torch.broadcast_shapes(GA.shape[:-2], GB.shape[:-2], C0.shape[:-2])
    GA, GB = GA.expand(*batch, na, na), GB.expand(*batch, nb, nb)
    C0 = C0.expand(*batch, na, nb)
    Ahv = C0.reshape(*batch, n)
    dt, dev = GA.dtype, GA.device
    slots = torch.arange(m, device=dev)
    idx = torch.zeros(*batch, m, dtype=torch.long, device=dev)
    coef = torch.zeros(*batch, m, dtype=dt, device=dev)
    inv = torch.eye(m, dtype=dt, device=dev).expand(*batch, m, m).clone()
    GAr = torch.zeros(*batch, na, m, dtype=dt, device=dev)
    GBc = torch.zeros(*batch, nb, m, dtype=dt, device=dev)
    rhs = torch.zeros(*batch, m, dtype=dt, device=dev)
    sel = torch.zeros(*batch, n, dtype=torch.bool, device=dev)
    for t in range(m):
        corr = C0 - GAr @ (coef[..., :, None] * GBc.mT)
        new = torch.argmax(torch.where(sel, -torch.inf, corr.reshape(*batch, n).abs()), dim=-1, keepdim=True)
        r_new, c_new = new // nb, new % nb
        ga_col = torch.gather(GA, -1, r_new[..., None].expand(*batch, na, 1))[..., 0]  # GA[:, r_new]
        gb_col = torch.gather(GB, -1, c_new[..., None].expand(*batch, nb, 1))[..., 0]
        ga_row = torch.gather(GAr, -2, r_new[..., None].expand(*batch, 1, m))[..., 0, :]  # GAr[r_new, :]
        gb_row = torch.gather(GBc, -2, c_new[..., None].expand(*batch, 1, m))[..., 0, :]
        g = torch.where(slots < t, (ga_row * gb_row).conj(), torch.zeros_like(coef))
        d = (torch.gather(ga_col, -1, r_new) * torch.gather(gb_col, -1, c_new))[..., 0].real
        inv = _bordered_update(inv, g, d, t, slots)
        idx[..., t] = new[..., 0]
        GAr[..., :, t] = ga_col
        GBc[..., :, t] = gb_col
        rhs[..., t] = torch.gather(Ahv, -1, new)[..., 0]
        sel = sel.scatter(-1, new, True)
        coef = (inv @ rhs[..., None])[..., 0]  # rhs is 0 on idle slots
    return OmpResult(x=_scatter_support(n, idx, coef), support=idx.to(torch.int32))


def omp(A: torch.Tensor, v: torch.Tensor, m: int) -> OmpResult:
    """Single-vector OMP with target sparsity m (``OMP.m:16-32``):
    A (..., M, n), v (..., M) → x (..., n)."""
    return omp_gram(A.mH @ A, (A.mH @ v[..., None])[..., 0], m)


def omp_td(A: torch.Tensor, B: torch.Tensor, Y: torch.Tensor, k: int) -> OmpResult:
    """Time-domain OMP over the implicit Kronecker dictionary, the figure
    legends' "TD-OMP [11]" baseline: vec(Y) = kron(Bᵀ, A)·vec(S), so the
    dictionary Gram is ``kron(AᴴA, conj(B·Bᴴ))`` (row-major S) and the
    correlations are Aᴴ·Y·Bᴴ.  A (..., N, Gr), B (..., K, T), Y (..., N, T)
    → x (..., Gr, K) with at most k nonzero entries."""
    Gr, K = A.shape[-1], B.shape[-2]
    res = omp_gram_kron(A.mH @ A, (B @ B.mH).conj(), A.mH @ Y @ B.mH, k)
    return OmpResult(x=res.x.reshape(*res.x.shape[:-1], Gr, K), support=res.support)


def cosamp(A: torch.Tensor, v: torch.Tensor, m: int, n_iter: int = 10) -> torch.Tensor:
    """CoSaMP with target sparsity m (the toolbox's ``cosamp.m``): A (..., M, n),
    v (..., M) → x (..., n).  Each iteration solves on the 3m candidates of
    highest score proxy + (|x| > 0)·(max proxy + 1) (the current support
    first) and prunes to the m largest; both sorts are stable."""
    n = A.shape[-1]
    AhA = A.mH @ A
    Ahv = (A.mH @ v[..., None])[..., 0]
    batch = torch.broadcast_shapes(AhA.shape[:-2], Ahv.shape[:-1])
    AhA, Ahv = AhA.expand(*batch, n, n), Ahv.expand(*batch, n)
    c = 3 * m
    x = torch.zeros(*batch, n, dtype=A.dtype, device=A.device)
    for _ in range(n_iter):
        proxy = (Ahv - (AhA @ x[..., None])[..., 0]).abs()
        score = proxy + (x.abs() > 0) * (proxy.amax(dim=-1, keepdim=True) + 1.0)
        cand = torch.argsort(-score, dim=-1, stable=True)[..., :c]
        rows = torch.gather(AhA, -2, cand[..., :, None].expand(*batch, c, n))
        Gsel = torch.gather(rows, -1, cand[..., None, :].expand(*batch, c, c))
        coef = torch.linalg.solve(Gsel, torch.gather(Ahv, -1, cand)[..., None])[..., 0]
        full = _scatter_support(n, cand, coef)
        keep = torch.argsort(-full.abs(), dim=-1, stable=True)[..., :m]
        x = torch.zeros_like(full).scatter(-1, keep, torch.gather(full, -1, keep))
    return x
