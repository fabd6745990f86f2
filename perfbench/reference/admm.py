"""The proposed ADMM with tracked singular-value thresholding, written out plainly.

The solver of ``proposed_algorithm.m`` (Algorithm 3 with an oracle support
order, ``proposed_algorithm_angles.m``) in its approximate mode: one exact
steepest-descent step on the sparse code per iteration.  Its nuclear-norm
prox is the tracked SVT that the measured routes run: the eigenbasis U of
the thin-side Gram is carried from one iteration to the next and refreshed
by one round of the parallel (round-robin) Jacobi ordering a call; the
singular values are the row norms of P = Uᴴ·W after the round.  Where N > M
it runs on the transpose, SVT(Wᵀ)ᵀ = SVT(W), so that U is always of the thin
side.  Each round's rotations are applied here as a dense unitary matrix.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from perfbench.reference.frontend import Products


def round_robin(n: int):
    """(n−1) rounds of n/2 disjoint pairs (p < q), the circle method: player
    0 stays, the others rotate one place a round."""
    others = list(range(1, n))
    rounds = []
    for _ in range(n - 1):
        ring = [0] + others
        pairs = [(min(ring[i], ring[n - 1 - i]), max(ring[i], ring[n - 1 - i])) for i in range(n // 2)]
        rounds.append(([p for p, _ in pairs], [q for _, q in pairs]))
        others = [others[-1]] + others[:-1]
    return rounds


def jacobi_round(U: torch.Tensor, P: torch.Tensor, pairs, mm: Products):
    """One round of rotations on the Gram G = P·Pᴴ: each pair (p, q) gets
    the rotation that zeroes G[p, q]; U ← U·R and P ← Rᴴ·P."""
    n = P.shape[-2]
    p = torch.tensor(pairs[0], device=P.device)
    q = torch.tensor(pairs[1], device=P.device)
    G = mm(P, P.mH)
    g_pp, g_qq, g_pq = G[..., p, p].real, G[..., q, q].real, G[..., p, q]
    mag = g_pq.abs()
    unit = torch.where(mag > 0, g_pq / torch.where(mag > 0, mag, torch.ones_like(mag)), torch.ones_like(g_pq))
    theta = 0.5 * torch.atan2(2.0 * mag, g_pp - g_qq)
    c = torch.cos(theta).to(P.dtype)
    s = torch.sin(theta) * unit
    R = torch.zeros(P.shape[:-2] + (n, n), dtype=P.dtype, device=P.device)
    R[..., p, p] = c
    R[..., q, q] = c
    R[..., p, q] = -s
    R[..., q, p] = s.conj()
    return mm(U, R), mm(R.mH, P)


def tracked_svt(W: torch.Tensor, tau: torch.Tensor, U: torch.Tensor, pairs, mm: Products):
    """(shrunk W, refreshed U) for (B, N, M) W, U of the thin side
    min(N, M); where N > M on the transpose.  A W with a non-finite entry
    counts as zero (``svt.m``'s guard)."""
    if W.shape[-2] > W.shape[-1]:
        Y, U = tracked_svt(W.mT, tau, U, pairs, mm)
        return Y.mT, U
    finite = (torch.isfinite(W.real) & torch.isfinite(W.imag)).all(dim=-1, keepdim=True).all(dim=-2, keepdim=True)
    W = torch.where(finite, W, torch.zeros_like(W))
    U, P = jacobi_round(U, mm(U.mH, W), pairs, mm)
    sig = P.abs().pow(2).sum(dim=-1).sqrt()
    pos = sig > 0
    keep = torch.where(pos, torch.clamp(sig - tau[:, None], min=0.0) / torch.where(pos, sig, torch.ones_like(sig)),
                       torch.zeros_like(sig))
    return mm(U, keep[..., None] * P), U


def soft(v: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Soft threshold of the real and imaginary parts apart (``proposed_algorithm.m:56``)."""
    t = tau[:, None, None]
    return torch.complex(torch.sign(v.real) * torch.clamp(v.real.abs() - t, min=0.0),
                         torch.sign(v.imag) * torch.clamp(v.imag.abs() - t, min=0.0))


def admm(prob: Mapping[str, torch.Tensor], imax: int, mm: Products, rank: Optional[torch.Tensor] = None,
         base: int = 10, step: int = 5) -> torch.Tensor:
    """The (B, Gr, K) estimate S after ``imax`` iterations from zero.  With
    ``rank``, iteration i keeps the min(base + step·(i+1), Gr·K) entries of
    the oracle order (Algorithm 3)."""
    Y_obs, Omega, A, B = prob["subY"], prob["Omega"], prob["A"], prob["B"]
    rho = prob["rho"][:, None, None]
    thr_Y = prob["tau_Y"] / prob["rho"]
    thr_S = prob["tau_S"] / prob["rho"]
    batch, N, M = Y_obs.shape
    thin = min(N, M)
    if thin % 2:
        raise ValueError("the tracked SVT here takes an even thin side min(N, M)")
    Gr, K = A.shape[-1], B.shape[-2]
    AhA, BBh = mm(A.mH, A), mm(B, B.mH)
    rounds = round_robin(thin)
    X = V1 = V2 = C = torch.zeros_like(Y_obs)
    S = v = torch.zeros((batch, Gr, K), dtype=Y_obs.dtype, device=Y_obs.device)
    U = torch.eye(thin, dtype=Y_obs.dtype, device=Y_obs.device).expand(batch, thin, thin)
    for i in range(imax):
        Y, U = tracked_svt(X - V1 / rho, thr_Y, U, rounds[i % (thin - 1)], mm)
        X = (V1 + rho * Y + Y_obs + V2 + rho * C + rho * mm(mm(A, S), B)) / (Omega + 2.0 * rho)
        Kmat = X - V2 / rho - C
        g = mm(mm(A.mH, Kmat), B.mH) - mm(mm(AhA, v), BBh)
        Hg = mm(mm(AhA, g), BBh)
        num = g.abs().pow(2).sum(dim=(-2, -1))
        den = (g.conj() * Hg).sum(dim=(-2, -1)).real
        alpha = torch.where(den > 0, num / torch.where(den > 0, den, torch.ones_like(den)), torch.zeros_like(den))
        v = v + alpha[:, None, None] * g
        S = soft(v, thr_S)
        if rank is not None:
            S = torch.where(rank < min(base + step * (i + 1), Gr * K), S, torch.zeros_like(S))
        Xs = mm(mm(A, S), B)
        C_new = rho / (rho + 1.0) * (X - Xs - V2 / rho)
        V1 = V1 + rho * (Y - X)
        V2 = V2 + rho * (C_new - X + Xs)
        C = C_new
    return S


def clamped_nmse(S: torch.Tensor, Zbar: torch.Tensor) -> torch.Tensor:
    """min(‖S − Zbar‖₂² / ‖Zbar‖₂², 1) per realization, spectral norms; NaN
    where S is not finite."""
    D = S - Zbar
    finite = torch.isfinite(torch.view_as_real(D)).flatten(-3).all(dim=-1)
    D = torch.where(finite[:, None, None], D, torch.zeros_like(D))
    err = torch.linalg.matrix_norm(D, ord=2) ** 2 / torch.linalg.matrix_norm(Zbar, ord=2) ** 2
    return torch.where(finite, torch.clamp(err, max=1.0), torch.full_like(err, float("nan")))
