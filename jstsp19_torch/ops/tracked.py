"""Warm-started tracked singular-value thresholding
(counterpart of ``jstsp19_tpu/ops/tracked.py:31-104``).

The Gram eigenbasis U is carried across solver iterations and refreshed
with ``track_rounds`` parallel-ordering Jacobi rounds per call.  The rounds
act on ``P = Uᴴ·W`` directly (P-form): pair sums of P's rows give the
rotated Gram's entries, each round's rotation has two nonzeros per row and
column so ``U·G`` and ``Gᴴ·P`` are pair gathers, the singular values are
P's row norms after the rounds, and the result is ``U·(f∘P)``.
N > M inputs run on the transpose (``SVT(Xᵀ)ᵀ == SVT(X)``).
"""
from __future__ import annotations

import torch

from jstsp19_torch.ops.jacobi import _round_robin_schedule, _schedule_gather_tables


def make_tracked_svt(
    N: int, M: int, cdt=torch.complex64, track_rounds: int = 1,
    precision: str = "highest", device=None,
):
    """Build the tracked-SVT step for (..., N, M) inputs.

    Returns ``(U0, step)``: the initial basis (identity, thin side) and
    ``step(W, tau, U, i) -> (X, U2)``, the shrunk matrix and the refreshed
    basis; ``i`` is the solver iteration, which picks the round-robin
    rounds ``(i·track_rounds + j) mod (Ns−1)``.  ``tau`` broadcasts over
    the batch.  ``precision`` is accepted for signature parity with the JAX
    package: every product here runs in full float32.
    """
    flip = N > M
    Ns = M if flip else N  # thin side = tracked-basis dimension
    if Ns % 2:
        raise ValueError("tracked SVT needs an even thin dimension")

    sched = torch.as_tensor(_round_robin_schedule(Ns), dtype=torch.long, device=device)
    part_t, slot_t, isp_t = (
        torch.as_tensor(t, device=device) for t in _schedule_gather_tables(Ns)
    )
    part_t, slot_t = part_t.long(), slot_t.long()

    def _rounds(U, P, start):
        for j in range(track_rounds):
            ridx = (start + j) % (Ns - 1)
            p, q = sched[ridx, 0], sched[ridx, 1]
            Pp = P[..., p, :]
            Pq = P[..., q, :]
            app = torch.sum(Pp.real**2 + Pp.imag**2, dim=-1)
            aqq = torch.sum(Pq.real**2 + Pq.imag**2, dim=-1)
            apq = torch.sum(Pp * Pq.conj(), dim=-1)
            mag = apq.abs()
            pos = mag > 0
            phase = torch.where(pos, apq / torch.where(pos, mag, torch.ones_like(mag)), 1.0 + 0.0j)
            theta = 0.5 * torch.atan2(2.0 * mag, app - aqq)
            c = torch.cos(theta)
            s = (torch.sin(theta) * phase).to(cdt)
            part, slot, isp = part_t[ridx], slot_t[ridx], isp_t[ridx]
            cf = c[..., slot]
            sf = s[..., slot]
            # G[p,p]=G[q,q]=c, G[p,q]=−s, G[q,p]=s̄ ⇒ elementwise combinations
            bR = torch.where(isp, sf.conj(), -sf)
            bL = torch.where(isp, sf, -sf.conj())
            U = U * cf[..., None, :] + U[..., :, part] * bR[..., None, :]
            P = P * cf[..., :, None] + P[..., part, :] * bL[..., :, None]
        return U, P

    def _step_thin(W, tau, U, i):
        # svt.m's matrix-level NaN reset, as in solvers/lowrank.svt
        ok = torch.all(
            torch.isfinite(W.real) & torch.isfinite(W.imag), dim=-1, keepdim=True
        ).all(dim=-2, keepdim=True)
        Wc = torch.where(ok, W, torch.zeros_like(W))
        P = U.mH @ Wc
        U2, P2 = _rounds(U, P, (i * track_rounds) % (Ns - 1))
        sig = torch.sqrt(torch.sum(P2.real**2 + P2.imag**2, dim=-1))
        tau = torch.as_tensor(tau, dtype=sig.dtype, device=sig.device)[..., None]
        pos = sig > 0
        f = torch.where(
            pos, torch.clamp(sig - tau, min=0.0) / torch.where(pos, sig, torch.ones_like(sig)), 0.0
        )
        return U2 @ (f[..., :, None] * P2), U2

    if flip:
        def step(W, tau, U, i):
            X, U2 = _step_thin(W.transpose(-2, -1), tau, U, i)
            return X.transpose(-2, -1), U2
    else:
        step = _step_thin

    return torch.eye(Ns, dtype=cdt, device=device), step
