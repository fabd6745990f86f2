"""Operations, bytes and the least time of the fused ADMM, from its shapes alone.

The counts read the same work whatever implements it.  Peaks are NVIDIA's
published figures for one H100 SXM at its 700 W limit: float32 outside the
tensor cores and HBM3 bandwidth.  The run prints the card's power limit
beside them.
"""
from __future__ import annotations

from typing import Iterable, Mapping

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def admm_flops(B: int, N: int, M: int, Gr: int, K: int, Imax: int) -> float:
    """Real float32 operations of the fused ADMM's complex products (8 per
    complex multiply-add) over Imax iterations, each counted at its cheapest
    association, so that no way of computing the same function needs fewer:

    - the SVT, the cheaper of the P form (P = UᴴW; one round of N/2
      rotations on P's rows with their 2×2 Grams and on U's columns;
      Y = U(f∘P)) and the Gram form (G = WWᴴ, T = Uᴴ(GU), the rotations on
      T's rows and columns and on U's columns, Z = U f Uᴴ, Y = ZW; G, T and
      Z are Hermitian, so only half of each is counted);
    - A·S, then (A·S)·B;
    - Aᴴ·K·Bᴴ as the cheaper of Aᴴ(KBᴴ) and (AᴴK)Bᴴ;
    - (AᴴA)·v·(BBᴴ) for the gradient and again for the exact step.

    The elementwise work is left out, so the count is a lower bound."""
    half = N * (N + 1) // 2
    svt_p = 2 * N * N * M + (N // 2) * (7 * M + 4 * N)
    svt_gram = half * M + N ** 3 + 2 * half * N + (N // 2) * 12 * N + N * N * M
    macs = (min(svt_p, svt_gram) + N * Gr * K + N * K * M
            + min(N * K * M + Gr * N * K, Gr * N * M + Gr * M * K) + 2 * (Gr * Gr * K + Gr * K * K))
    return 8.0 * macs * Imax * B


def admm_bytes(B: int, N: int, M: int, Gr: int, K: int, rank: bool = False) -> int:
    """Bytes that one call has to move at the least: each input read once
    (subY complex64, Omega float32, A and B complex64, tau_Y, tau_S and rho
    float32, the int32 support rank where given) and each output written
    once (S and Y, complex64)."""
    inputs = 8 * N * M + 4 * N * M + 8 * N * Gr + 8 * K * M + 3 * 4 + (4 * Gr * K if rank else 0)
    outputs = 8 * Gr * K + 8 * N * M
    return B * (inputs + outputs)


def admm_bound_s(B: int, N: int, M: int, Gr: int, K: int, Imax: int, rank: bool = False) -> float:
    """The least time of one call: the larger of the operations over the
    float32 peak and the bytes over the HBM bandwidth."""
    return max(admm_flops(B, N, M, Gr, K, Imax) / FP32_FLOP_PER_S, admm_bytes(B, N, M, Gr, K, rank) / HBM_BYTES_PER_S)


def sweep_bound_s(calls: Iterable[Mapping[str, int]]) -> float:
    """The least time of a sequence of calls, each given by its shapes: the
    sum of their bounds."""
    return sum(admm_bound_s(c["B"], c["N"], c["M"], c["Gr"], c["K"], c["Imax"], bool(c.get("rank", False)))
               for c in calls)
