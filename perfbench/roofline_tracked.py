"""Operations and the least time of the proposed ADMM at any N and M, from its shapes alone.

``perfbench/roofline.py`` counts the fused kernel's work, whose SVT takes the
N×M iterate with N ≤ M.  Where N > M the solve takes the SVT of the
transpose, SVT(Wᵀ)ᵀ = SVT(W), so that the eigenbasis it carries is of the
thin side min(N, M): here the SVT is counted at that side, in the cheaper of
the same two forms, and every other product as ``roofline.py`` counts it.
For N ≤ M the count, the bytes and the bound are ``roofline.py``'s exactly.

The count is the work of the mathematics, not of a program: the tracked
chain of PyTorch launches, a fused N > M kernel or a CUDA graph of the chain
read against the same bound.  The peaks are ``roofline.py``'s.
"""
from __future__ import annotations

from typing import Iterable, Mapping

from perfbench import roofline
from perfbench.roofline import FP32_FLOP_PER_S, HBM_BYTES_PER_S


def svt_macs(n: int, m: int) -> int:
    """Complex multiply-adds of one tracked SVT of an n×m iterate taken with
    its basis on the side of n (n×n): the cheaper of ``roofline.admm_flops``'
    P form and Gram form."""
    half = n * (n + 1) // 2
    p_form = 2 * n * n * m + (n // 2) * (7 * m + 4 * n)
    gram_form = half * m + n ** 3 + 2 * half * n + (n // 2) * 12 * n + n * n * m
    return min(p_form, gram_form)


def admm_flops(B: int, N: int, M: int, Gr: int, K: int, Imax: int) -> float:
    """Real float32 operations over Imax iterations (8 per complex
    multiply-add): ``roofline.admm_flops`` with its SVT, counted there on the
    side of N, counted instead on the thin side min(N, M)."""
    thin, wide = min(N, M), max(N, M)
    return roofline.admm_flops(B, N, M, Gr, K, Imax) + 8.0 * Imax * B * (svt_macs(thin, wide) - svt_macs(N, M))


def admm_bound_s(B: int, N: int, M: int, Gr: int, K: int, Imax: int, rank: bool = False) -> float:
    """The least time of one call: the larger of the operations over the
    float32 peak and the bytes (``roofline.admm_bytes``: each input read and
    each output written once) over the HBM bandwidth."""
    return max(admm_flops(B, N, M, Gr, K, Imax) / FP32_FLOP_PER_S,
               roofline.admm_bytes(B, N, M, Gr, K, rank) / HBM_BYTES_PER_S)


def sweep_bound_s(calls: Iterable[Mapping[str, int]]) -> float:
    """The least time of a sequence of calls, each given by its shapes: the
    sum of their bounds."""
    return sum(admm_bound_s(c["B"], c["N"], c["M"], c["Gr"], c["K"], c["Imax"], bool(c.get("rank", False)))
               for c in calls)
