"""Parallel-ordering (round-robin) Jacobi schedules.

Counterpart of the two numpy tables of ``jstsp19_tpu/ops/jacobi.py:23,43``;
the batched Jacobi eigensolver itself is not ported yet.
"""
from __future__ import annotations

import functools

import numpy as np


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
