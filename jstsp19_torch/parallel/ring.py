"""Ring collectives over a process group (counterpart of
``jstsp19_tpu/parallel/ring.py``, whose ``ppermute`` hops become batched
point-to-point sends, ``dist.batch_isend_irecv``).

Each hop sends this rank's buffer to the next rank and receives the previous
rank's, so after N−1 hops every rank has seen every rank's buffer without a
tree or a gather to one rank:

- :func:`ring_allreduce_mean` — the mean over the group in N−1 hops
  (equal to ``all_reduce(x)/N`` up to float32 summation order);
- :func:`ring_pipeline_map` — ``fn`` of every rank's buffer on every rank,
  each hop's transfer in flight while ``fn`` runs on the buffer at hand,
  results in origin order (the all-gather-then-map result);
- :func:`mc_mean_ring` — the Monte-Carlo mean of per-realization errors.

``group`` is a process group (say an axis of ``parallel/mesh.py``'s mesh);
``None`` is the whole world.  Under gloo the tensors live on the host.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _neighbours(group):
    group = group or dist.group.WORLD
    n, me = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    return group, n, me, nxt, prv


def _hop(buf: torch.Tensor, group, nxt: int, prv: int):
    """Start sending ``buf`` to ``nxt`` and receiving the same shape from
    ``prv``; returns (the receive buffer, the requests to wait on)."""
    recv = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf, nxt, group), dist.P2POp(dist.irecv, recv, prv, group)]
    return recv, dist.batch_isend_irecv(ops)


def ring_allreduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of ``x`` over ``group`` through an N−1-hop ring."""
    group, n, _, nxt, prv = _neighbours(group)
    acc = x.clone()
    buf = x.contiguous()
    for _ in range(n - 1):
        buf, reqs = _hop(buf, group, nxt, prv)
        for r in reqs:
            r.wait()
        acc += buf
    return acc / n


def ring_pipeline_map(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, group=None) -> torch.Tensor:
    """``fn`` applied to every rank's ``x`` on every rank; returns the
    results stacked in origin (rank) order, shape ``(n, *fn(x).shape)``.
    At step k the buffer at hand came from the rank k hops upstream; the
    next hop's transfer runs while ``fn`` computes on it."""
    group, n, me, nxt, prv = _neighbours(group)
    ys = [None] * n
    buf = x.contiguous()
    for k in range(n):
        pending = _hop(buf, group, nxt, prv) if k < n - 1 else None
        ys[(me - k) % n] = fn(buf)
        if pending is not None:
            buf, reqs = pending
            for r in reqs:
                r.wait()
    return torch.stack(ys)


def mc_mean_ring(errs: torch.Tensor, group=None) -> torch.Tensor:
    """Monte-Carlo mean of per-realization errors (rows of ``errs``, equal
    counts on every rank), ring-reduced over ``group``."""
    return ring_allreduce_mean(errs.mean(dim=0), group)


__all__ = ["ring_allreduce_mean", "ring_pipeline_map", "mc_mean_ring"]
