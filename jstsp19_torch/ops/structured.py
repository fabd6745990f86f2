"""Structured operators of the GAMP path (counterpart of part of
``jstsp19_tpu/ops/structured.py``: ``IdentityOp``, ``SubsetOp`` and
``UnifVarOp``).

Each follows the :class:`~jstsp19_torch.ops.base.LinOp` adjoint-pair protocol
with exact ``sq_mv``/``sq_rmv`` variance maps.  Where the JAX package keeps a
subset's rows as a static tuple (one trace per row set), here they are a
tensor: (m,) shared by the batch, or (B, m) with one row set per
realization.  The other operators of that module wait for the GAMP long
tail (ROADMAP Queue 1, item 7).
"""
from __future__ import annotations

import dataclasses

import torch

from jstsp19_torch.ops.base import LinOp


@dataclasses.dataclass(frozen=True)
class IdentityOp(LinOp):
    """Identity on length-``n`` vectors (``IdentityLinTrans.m``)."""

    n: int

    @property
    def in_shape(self):
        return (self.n,)

    @property
    def out_shape(self):
        return (self.n,)

    def mv(self, x):
        return x

    def rmv(self, y):
        return y

    def sq_mv(self, x):
        return x

    def sq_rmv(self, y):
        return y


@dataclasses.dataclass(frozen=True)
class SubsetOp(LinOp):
    """Keep a subset of the base operator's output rows
    (``LinTransSubset.m``): ``mv = (base·x)[idx]``; the adjoint scatters back
    into the kept rows and zero elsewhere.  ``idx`` is an integer tensor,
    (m,) or (B, m); rows may repeat."""

    base: LinOp
    idx: torch.Tensor

    @property
    def in_shape(self):
        return self.base.in_shape

    @property
    def out_shape(self):
        return (self.idx.shape[-1],)

    def _gather(self, y):
        if self.idx.dim() == 1:
            return y[..., self.idx]
        return torch.gather(y, -1, self.idx.expand(*y.shape[:-1], self.idx.shape[-1]))

    def _scatter(self, y):
        full = torch.zeros(*y.shape[:-1], *self.base.out_shape, dtype=y.dtype, device=y.device)
        # add, not set: the adjoint of a gather accumulates where idx
        # repeats a row (LinTransSubset.m permits duplicates)
        if self.idx.dim() == 1:
            return full.index_add_(-1, self.idx, y)
        return full.scatter_add_(-1, self.idx.expand(*y.shape[:-1], self.idx.shape[-1]), y)

    def mv(self, x):
        return self._gather(self.base.mv(x))

    def rmv(self, y):
        return self.base.rmv(self._scatter(y))

    def sq_mv(self, x):
        return self._gather(self.base.sq_mv(x))

    def sq_rmv(self, y):
        return self.base.sq_rmv(self._scatter(y))


@dataclasses.dataclass(frozen=True)
class UnifVarOp(LinOp):
    """Uniform-variance wrapper (``main/UnifVarLinTrans.m``): ``sq_mv`` and
    ``sq_rmv`` replace the leading ``in_avg``/``out_avg`` input entries by
    their mean, then the matching leading output entries by theirs (the
    ``GampOpt.uniformVariance`` mode); ``mv``/``rmv`` pass through.  -1
    averages everything."""

    base: LinOp
    in_avg: int = -1
    out_avg: int = -1

    @property
    def in_shape(self):
        return self.base.in_shape

    @property
    def out_shape(self):
        return self.base.out_shape

    def mv(self, x):
        return self.base.mv(x)

    def rmv(self, y):
        return self.base.rmv(y)

    @staticmethod
    def _avg(v, k):
        if k < 0 or k >= v.shape[-1]:
            return v.mean(-1, keepdim=True).expand_as(v)
        head = v[..., :k].mean(-1, keepdim=True).expand_as(v[..., :k])
        return torch.cat([head, v[..., k:]], dim=-1)

    def sq_mv(self, x):
        return self._avg(self.base.sq_mv(self._avg(x, self.in_avg)), self.out_avg)

    def sq_rmv(self, y):
        return self._avg(self.base.sq_rmv(self._avg(y, self.out_avg)), self.in_avg)
