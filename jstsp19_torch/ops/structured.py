"""Structured operators of the GAMP path (counterpart of part of
``jstsp19_tpu/ops/structured.py``: ``IdentityOp``, ``SubsetOp``,
``DemeanRCOp`` with ``demean_rc``, and ``UnifVarOp``).

Each follows the :class:`~jstsp19_torch.ops.base.LinOp` adjoint-pair protocol
with exact ``sq_mv``/``sq_rmv`` variance maps.  Where the JAX package keeps a
subset's rows as a static tuple (one trace per row set), here they are a
tensor: (m,) shared by the batch, or (B, m) with one row set per
realization; mean removal's row and column means are likewise one set per
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
class DemeanRCOp(LinOp):
    """Row and column mean removal of a vector-domain operator A (m×n): the
    (m+2)×(n+2) operator of ``main/LinTransDemeanRC.m:1-40``

        Ad = [A − gam·1ᵀ − 1·colᴴ     b12·gam    b13·1 ;
              b21·1ᵀ                  −b12·b21   0     ;
              b31·colᴴ                0          −b31·b13]

    with gam = A·1/n (the row means) and colᴴ = 1ᵀA/m − mu·1ᵀ (the column
    means after the global mean), so that Ad·[x; 1ᵀx/b12; colᴴx/b13] =
    [A·x; 0; 0] and the core has zero row and column means.  The variance
    maps are the exact expansions of |Ad|² (``LinTransDemeanRC.m:163-216``).
    ``gam`` is (…, m) and ``col`` (…, n), one per realization where the
    leading axes are a batch; ``b12``, ``b21``, ``b13`` and ``b31`` are
    (…, 1).  Build it with :func:`demean_rc`."""

    base: LinOp
    gam: torch.Tensor
    col: torch.Tensor
    b12: torch.Tensor
    b21: torch.Tensor
    b13: torch.Tensor
    b31: torch.Tensor

    @property
    def in_shape(self):
        return (self.base.in_shape[0] + 2,)

    @property
    def out_shape(self):
        return (self.base.out_shape[0] + 2,)

    def _split(self, v, k):
        return v[..., :k], v[..., k:k + 1], v[..., k + 1:k + 2]

    def mv(self, xd):
        x, xr, xc = self._split(xd, self.base.in_shape[0])
        zr = self.b21 * (x.sum(-1, keepdim=True) - self.b12 * xr)
        zc = self.b31 * ((self.col.conj() * x).sum(-1, keepdim=True) - self.b13 * xc)
        z = self.base.mv(x) - self.gam * (zr / self.b21) - zc / self.b31
        return torch.cat([z, zr, zc], -1)

    def rmv(self, sd):
        s, sr, sc = self._split(sd, self.base.out_shape[0])
        xr = self.b12 * ((self.gam.conj() * s).sum(-1, keepdim=True) - self.b21 * sr)
        xc = self.b13 * (s.sum(-1, keepdim=True) - self.b31 * sc)
        x = self.base.rmv(s) - xr / self.b12 - self.col * (xc / self.b13)
        return torch.cat([x, xr, xc], -1)

    def sq_mv(self, xd):
        xv, xvr, xvc = self._split(xd, self.base.in_shape[0])
        gam2, col2 = self.gam.abs() ** 2, self.col.abs() ** 2
        pvr = self.b21**2 * (xv.sum(-1, keepdim=True) + self.b12**2 * xvr)
        pvc = self.b31**2 * ((col2 * xv).sum(-1, keepdim=True) + self.b13**2 * xvc)
        pv = (self.base.sq_mv(xv)
              - 2.0 * (self.gam.conj() * self.base.mv(xv)).real
              - 2.0 * self.base.mv(self.col * xv).real
              + 2.0 * (self.gam * (self.col * xv).sum(-1, keepdim=True)).real
              + pvc / self.b31**2
              + gam2 * (pvr / self.b21**2))
        return torch.cat([torch.clamp(pv.real, min=0.0), pvr, pvc], -1)

    def sq_rmv(self, sd):
        sv, svr, svc = self._split(sd, self.base.out_shape[0])
        gam2, col2 = self.gam.abs() ** 2, self.col.abs() ** 2
        rvr = self.b12**2 * ((gam2 * sv).sum(-1, keepdim=True) + self.b21**2 * svr)
        rvc = self.b13**2 * (sv.sum(-1, keepdim=True) + self.b31**2 * svc)
        rv = (self.base.sq_rmv(sv)
              - 2.0 * (self.col.conj() * self.base.rmv(sv)).real
              - 2.0 * self.base.rmv(self.gam * sv).real
              + 2.0 * (self.col * (self.gam * sv).sum(-1, keepdim=True)).real
              + rvr / self.b12**2
              + col2 * (rvc / self.b13**2))
        return torch.cat([torch.clamp(rv.real, min=0.0), rvr, rvc], -1)

    # -- the state's expansion and contraction (LinTransDemeanRC expandXhat/expandXvar)
    def expand_xhat(self, x):
        xr = x.sum(-1, keepdim=True) / self.b12
        xc = (self.col.conj() * x).sum(-1, keepdim=True) / self.b13
        return torch.cat([x.expand(*xr.shape[:-1], x.shape[-1]), xr, xc], -1)

    def expand_xvar(self, xv):
        xvr = xv.sum(-1, keepdim=True) / self.b12**2
        xvc = (self.col.abs() ** 2 * xv).sum(-1, keepdim=True) / self.b13**2
        return torch.cat([xv.expand(*xvr.shape[:-1], xv.shape[-1]), xvr, xvc], -1)

    def expand_out(self, z, fill=0.0):
        return torch.cat([z, torch.full(z.shape[:-1] + (2,), fill, dtype=z.dtype, device=z.device)], -1)

    def contract(self, xd):
        return xd[..., :self.base.in_shape[0]]

    def contract_out(self, zd):
        return zd[..., :self.base.out_shape[0]]


def demean_rc(base: LinOp, batch=(), device=None) -> DemeanRCOp:
    """The row and column demeaned augmentation of ``base``
    (``LinTransDemeanRC.m:80-98``), with one set of means per realization
    of ``batch``: one batched ``base.mv`` of ones and one ``base.rmv`` of
    ones.  The Frobenius term's ``1ᵀ·A·col`` is ``(Aᴴ1)ᴴ·col`` from that
    adjoint, where the JAX package applies ``base.mv`` to col once more."""
    (n,), (m,) = base.in_shape, base.out_shape
    ones_n = torch.ones(tuple(batch) + (n,), dtype=torch.float32, device=device)
    A1 = base.mv(ones_n)
    R1 = base.rmv(torch.ones(tuple(batch) + (m,), dtype=A1.dtype, device=A1.device))
    mu = A1.sum(-1, keepdim=True) / (m * n)
    col = R1 / m - mu.conj()
    gam = A1 / n
    gam2, col2 = gam.abs() ** 2, col.abs() ** 2
    fro2 = (base.sq_mv(ones_n).sum(-1, keepdim=True)
            - 2.0 * ((gam.conj() * A1).sum(-1, keepdim=True) + (R1.conj() * col).sum(-1, keepdim=True)).real
            # the cross term +2Re<gam·1ᵀ, 1·colᴴ> = +2Re(Σgam·Σcol); Σcol is 0
            # by construction, but the sign is the expansion's
            + 2.0 * (gam.sum(-1, keepdim=True) * col.sum(-1, keepdim=True)).real
            + n * gam2.sum(-1, keepdim=True)
            + m * col2.sum(-1, keepdim=True))
    fro2 = torch.clamp(fro2.real, min=1e-30)
    b12 = torch.clamp(torch.sqrt(fro2 / (n * torch.clamp(gam2.sum(-1, keepdim=True), min=1e-30))), max=1.0)
    b21 = torch.sqrt(fro2 / (m * (n + b12**2)))
    b13 = torch.sqrt(fro2 / (n * m))
    b31 = torch.sqrt(fro2 / (m * (col2.sum(-1, keepdim=True) + b13**2)))
    return DemeanRCOp(base=base, gam=gam, col=col, b12=b12, b21=b21, b13=b13, b31=b31)


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
