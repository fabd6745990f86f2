"""Structured operators (counterpart of ``jstsp19_tpu/ops/structured.py``):
``IdentityOp``, ``SubsetOp``, ``CenterOp``, ``TVOp``, ``HaarOp``,
``MedImageOp``, ``DemeanRCOp`` with ``demean_rc``, ``UnifVarOp``,
``FxnhandleOp`` with ``fxnhandle_op``, the random constructors
``random_unitary_op``, ``expander_graph_op`` and ``sparse_signed_op``,
``rbf_kernel_op`` and ``genie_normal_matvec``.

Each follows the :class:`~jstsp19_torch.ops.base.LinOp` adjoint-pair protocol
with exact ``sq_mv``/``sq_rmv`` variance maps (``MedImageOp`` and
``FxnhandleOp`` take the reference's Frobenius approximation, as in JAX).
Where the JAX package keeps index sets as static tuples (one trace per set),
here they are int64 tensors: a subset's rows (m,) shared by the batch, or
(B, m) with one row set per realization, and ``MedImageOp``'s k-space mask;
mean removal's row and column means are one set per realization.  The random
constructors draw from a ``torch.Generator`` on its device where JAX takes a
key: the matrices differ from JAX's, their structure does not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch

from jstsp19_torch.core.config import resolve_device
from jstsp19_torch.ops.base import LinOp, MatrixOp


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
class CenterOp(LinOp):
    """Mean removal ``P = I − 1·1ᵀ/n`` on length-``n`` vectors, the primitive
    behind ``LinTransDemean.m`` (``ComposedOp(CenterOp(m), base)`` demeans a
    base operator's output).  Self-adjoint; ``|P|²_ij = δ_ij·(1 − 2/n) +
    1/n²``."""

    n: int

    @property
    def in_shape(self):
        return (self.n,)

    @property
    def out_shape(self):
        return (self.n,)

    def mv(self, x):
        return x - x.mean(-1, keepdim=True)

    def rmv(self, y):
        return self.mv(y)

    def _sq(self, x):
        return (1.0 - 2.0 / self.n) * x + x.sum(-1, keepdim=True) / self.n**2

    def sq_mv(self, x):
        return self._sq(x)

    def sq_rmv(self, y):
        return self._sq(y)


def _pad_both(y):
    """(y with a zero before it, y with a zero after it), along the last axis."""
    zero = torch.zeros_like(y[..., :1])
    return torch.cat([zero, y], -1), torch.cat([y, zero], -1)


@dataclasses.dataclass(frozen=True)
class TVOp(LinOp):
    """1-D first differences ``(Dx)_i = x_{i+1} − x_i`` ∈ R^{n−1}
    (``LinTransTV.m``)."""

    n: int

    @property
    def in_shape(self):
        return (self.n,)

    @property
    def out_shape(self):
        return (self.n - 1,)

    def mv(self, x):
        return x[..., 1:] - x[..., :-1]

    def rmv(self, y):
        # (Dᵀy)_0 = −y_0, (Dᵀy)_i = y_{i−1} − y_i, (Dᵀy)_{n−1} = y_{n−2}
        lo, hi = _pad_both(y)
        return lo - hi

    def sq_mv(self, x):
        return x[..., 1:] + x[..., :-1]

    def sq_rmv(self, y):
        lo, hi = _pad_both(y)
        return lo + hi


def _interleave(e, o):
    """[e0, o0, e1, o1, …] along the last axis."""
    return torch.stack([e, o], -1).flatten(-2)


@dataclasses.dataclass(frozen=True)
class HaarOp(LinOp):
    """Orthonormal multi-level Haar transform on length-``n`` vectors, n a
    power of two (the ``LinTransWavelet.m`` capability), by lifting: per
    level ``a = (e + o)/√2``, ``d = (e − o)/√2``.  The adjoint is the
    inverse; the variance maps run the same pyramid on the squared
    coefficients (each butterfly ``(e + o)/2``).  Output layout
    ``[approx(level L) | details(level L) | … | details(1)]``."""

    n: int
    levels: int

    def __post_init__(self):
        if self.n & (self.n - 1):
            raise ValueError("HaarOp requires power-of-two length")
        if not 1 <= self.levels <= self.n.bit_length() - 1:
            raise ValueError("invalid level count")

    @property
    def in_shape(self):
        return (self.n,)

    @property
    def out_shape(self):
        return (self.n,)

    def _analysis(self, x, c):
        details, a = [], x
        for _ in range(self.levels):
            e, o = a[..., 0::2], a[..., 1::2]
            details.append((e - o) * c)
            a = (e + o) * c
        return torch.cat([a] + details[::-1], -1)

    def _synthesis(self, y, c, square):
        size = self.n >> self.levels
        a, off = y[..., :size], size
        for _ in range(self.levels):
            d = y[..., off:off + size]
            off += size
            a = _interleave((a + d) * c, (a + d) * c if square else (a - d) * c)
            size *= 2
        return a

    def mv(self, x):
        return self._analysis(x, 1.0 / math.sqrt(2.0))

    def rmv(self, y):
        return self._synthesis(y, 1.0 / math.sqrt(2.0), False)

    def sq_mv(self, x):
        details, a = [], x
        for _ in range(self.levels):
            a = (a[..., 0::2] + a[..., 1::2]) * 0.5
            details.append(a)
        return torch.cat([a] + details[::-1], -1)

    def sq_rmv(self, y):
        return self._synthesis(y, 0.5, True)


@dataclasses.dataclass(frozen=True)
class MedImageOp(LinOp):
    """Undersampled k-space acquisition (``main/MedImageLinTrans.m``):
    ``z = M·F·Wᴴ·x``, x the 2-D Haar coefficients of an (ny, nx) image in
    the quadrant (Mallat) layout, Wᴴ their orthonormal synthesis, F the
    orthonormal 2-D DFT (``torch.fft.fft2(norm="ortho")``) and M a k-space
    mask: ``mask_idx``, the int64 flat (row-major) indices of the acquired
    samples.  The adjoint accumulates into the full plane with
    ``index_add_`` (a repeated index adds).  The variance maps take the
    reference's uniform Frobenius approximation: every row of M·F·Wᴴ has
    unit norm, so |A|²·v ≈ sum(v)/N both ways.  Inputs and outputs are
    flat vectors, batched over leading axes."""

    ny: int
    nx: int
    levels: int
    mask_idx: torch.Tensor

    def __post_init__(self):
        if (self.ny & (self.ny - 1)) or (self.nx & (self.nx - 1)):
            raise ValueError("MedImageOp requires power-of-two image dims")
        max_lv = min(self.ny, self.nx).bit_length() - 1
        if not 1 <= self.levels <= max_lv:
            raise ValueError(f"levels must be in [1, {max_lv}] for a {self.ny}x{self.nx} image, got {self.levels}")

    @property
    def in_shape(self):
        return (self.ny * self.nx,)

    @property
    def out_shape(self):
        return (self.mask_idx.shape[-1],)

    def _synthesis(self, c):
        """Wavelet coefficients (…, ny, nx) → image."""
        r = 1.0 / math.sqrt(2.0)
        a = c.clone()
        for lev in reversed(range(self.levels)):
            h, w = self.ny >> lev, self.nx >> lev
            hh, hw = h // 2, w // 2
            ll, lh = a[..., :hh, :hw], a[..., :hh, hw:w]
            hl, hd = a[..., hh:h, :hw], a[..., hh:h, hw:w]
            # the inverse separable Haar: columns, then rows
            top = _interleave((ll + lh) * r, (ll - lh) * r)
            bot = _interleave((hl + hd) * r, (hl - hd) * r)
            a[..., :h, :w] = torch.stack([(top + bot) * r, (top - bot) * r], -2).flatten(-3, -2)
        return a

    def _analysis(self, img):
        """Image → wavelet coefficients (the synthesis's adjoint)."""
        r = 1.0 / math.sqrt(2.0)
        a = img.clone()
        for lev in range(self.levels):
            h, w = self.ny >> lev, self.nx >> lev
            sub = a[..., :h, :w]
            e_r, o_r = sub[..., 0::2, :], sub[..., 1::2, :]
            rows = torch.cat([(e_r + o_r) * r, (e_r - o_r) * r], -2)
            e_c, o_c = rows[..., :, 0::2], rows[..., :, 1::2]
            a[..., :h, :w] = torch.cat([(e_c + o_c) * r, (e_c - o_c) * r], -1)
        return a

    def mv(self, x):
        img = self._synthesis(x.reshape(x.shape[:-1] + (self.ny, self.nx)).to(torch.complex64))
        return torch.fft.fft2(img, norm="ortho").flatten(-2)[..., self.mask_idx]

    def rmv(self, z):
        full = torch.zeros(z.shape[:-1] + (self.ny * self.nx,), dtype=torch.complex64, device=z.device)
        full.index_add_(-1, self.mask_idx, z.to(torch.complex64))  # the adjoint accumulates
        img = torch.fft.ifft2(full.reshape(z.shape[:-1] + (self.ny, self.nx)), norm="ortho")
        return self._analysis(img).flatten(-2)

    def _sq(self, v, size):
        s = v.sum(-1, keepdim=True) / (self.ny * self.nx)
        return s.expand(v.shape[:-1] + (size,))

    def sq_mv(self, v):
        return self._sq(v, self.mask_idx.shape[-1])

    def sq_rmv(self, v):
        return self._sq(v, self.ny * self.nx)


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


@dataclasses.dataclass(frozen=True)
class FxnhandleOp(LinOp):
    """Operator from forward and adjoint callables on tensors
    (``main/FxnhandleLinTrans.m``) with the ``LinTrans.m:30-39`` Frobenius
    rank-1 variance approximation ``sq_mv(x) ≈ (‖A‖²_F/(m·n))·1·Σx``, summed
    over the operator's own trailing axes only (leading axes are a batch).
    Build it with :func:`fxnhandle_op`."""

    mv_fn: Callable
    rmv_fn: Callable
    shape_in: tuple
    shape_out: tuple
    fro2: torch.Tensor

    @property
    def in_shape(self):
        return self.shape_in

    @property
    def out_shape(self):
        return self.shape_out

    def mv(self, x):
        return self.mv_fn(x)

    def rmv(self, y):
        return self.rmv_fn(y)

    def _sq(self, v, from_shape, to_shape):
        s = v.sum(tuple(range(-len(from_shape), 0))) * (self.fro2 / (math.prod(self.shape_out) *
                                                                     math.prod(self.shape_in)))
        return s[(...,) + (None,) * len(to_shape)].expand(s.shape + tuple(to_shape))

    def sq_mv(self, x):
        return self._sq(x, self.shape_in, self.shape_out)

    def sq_rmv(self, y):
        return self._sq(y, self.shape_out, self.shape_in)


def fxnhandle_op(mv_fn, rmv_fn, in_shape, out_shape, fro2=None, key=None, n_probe: int = 8,
                 device=None) -> FxnhandleOp:
    """Wrap torch callables as a LinOp.  Without ``fro2``, ‖A‖²_F = E‖A·g‖²
    (g ~ CN(0, I)) is estimated from ``n_probe`` probes drawn from ``key``,
    a ``torch.Generator`` (a new one seeded 0 on ``device``, the card unless
    named, when none is given), as ``FxnhandleLinTrans.m`` does."""
    if fro2 is None:
        if key is None:
            key = torch.Generator(device=resolve_device(device)).manual_seed(0)
        g = torch.randn((n_probe,) + tuple(in_shape), generator=key, device=key.device, dtype=torch.complex64)
        fro2 = torch.stack([(mv_fn(v).abs() ** 2).sum() for v in g]).mean()
    return FxnhandleOp(mv_fn=mv_fn, rmv_fn=rmv_fn, shape_in=tuple(in_shape), shape_out=tuple(out_shape),
                       fro2=torch.as_tensor(fro2))


def random_unitary_op(gen: torch.Generator, n: int) -> MatrixOp:
    """A Haar-random unitary (``RandomUniTrans.m``): QR of a complex Gaussian
    with the phase fix that makes R's diagonal positive, complex64 on the
    generator's device."""
    G = torch.randn(n, n, generator=gen, device=gen.device, dtype=torch.complex64)  # CN(0, 1)
    Q, R = torch.linalg.qr(G)
    d = torch.diagonal(R)
    return MatrixOp(Q * (d / d.abs()).conj())


def _column_rows(gen: torch.Generator, m: int, n: int, d: int) -> torch.Tensor:
    """(n, d) distinct rows for each of n columns, uniform: the first d of a
    random permutation of m per column (argsort of uniforms)."""
    return torch.rand(n, m, generator=gen, device=gen.device).argsort(-1)[:, :d]


def _from_columns(rows: torch.Tensor, values, m: int) -> torch.Tensor:
    """The (m, n) float32 matrix with ``values`` at ``rows[j]`` of column j."""
    n, d = rows.shape
    A = torch.zeros(n, m, device=rows.device)
    A.scatter_(-1, rows, torch.as_tensor(values, dtype=torch.float32, device=rows.device).expand(n, d))
    return A.mT.contiguous()


def expander_graph_op(gen: torch.Generator, m: int, n: int, d: int) -> MatrixOp:
    """Sparse binary measurement matrix with ``d`` ones a column at uniform
    distinct rows (``ExpanderGraphLinTrans.m``), scaled by 1/√d to unit
    column norms; dense float32 storage on the generator's device."""
    return MatrixOp(_from_columns(_column_rows(gen, m, n, d), 1.0 / math.sqrt(d), m))


def sparse_signed_op(gen: torch.Generator, nz: int, nx: int, d: int) -> MatrixOp:
    """The sparse signed matrix of ``main/genSparseMat.m``: nz × nx with
    exactly ``d`` nonzeros a column at distinct uniform rows, each
    ``±√(nz/(d·nx))`` with a Rademacher sign; dense float32 storage."""
    rows = _column_rows(gen, nz, nx, d)
    signs = torch.randint(0, 2, (nx, d), generator=gen, device=gen.device).to(torch.float32) * 2.0 - 1.0
    return MatrixOp(_from_columns(rows, signs * math.sqrt(nz / (d * nx)), nz))


def rbf_kernel_op(X: torch.Tensor, gamma: float = 1.0) -> MatrixOp:
    """The RBF Gram operator ``K_ij = exp(−gamma·‖x_i − x_j‖²)`` over the rows
    of X (``KernelLinTrans.m``)."""
    sq = (X.abs() ** 2).sum(-1)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * (X @ X.mH).real
    return MatrixOp(torch.exp(-gamma * torch.clamp(d2, min=0.0)))


def genie_normal_matvec(A: LinOp, reg, support) -> Callable:
    """The matvec of ``(A_S·A_Sᴴ + reg·I)`` for an operator and a support
    mask S (``main/pcgHelper.m:1-18``): the adjoint image is zeroed off the
    support before the forward map, for matrix-free conjugate gradients on
    genie LMMSE systems."""

    def mv(x):
        r = A.rmv(x)
        return A.mv(torch.where(support, r, torch.zeros_like(r))) + reg * x

    return mv
