"""Fast-transform operators: Walsh–Hadamard, DFT, Toeplitz and DCT
(counterpart of ``jstsp19_tpu/ops/fourier.py``: the analogs of the
reference's ``FWHTLinTrans`` (MEX ``fastWHtrans.cpp``), ``FourierLinTrans``,
``ToeplitzLinTrans`` and ``DCTLinTrans``).

The WHT is orthonormal, sequency-ordered with 1/√n scaling as
``fastWHtrans.cpp:97-140`` has it.  :func:`fwht` and :func:`ifwht` take the
route from the operand before any launch: the FWHT kernel
(``kernels/wht.py::fwht_kernel``) for a CUDA tensor it takes (float32 or
complex64, n from 2 to 2^24: ``kernels/wht.py::kernel_takes``), else the
plain version on the tensor's device, which runs any dtype and any power
of two, as the JAX package's XLA butterflies do.  ``fwht.kernel_calls`` and
``fwht.plain_calls`` (and ``ifwht``'s) count the calls of each route.  The
plain butterflies
(``_fwht_natural``) and the sequency permutation (``_sequency_perm``) live
beside the kernel in ``kernels/wht.py``.  The others are plain torch.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from jstsp19_torch.kernels.wht import fwht_kernel, fwht_plain, ifwht_plain, kernel_takes
from jstsp19_torch.ops.base import LinOp, MatrixOp


def fwht(x: torch.Tensor, ordering: str = "sequency") -> torch.Tensor:
    """Orthonormal fast Walsh–Hadamard transform along the last axis;
    ``ordering`` 'sequency' (``fastWHtrans.cpp``) or 'natural'."""
    if x.is_cuda and kernel_takes(x.dtype, x.shape[-1]):
        fwht.kernel_calls += 1
        return fwht_kernel(x, ordering)
    fwht.plain_calls += 1
    return fwht_plain(x, ordering)


def ifwht(y: torch.Tensor, ordering: str = "sequency") -> torch.Tensor:
    """Inverse orthonormal WHT (the forward transform up to the sequency
    permutation)."""
    if y.is_cuda and kernel_takes(y.dtype, y.shape[-1]):
        ifwht.kernel_calls += 1
        return fwht_kernel(y, ordering, inverse=True)
    ifwht.plain_calls += 1
    return ifwht_plain(y, ordering)


fwht.kernel_calls = fwht.plain_calls = 0
ifwht.kernel_calls = ifwht.plain_calls = 0


@dataclasses.dataclass(frozen=True)
class FWHTOp(LinOp):
    """Orthonormal Walsh–Hadamard operator on length-n vectors of any float
    or complex dtype, through :func:`fwht`'s and :func:`ifwht`'s routes.
    ``use_kernel=False`` runs the plain torch transform on any device (the
    comparison route of ``chip_smoke.py``)."""

    n: int
    ordering: str = "sequency"
    use_kernel: bool = True

    @property
    def in_shape(self):
        return (self.n,)

    @property
    def out_shape(self):
        return (self.n,)

    def mv(self, x):
        return fwht(x, self.ordering) if self.use_kernel else fwht_plain(x, self.ordering)

    def rmv(self, y):  # real orthonormal ⇒ adjoint = inverse
        return ifwht(y, self.ordering) if self.use_kernel else ifwht_plain(y, self.ordering)

    def sq_mv(self, x):
        # |W|² = 1/n · ones: uniform mixing
        return x.mean(-1, keepdim=True).expand_as(x)

    sq_rmv = sq_mv


@dataclasses.dataclass(frozen=True)
class DFTOp(LinOp):
    """Unitary DFT on length-n vectors (``FourierLinTrans`` analog)."""

    n: int

    @property
    def in_shape(self):
        return (self.n,)

    @property
    def out_shape(self):
        return (self.n,)

    def mv(self, x):
        return torch.fft.fft(x, dim=-1) / np.sqrt(self.n)

    def rmv(self, y):
        return torch.fft.ifft(y, dim=-1) * np.sqrt(self.n)

    def sq_mv(self, x):
        return x.mean(-1, keepdim=True).expand_as(x)

    sq_rmv = sq_mv


@dataclasses.dataclass(frozen=True)
class ToeplitzOp(LinOp):
    """Toeplitz operator as an FFT circular convolution
    (``ToeplitzLinTrans`` analog): ``col`` (..., m) is the first column,
    ``row`` (..., n) the first row (row[0] = col[0]), embedded in a circulant
    of length m + n − 1."""

    col: torch.Tensor
    row: torch.Tensor

    @property
    def in_shape(self):
        return (self.row.shape[-1],)

    @property
    def out_shape(self):
        return (self.col.shape[-1],)

    @staticmethod
    def _circulant_fft(first, pad, tail_rev):
        z = torch.zeros(*first.shape[:-1], pad, dtype=first.dtype, device=first.device)
        return torch.fft.fft(torch.cat([first, z, tail_rev], dim=-1), dim=-1)

    def mv(self, x):
        m, n = self.col.shape[-1], self.row.shape[-1]
        L = m + n - 1
        ker = self._circulant_fft(self.col, L - m - (n - 1), self.row[..., 1:].flip(-1))
        return torch.fft.ifft(torch.fft.fft(x, n=L, dim=-1) * ker, dim=-1)[..., :m]

    def rmv(self, y):
        # adjoint Toeplitz: first column conj(row), first row conj(col)
        m, n = self.col.shape[-1], self.row.shape[-1]
        L = m + n - 1
        ker = self._circulant_fft(self.row.conj(), L - n - (m - 1), self.col[..., 1:].flip(-1).conj())
        return torch.fft.ifft(torch.fft.fft(y, n=L, dim=-1) * ker, dim=-1)[..., :n]

    def sq_mv(self, x):
        return MatrixOp(self.materialize()).sq_mv(x)

    def sq_rmv(self, y):
        return MatrixOp(self.materialize()).sq_rmv(y)

    def materialize(self):
        m, n = self.col.shape[-1], self.row.shape[-1]
        d = torch.arange(m, device=self.col.device)[:, None] - torch.arange(n, device=self.col.device)[None, :]
        vals = torch.cat([self.row[..., 1:].flip(-1), self.col], dim=-1)  # index d + (n-1)
        return vals[..., d + n - 1]


# -- DCT (``DCTLinTrans`` analog), by the complex-FFT factorization (even/odd
# interleave and quarter-sample twist) that the JAX package uses


@functools.lru_cache(maxsize=None)
def _dct_consts(n: int):
    """Quarter-sample twist (complex64) and orthonormal scale (float32)."""
    k = np.arange(n)
    twist = np.exp(-1j * np.pi * k / (2 * n)).astype(np.complex64)
    scale = np.where(k == 0, 1.0 / np.sqrt(n), np.sqrt(2.0 / n)).astype(np.float32)
    return torch.from_numpy(twist), torch.from_numpy(scale)


def dct(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-II along the last axis (real input)."""
    twist, scale = (c.to(x.device) for c in _dct_consts(x.shape[-1]))
    v = torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], dim=-1)
    V = torch.fft.fft(v.to(torch.complex64), dim=-1)
    return (twist * V).real * scale


def idct(y: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-III (the inverse of :func:`dct`) along the last axis."""
    n = y.shape[-1]
    twist, scale = (c.to(y.device) for c in _dct_consts(n))
    w = y / scale
    w_nk = torch.cat([w[..., :1] * 0, w[..., 1:].flip(-1)], dim=-1)
    V = twist.conj() * (w - 1j * w_nk)
    v = torch.fft.ifft(V, dim=-1).real
    half = (n + 1) // 2
    x = torch.zeros_like(v)
    x[..., ::2] = v[..., :half]
    x[..., 1::2] = v[..., half:].flip(-1)
    return x


@dataclasses.dataclass(frozen=True)
class DCTOp(LinOp):
    """Orthonormal DCT-II on length-n real vectors (``main/DCTLinTrans.m``
    analog); real orthonormal, so the adjoint is the inverse transform."""

    n: int

    @property
    def in_shape(self):
        return (self.n,)

    @property
    def out_shape(self):
        return (self.n,)

    def mv(self, x):
        return dct(x)

    def rmv(self, y):
        return idct(y)

    def sq_mv(self, x):
        # |C_kn|² ≈ uniform 1/n (exact for row 0; 2·cos² averages to 1/n)
        return x.mean(-1, keepdim=True).expand_as(x)

    sq_rmv = sq_mv
