"""Masked and diagonal operators (counterpart of
``jstsp19_tpu/ops/masked.py``: ``MaskOp`` and ``DiagOp``).

``MaskOp`` is the random-spatial-sampling measurement mask Ω ∘ (·): its
normal matrix is diagonal, so the operator is the mask itself.  Either
tensor may carry a leading batch dimension, one per realization.
"""
from __future__ import annotations

import dataclasses

import torch

from jstsp19_torch.ops.base import LinOp


@dataclasses.dataclass(frozen=True)
class MaskOp(LinOp):
    """Elementwise 0/1 (or real-weighted) mask on matrices."""

    Omega: torch.Tensor  # real (..., N, M)

    @property
    def in_shape(self):
        return tuple(self.Omega.shape[-2:])

    @property
    def out_shape(self):
        return tuple(self.Omega.shape[-2:])

    def mv(self, X):
        return self.Omega * X

    def rmv(self, Y):
        return self.Omega * Y  # real mask ⇒ self-adjoint

    def sq_mv(self, X):
        return self.Omega**2 * X

    def sq_rmv(self, Y):
        return self.Omega**2 * Y


@dataclasses.dataclass(frozen=True)
class DiagOp(LinOp):
    """Diagonal operator on vectors (the ``LinTransDiag`` analog); d is (n,)
    or (B, n)."""

    d: torch.Tensor

    @property
    def in_shape(self):
        return (self.d.shape[-1],)

    @property
    def out_shape(self):
        return (self.d.shape[-1],)

    def mv(self, x):
        return self.d * x

    def rmv(self, y):
        return self.d.conj() * y

    def sq_mv(self, x):
        return self.d.abs() ** 2 * x

    def sq_rmv(self, y):
        return self.d.abs() ** 2 * y
