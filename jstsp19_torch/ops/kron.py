"""Implicit Kronecker dictionary operator
(counterpart of ``jstsp19_tpu/ops/kron.py::KronDictOp``).

The reference materializes ``K2 = kron(B.', A)`` (``proposed_algorithm.m:22``);
by the vec identity ``kron(B.', A)·vec(S) = vec(A·S·B)`` the forward map and
its adjoint are small dense products:

    mv:    S (Gr, K)  ->  A S B                 (N, M)
    rmv:   Y (N, M)   ->  Aᴴ Y Bᴴ               (Gr, K)

and the eigenbases of both Grams factorize into two small ``eigh``s each
(what VAMP's LMMSE stage needs).  A and
B are (N, Gr) and (K, M), or carry a leading batch dimension, one pair per
realization.  ``rmv`` goes through the dictionary-correlation kernel's
wrapper (``kernels/dictionary.py``: the CUDA kernel on CUDA tensors);
``mv`` stays ``torch.matmul``, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from jstsp19_torch.kernels.dictionary import dict_correlation
from jstsp19_torch.ops.base import LinOp


@dataclasses.dataclass(frozen=True)
class KronDictOp(LinOp):
    """``S ↦ A·S·B`` with A: (..., N, Gr), B: (..., K, M)."""

    A: torch.Tensor
    B: torch.Tensor

    @property
    def in_shape(self) -> Tuple[int, int]:
        return (self.A.shape[-1], self.B.shape[-2])

    @property
    def out_shape(self) -> Tuple[int, int]:
        return (self.A.shape[-2], self.B.shape[-1])

    def mv(self, S):
        return self.A @ S @ self.B

    def rmv(self, Y):
        return dict_correlation(self.A, Y, self.B)

    def gram_out_eig(self):
        """Eigen-factorization of ``K2·K2ᴴ``: (Ua, Ub, d) with
        d = outer(da, db) of shape (..., N, M)."""
        da, Ua = torch.linalg.eigh(self.A @ self.A.mH)
        db, Ub = torch.linalg.eigh(self.B.mH @ self.B)
        d = torch.clamp(da[..., :, None], min=0.0) * torch.clamp(db[..., None, :], min=0.0)
        return Ua, Ub, d

    def gram_in_eig(self):
        """Eigen-factorization of ``K2ᴴ·K2``: (Va, Vb, d) with
        d = outer(da, db) of shape (..., Gr, K)."""
        da, Va = torch.linalg.eigh(self.A.mH @ self.A)
        db, Vb = torch.linalg.eigh(self.B @ self.B.mH)
        d = torch.clamp(da[..., :, None], min=0.0) * torch.clamp(db[..., None, :], min=0.0)
        return Va, Vb, d

    @staticmethod
    def to_eigbasis(Ua, Ub, Y):
        return Ua.mH @ Y @ Ub

    @staticmethod
    def from_eigbasis(Ua, Ub, Yt):
        return Ua @ Yt @ Ub.mH
