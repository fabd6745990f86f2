"""Implicit Kronecker dictionary operator
(counterpart of ``jstsp19_tpu/ops/kron.py::KronDictOp``).

The reference materializes ``K2 = kron(B.', A)`` (``proposed_algorithm.m:22``);
by the vec identity ``kron(B.', A)·vec(S) = vec(A·S·B)`` the forward map and
its adjoint are small dense products:

    mv:       S (Gr, K)  ->  A S B                 (N, M)
    rmv:      Y (N, M)   ->  Aᴴ Y Bᴴ               (Gr, K)
    gram:     S          ->  (AᴴA) S (B Bᴴ)        (Gr, K)
    gram_out: Y          ->  (A Aᴴ) Y (Bᴴ B)       (N, M)

the squared-magnitude pair ``sq_mv``/``sq_rmv`` is the same with |A|² and
|B|², the pseudo-inverse factorizes (``pinv(kron(P, Q)) = kron(pinv(P),
pinv(Q))``), and the eigenbases of both Grams factorize into two small
``eigh``s each (what VAMP's LMMSE stage needs).  A and
B are (N, Gr) and (K, M), or carry a leading batch dimension, one pair per
realization, so every transpose is ``.mT``/``.mH`` (JAX's ``.T`` on its 2-D
matrices; ``.T`` here would also reverse the batch axis).  ``rmv`` goes
through the dictionary-correlation kernel's wrapper
(``kernels/dictionary.py``: the CUDA kernel on CUDA tensors) where the three
operands are complex64 and the kernel's layout holds A (``fits``); any other
operator (a real one, or an A too large for a block's shared memory) takes
JAX's own form, ``Aᴴ·Y·Bᴴ`` by ``torch.matmul``.  The route is decided from
dtypes and shapes before any launch; ``KronDictOp.kernel_rmvs`` and
``KronDictOp.matmul_rmvs`` count the calls of each.  The other products stay
``torch.matmul``, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from jstsp19_torch.kernels.dictionary import dict_correlation, fits
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

    kernel_rmvs = 0  # calls of rmv that took the kernel's route
    matmul_rmvs = 0  # and that took torch.matmul's

    def rmv(self, Y):
        A, B = self.A, self.B
        if all(t.dtype is torch.complex64 for t in (A, Y, B)) and fits(Y.shape[-2], Y.shape[-1], A.shape[-1],
                                                                       B.shape[-2]):
            KronDictOp.kernel_rmvs += 1
            return dict_correlation(A, Y, B)
        KronDictOp.matmul_rmvs += 1
        dt = torch.promote_types(torch.promote_types(A.dtype, Y.dtype), B.dtype)
        return A.to(dt).mH @ Y.to(dt) @ B.to(dt).mH

    def sq_mv(self, S):
        return (self.A.abs() ** 2) @ S @ (self.B.abs() ** 2)

    def sq_rmv(self, Y):
        return (self.A.abs() ** 2).mT @ Y @ (self.B.abs() ** 2).mT

    def gram(self, S):
        """``K2ᴴK2`` in matrix form: (AᴴA)·S·(B·Bᴴ)."""
        return (self.A.mH @ self.A) @ S @ (self.B @ self.B.mH)

    def gram_out(self, Y):
        """``K2·K2ᴴ`` in matrix form: (A·Aᴴ)·Y·(Bᴴ·B)."""
        return (self.A @ self.A.mH) @ Y @ (self.B.mH @ self.B)

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

    def pinv_rmv(self, Y, rcond=None):
        """``K2⁺·vec(Y)`` in matrix form: ``pinv(A)·Y·pinv(B)``.  ``rcond``
        keeps ``jnp.linalg.pinv``'s meaning: singular values below rcond
        times the largest are dropped, by default 10·max(rows, cols)·eps of
        the dtype (``torch.linalg.pinv``'s own default drops the 10)."""
        return _pinv(self.A, rcond) @ Y @ _pinv(self.B, rcond)

    def materialize(self) -> torch.Tensor:
        """Dense ``kron(B.', A)``, (..., N·M, Gr·K), one per realization —
        tests only; never call on the hot path."""
        B, A = self.B.mT, self.A
        out = B[..., :, None, :, None] * A[..., None, :, None, :]
        return out.reshape(*out.shape[:-4], B.shape[-2] * A.shape[-2], B.shape[-1] * A.shape[-1])


def _pinv(M: torch.Tensor, rcond) -> torch.Tensor:
    if rcond is None:
        rcond = 10.0 * max(M.shape[-2:]) * torch.finfo(M.dtype).eps
    return torch.linalg.pinv(M, rtol=rcond)
