"""Linear-operator protocol: explicit adjoint pairs, and the dense, adjoint,
scaled, composed, stacked and block-diagonal operators (counterpart of
``jstsp19_tpu/ops/base.py``: ``LinOp``, ``MatrixOp``, ``AdjointOp``,
``ScaledOp``, ``ComposedOp``, ``ConcatOp`` and ``BlockDiagOp``).

Every operator implements a forward map ``mv`` and its exact adjoint
``rmv`` (the ⟨Ax, y⟩ = ⟨x, Aᴴy⟩ contract of ``test/testlintrans.m:28-42``),
plus the squared-magnitude pair ``sq_mv``/``sq_rmv`` that message-passing
solvers use for variance propagation (the exact |A|² product).
``in_shape``/``out_shape`` describe one unbatched input; a batch of
realizations is a leading dimension of the operands, and an operator's own
tensors may carry it too (one operator per realization).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` over the last axis of x, A (..., m, n) with leading
    dimensions broadcast, the two promoted to a common dtype as JAX does."""
    dt = torch.promote_types(A.dtype, x.dtype)
    return torch.matmul(A.to(dt), x.to(dt).unsqueeze(-1)).squeeze(-1)


class LinOp:
    """Adjoint-pair protocol."""

    in_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]

    def mv(self, x: torch.Tensor) -> torch.Tensor:  # forward
        raise NotImplementedError

    def rmv(self, y: torch.Tensor) -> torch.Tensor:  # adjoint
        raise NotImplementedError

    def sq_mv(self, x: torch.Tensor) -> torch.Tensor:
        """Forward map of |A|² on nonnegative inputs (variance propagation)."""
        raise NotImplementedError

    def sq_rmv(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @property
    def H(self) -> "AdjointOp":
        return AdjointOp(self)


@dataclasses.dataclass(frozen=True)
class MatrixOp(LinOp):
    """Dense matrix operator on vectors: A is (m, n), or (B, m, n) with one
    matrix per realization."""

    A: torch.Tensor

    @property
    def in_shape(self):
        return (self.A.shape[-1],)

    @property
    def out_shape(self):
        return (self.A.shape[-2],)

    def mv(self, x):
        return _matvec(self.A, x)

    def rmv(self, y):
        return _matvec(self.A.mH, y)

    def sq_mv(self, x):
        return _matvec(self.A.abs() ** 2, x)

    def sq_rmv(self, y):
        return _matvec((self.A.abs() ** 2).mT, y)

    # -- eigenbasis protocol (one-sided analog of KronDictOp's) ------------
    def gram_in_eig(self):
        """Eigen-factorization of AᴴA: (V, None, d), with the call shape of
        ``KronDictOp``'s."""
        d, V = torch.linalg.eigh(self.A.mH @ self.A)
        return V, None, torch.clamp(d, min=0.0)

    # x is a batch of vectors (..., n), V shared or one per realization: a
    # matrix product per vector (``V.mH @ x`` would treat the batch as the
    # columns of one matrix)
    @staticmethod
    def to_eigbasis(V, _unused, x):
        return _matvec(V.mH, x)

    @staticmethod
    def from_eigbasis(V, _unused, xt):
        return _matvec(V, xt)


@dataclasses.dataclass(frozen=True)
class AdjointOp(LinOp):
    """Lazy adjoint of another operator."""

    base: LinOp

    @property
    def in_shape(self):
        return self.base.out_shape

    @property
    def out_shape(self):
        return self.base.in_shape

    def mv(self, x):
        return self.base.rmv(x)

    def rmv(self, y):
        return self.base.mv(y)

    def sq_mv(self, x):
        return self.base.sq_rmv(x)

    def sq_rmv(self, y):
        return self.base.sq_mv(y)


@dataclasses.dataclass(frozen=True)
class ScaledOp(LinOp):
    """``alpha · A``: alpha a (complex) number, or one per realization
    shaped (B, 1)."""

    base: LinOp
    alpha: object

    @property
    def in_shape(self):
        return self.base.in_shape

    @property
    def out_shape(self):
        return self.base.out_shape

    def _abs2(self):
        return abs(self.alpha) ** 2

    def mv(self, x):
        return self.alpha * self.base.mv(x)

    def rmv(self, y):
        a = self.alpha
        return (a.conj() if isinstance(a, torch.Tensor) else a.conjugate()) * self.base.rmv(y)

    def sq_mv(self, x):
        return self._abs2() * self.base.sq_mv(x)

    def sq_rmv(self, y):
        return self._abs2() * self.base.sq_rmv(y)


@dataclasses.dataclass(frozen=True)
class ComposedOp(LinOp):
    """``outer ∘ inner`` (apply inner first), the ``LinTransCompose`` analog."""

    outer: LinOp
    inner: LinOp

    @property
    def in_shape(self):
        return self.inner.in_shape

    @property
    def out_shape(self):
        return self.outer.out_shape

    def mv(self, x):
        return self.outer.mv(self.inner.mv(x))

    def rmv(self, y):
        return self.inner.rmv(self.outer.rmv(y))

    def sq_mv(self, x):
        return self.outer.sq_mv(self.inner.sq_mv(x))

    def sq_rmv(self, y):
        return self.inner.sq_rmv(self.outer.sq_rmv(y))


@dataclasses.dataclass(frozen=True)
class ConcatOp(LinOp):
    """Vertical stack [A1; A2; …] on a shared input (``LinTransConcat``):
    ``mv`` returns a tuple of outputs, ``rmv`` takes one and sums the
    adjoints."""

    ops: Tuple[LinOp, ...]

    @property
    def in_shape(self):
        return self.ops[0].in_shape

    @property
    def out_shape(self):
        return tuple(op.out_shape for op in self.ops)

    def mv(self, x):
        return tuple(op.mv(x) for op in self.ops)

    def rmv(self, ys):
        return sum((op.rmv(y) for op, y in zip(self.ops[1:], ys[1:])), self.ops[0].rmv(ys[0]))

    def sq_mv(self, x):
        return tuple(op.sq_mv(x) for op in self.ops)

    def sq_rmv(self, ys):
        return sum((op.sq_rmv(y) for op, y in zip(self.ops[1:], ys[1:])), self.ops[0].sq_rmv(ys[0]))


@dataclasses.dataclass(frozen=True)
class BlockDiagOp(LinOp):
    """Block-diagonal operator over a block axis (``BlkdiagLinTrans``): A is
    (nblocks, m, n), one matrix a block, applied to x (..., nblocks, n)."""

    A: torch.Tensor

    @property
    def in_shape(self):
        return (self.A.shape[-3], self.A.shape[-1])

    @property
    def out_shape(self):
        return (self.A.shape[-3], self.A.shape[-2])

    def mv(self, x):
        return _matvec(self.A, x)

    def rmv(self, y):
        return _matvec(self.A.mH, y)

    def sq_mv(self, x):
        return _matvec(self.A.abs() ** 2, x)

    def sq_rmv(self, y):
        return _matvec((self.A.abs() ** 2).mT, y)
