"""Linear-operator protocol: explicit adjoint pairs
(counterpart of ``jstsp19_tpu/ops/base.py::LinOp``, the part ``KronDictOp`` uses).

Every operator implements a forward map ``mv`` and its exact adjoint
``rmv`` (the ⟨Ax, y⟩ = ⟨x, Aᴴy⟩ contract of ``test/testlintrans.m:28-42``).
The JAX protocol's squared-magnitude pair ``sq_mv``/``sq_rmv`` waits for the
message-passing solvers that use it.  ``in_shape``/``out_shape`` describe one
unbatched input; a batch of realizations is a leading dimension of the
operands.
"""
from __future__ import annotations

from typing import Tuple

import torch


class LinOp:
    """Adjoint-pair protocol."""

    in_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]

    def mv(self, x: torch.Tensor) -> torch.Tensor:  # forward
        raise NotImplementedError

    def rmv(self, y: torch.Tensor) -> torch.Tensor:  # adjoint
        raise NotImplementedError
