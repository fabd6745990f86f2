"""Batched dictionary correlation ``Aᴴ·K_b·Bᴴ`` in one CUDA launch.

Counterpart of ``jstsp19_tpu/kernels/dictionary.py::dict_correlation`` (the
Pallas TPU kernel).  The CUDA kernel (``csrc/dict_correlation.cu``) computes
``Aᴴ·(K·Bᴴ)``, the cheaper association at every shape the port launches:
K's and B's columns stream through shared memory with ``cp.async`` while
``K·Bᴴ`` accumulates in registers, and several realizations share a block
where one would leave its threads idle; its source note says what bounds it.
It reads torch's interleaved complex64 as it is, and A and B may be shared
or one per matrix of K.  :func:`plan` picks the kernel's layout from the
shapes.  The plain version (:func:`dict_correlation_plain`) is the einsum of
``dict_correlation_xla``.

:func:`dict_correlation` takes the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises.  ``dict_correlation.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from jstsp19_torch.kernels.build import SMEM_LIMIT_BYTES, check_tensor, current_stream, raise_on_launch_error

_C64 = torch.complex64
THREADS = 256  # a block (kThreads in the source)
TILE_M = 64  # the most columns of K and B a staged tile holds


class DictPlan(NamedTuple):
    """The kernel's layout: ``rpb`` realizations a block, each on
    ``THREADS // rpb`` threads arranged ``tn × tk`` with a 2×2 register tile
    (so 2·tn rows of P and of the output and 2·tk columns a pass), tiles of
    ``mt`` columns of K and B, and the block's dynamic shared memory."""

    rpb: int
    tk: int
    mt: int
    smem_bytes: int


def _pow2(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def smem_bytes(N: int, Gr: int, rpb: int, tk: int, mt: int) -> int:
    """Dynamic shared memory a block of the kernel needs under (rpb, tk, mt),
    in complex64 entries of 8 bytes: per realization two stages of a K tile
    (2·tn rows) and a B tile (2·tk rows), rows padded to mt + 2; A (N, Gr),
    rounded up to an even count; P (N, 2·tk).  The library's
    ``dict_correlation_smem_bytes`` computes the same."""
    tn = THREADS // rpb // tk
    stages = 2 * (2 * tn + 2 * tk) * (mt + 2)
    return 8 * rpb * (stages + (N * Gr + 1) // 2 * 2 + N * 2 * tk)


def _tk(Kd: int) -> int:
    return min(32, _pow2(-(-Kd // 2)))


def fits(N: int, M: int, Gr: int, Kd: int) -> bool:
    """Whether :func:`plan` has a layout for these shapes: one realization a
    block with 4-column tiles (its smallest) fits the shared memory, which
    holds A (N, Gr) whole.  Pure Python, from the same layout."""
    return smem_bytes(N, Gr, 1, _tk(Kd), 4) <= SMEM_LIMIT_BYTES


@functools.lru_cache(maxsize=None)
def plan(N: int, M: int, Gr: int, Kd: int) -> DictPlan:
    """The layout for K (·, N, M), A (·, N, Gr), B (·, Kd, M).

    tk covers Kd in one pass (at most 32 threads); the realization's thread
    count, a power of two from 32 to 256, covers the larger of N and Gr in
    one pass; the rest of the block's 256 threads serve further
    realizations.  A tile holds M's columns rounded up to a multiple of 4,
    at most TILE_M (the widest measured the fastest at K (256, 32, 80) and
    (256, 32, 140) on an H100).  Where that does not fit the shared memory, the
    plan halves the realizations a block, then the tile; raises ValueError
    where even one realization with 4-column tiles does not fit."""
    tk = _tk(Kd)
    per = min(THREADS, max(32, _pow2(tk * -(-max(N, Gr) // 2))))
    rpb = THREADS // per
    mt = min(TILE_M, max(4, -(-M // 4) * 4))
    while True:
        need = smem_bytes(N, Gr, rpb, tk, mt)
        if need <= SMEM_LIMIT_BYTES:
            return DictPlan(rpb, tk, mt, need)
        if rpb > 1:
            rpb //= 2
        elif mt > 4:
            mt = max(4, mt // 8 * 4)
        else:
            raise ValueError(
                f"shapes N={N} M={M} Gr={Gr} Kd={Kd} need {need} B of shared memory, "
                f"more than the {SMEM_LIMIT_BYTES} B a block may use"
            )


class _Params(ctypes.Structure):
    """The library's ``DictParams``: what a launch needs besides the pointers."""

    _fields_ = [("a_stride", ctypes.c_longlong), ("b_stride", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in ("batch", "N", "M", "Gr", "Kd", "rpb", "tk", "mt")]


def params(batch: int, N: int, M: int, Gr: int, Kd: int, a_stride: int, b_stride: int, p: DictPlan) -> _Params:
    """A launch's ``DictParams`` under the plan ``p``; a_stride / b_stride are
    the complex entries between two realizations' A / B (0 = shared)."""
    return _Params(a_stride, b_stride, batch, N, M, Gr, Kd, p.rpb, p.tk, p.mt)


@functools.lru_cache(maxsize=None)
def _call(k_shape: torch.Size, a_shape: torch.Size, b_shape: torch.Size):
    """(the output's shape, the address of the launch's ``DictParams`` or 0
    where there is nothing to compute, the ``DictParams``) for operands of
    these shapes, one per shape for the process: a call reads the first two
    from here.  Raises ValueError where the shapes do not go together or the
    plan does not fit."""
    if len(k_shape) < 2 or len(a_shape) < 2 or len(b_shape) < 2:
        raise ValueError(f"K, A and B must be matrices, got shapes {tuple(k_shape)}, {tuple(a_shape)}, {tuple(b_shape)}")
    lead, (N, M) = k_shape[:-2], k_shape[-2:]
    Gr, Kd = a_shape[-1], b_shape[-2]
    a_shared, b_shared = len(a_shape) == 2, len(b_shape) == 2
    for name, got, want in (("A", a_shape, (N, Gr) if a_shared else lead + (N, Gr)),
                            ("B", b_shape, (Kd, M) if b_shared else lead + (Kd, M))):
        if tuple(got) != tuple(want):
            raise ValueError(f"{name} has shape {tuple(got)}, expected {tuple(want)}")
    batch = math.prod(lead)
    out_shape = lead + (Gr, Kd)
    if batch == 0 or Gr * Kd == 0:
        return out_shape, 0, None
    args = params(batch, N, M, Gr, Kd, 0 if a_shared else N * Gr, 0 if b_shared else Kd * M, plan(N, M, Gr, Kd))
    return out_shape, ctypes.addressof(args), args


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from jstsp19_torch.kernels.build import load

    lib = load("dict_correlation")
    vp = ctypes.c_void_p
    lib.dict_correlation_launch.argtypes = [vp] * 6
    lib.dict_correlation_launch.restype = ctypes.c_int
    lib.dict_correlation_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.dict_correlation_smem_bytes.restype = ctypes.c_longlong
    lib.dict_correlation_init.restype = ctypes.c_int
    raise_on_launch_error("dict_correlation (setting its shared-memory limit)", lib.dict_correlation_init())
    return lib


def dict_correlation_plain(A: torch.Tensor, K: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version, ``einsum('ng,bnm,km->bgk', Ā, K, B̄)``
    with the leading dimensions broadcast."""
    return torch.einsum("...ng,...nm,...km->...gk", A.conj(), K, B.conj())


def dict_correlation(A: torch.Tensor, K: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``Aᴴ·K·Bᴴ`` for every (N, M) matrix of K.

    K is (..., N, M) complex64; A is (N, Gr) shared or (..., N, Gr) with K's
    leading dimensions; B is (Kd, M) shared or (..., Kd, M).  Returns
    (..., Gr, Kd).  The TPU kernel's signature is the shared case.  Any
    start address is taken: operands off a 16-byte boundary (a view with a
    storage offset) or with an odd M are copied 8 bytes at a time.
    """
    if not K.is_cuda:
        if K.is_cpu:
            return dict_correlation_plain(A, K, B)
        raise ValueError(f"dict_correlation runs on CPU or CUDA tensors, got {K.device}")
    dev = K.device
    out_shape, args, _ = _call(K.shape, A.shape, B.shape)
    if not (K.dtype is _C64 and A.dtype is _C64 and B.dtype is _C64 and A.device == dev and B.device == dev
            and K.is_contiguous() and A.is_contiguous() and B.is_contiguous()
            and not (K.is_conj() or A.is_conj() or B.is_conj())):
        # a lazily conjugated operand keeps its values unconjugated in memory
        # (x.mH of a column-major x, as eigh returns, is contiguous with the
        # conjugate bit set): the kernel reads memory, so resolve it first
        A, K, B = A.resolve_conj(), K.resolve_conj(), B.resolve_conj()
        for name, x in (("K", K), ("A", A), ("B", B)):
            check_tensor(name, x, x.shape, _C64, dev)  # raises with what is wrong
    out = torch.empty(out_shape, dtype=_C64, device=dev)
    if args:
        rc = _library().dict_correlation_launch(
            A.data_ptr(), K.data_ptr(), B.data_ptr(), out.data_ptr(), args, current_stream(dev))
        if rc:
            raise_on_launch_error("dict_correlation", rc)
        dict_correlation.launches += 1
    return out


dict_correlation.launches = 0
