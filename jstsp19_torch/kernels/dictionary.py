"""Batched dictionary correlation ``Aᴴ·K_b·Bᴴ`` in one CUDA launch.

Counterpart of ``jstsp19_tpu/kernels/dictionary.py::dict_correlation`` (the
Pallas TPU kernel).  The CUDA kernel (``csrc/dict_correlation.cu``) runs one
thread block per matrix of K and keeps the Aᴴ·K intermediate in shared
memory; its source note says what bounds it.  It reads torch's interleaved
complex64 as it is, and A and B may be shared or one per matrix of K.  The
plain version (:func:`dict_correlation_plain`) is the einsum of
``dict_correlation_xla``.

:func:`dict_correlation` takes the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises.  ``dict_correlation.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from jstsp19_torch.kernels.build import SMEM_LIMIT_BYTES, check_tensor, raise_on_launch_error


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from jstsp19_torch.kernels.build import load

    lib = load("dict_correlation")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dict_correlation_launch.argtypes = [vp, ll, vp, vp, ll, vp, i, i, i, i, i, vp]
    lib.dict_correlation_launch.restype = i
    lib.dict_correlation_smem_bytes.argtypes = [i] * 4
    lib.dict_correlation_smem_bytes.restype = ll
    return lib


def smem_bytes(N: int, M: int, Gr: int, Kd: int) -> int:
    """Dynamic shared memory one block of the kernel needs (from the library)."""
    return int(_library().dict_correlation_smem_bytes(N, M, Gr, Kd))


def dict_correlation_plain(A: torch.Tensor, K: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version, ``einsum('ng,bnm,km->bgk', Ā, K, B̄)``
    with the leading dimensions broadcast."""
    return torch.einsum("...ng,...nm,...km->...gk", A.conj(), K, B.conj())


def dict_correlation(A: torch.Tensor, K: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``Aᴴ·K·Bᴴ`` for every (N, M) matrix of K.

    K is (..., N, M) complex64; A is (N, Gr) shared or (..., N, Gr) with K's
    leading dimensions; B is (Kd, M) shared or (..., Kd, M).  Returns
    (..., Gr, Kd).  The TPU kernel's signature is the shared case.
    """
    if K.device.type == "cpu":
        return dict_correlation_plain(A, K, B)
    if K.device.type != "cuda":
        raise ValueError(f"dict_correlation runs on CPU or CUDA tensors, got {K.device}")
    lead = tuple(K.shape[:-2])
    N, M = K.shape[-2:]
    Gr, Kd = A.shape[-1], B.shape[-2]
    dev = K.device
    check_tensor("K", K, lead + (N, M), torch.complex64, dev)
    check_tensor("A", A, (N, Gr) if A.dim() == 2 else lead + (N, Gr), torch.complex64, dev)
    check_tensor("B", B, (Kd, M) if B.dim() == 2 else lead + (Kd, M), torch.complex64, dev)
    need = smem_bytes(N, M, Gr, Kd)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"shapes N={N} M={M} Gr={Gr} Kd={Kd} need {need} B of shared memory, "
            f"more than the {SMEM_LIMIT_BYTES} B a block may use"
        )
    out = torch.empty(lead + (Gr, Kd), dtype=torch.complex64, device=dev)
    batch = math.prod(lead)
    if batch > 0 and Gr * Kd > 0:
        rc = _library().dict_correlation_launch(
            A.data_ptr(), 0 if A.dim() == 2 else N * Gr, K.data_ptr(),
            B.data_ptr(), 0 if B.dim() == 2 else Kd * M, out.data_ptr(),
            batch, N, M, Gr, Kd, torch.cuda.current_stream(dev).cuda_stream,
        )
        raise_on_launch_error("dict_correlation", rc)
        dict_correlation.launches += 1
    return out


dict_correlation.launches = 0
