"""Orthonormal fast Walsh–Hadamard transform along the last axis in CUDA.

Counterpart of ``jstsp19_tpu/kernels/wht.py::pallas_fwht`` (the Pallas TPU
kernel) and of the XLA butterflies of ``jstsp19_tpu/ops/fourier.py``.  The
CUDA kernel (``csrc/fwht.cu``) runs the natural-order radix-2 butterflies,
divides by √n and folds the sequency permutation into its loads or stores;
float32 rows, or complex64 rows read as interleaved pairs.  Its source note
says what bounds it and how rows longer than one block's shared memory are
split.  Unlike ``pallas_fwht``, which casts to float32, a complex input keeps
its imaginary part, as the JAX package's ``fwht`` does.

The plain versions (:func:`fwht_plain`, :func:`ifwht_plain`) are
``ops/fourier.py::fwht``/``ifwht`` of the JAX package in torch, with the
same arithmetic as the kernel, so the two agree bit for bit.
:func:`fwht_kernel` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  ``fwht_kernel.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from jstsp19_torch.kernels.build import raise_on_launch_error

_MODES = {("natural", False): 0, ("natural", True): 0, ("sequency", False): 1, ("sequency", True): 2}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from jstsp19_torch.kernels.build import load

    lib = load("fwht")
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.fwht_launch.argtypes = [vp, vp, vp, ll, i, i, i, ctypes.c_float, vp]
    lib.fwht_launch.restype = i
    lib.fwht_row_limit.argtypes = [i]
    lib.fwht_row_limit.restype = ll
    lib.fwht_max_log2n.argtypes = []
    lib.fwht_max_log2n.restype = i
    return lib


def _log2(n: int) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"FWHT length must be a power of two, got {n}")
    return n.bit_length() - 1


def _fwht_natural(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized FWHT in natural (Hadamard) order along the last axis:
    log2(n) reshape+add stages."""
    n = x.shape[-1]
    _log2(n)
    lead = x.shape[:-1]
    h = 1
    y = x
    while h < n:
        y = y.reshape(*lead, n // (2 * h), 2, h)
        a, b = y[..., 0, :], y[..., 1, :]
        y = torch.stack([a + b, a - b], dim=-2).reshape(*lead, n)
        h *= 2
    return y


@functools.lru_cache(maxsize=None)
def _sequency_perm(n: int) -> np.ndarray:
    """Permutation taking natural-order WHT output to sequency order (rows
    sorted by sign-change count, per ``fastWHtrans.cpp``):
    natural_index = bit_reverse(binary_to_gray(sequency_index))."""
    p = n.bit_length() - 1
    k = np.arange(n)
    gray = k ^ (k >> 1)
    rev = np.zeros_like(k)
    t = gray.copy()
    for _ in range(p):
        rev = (rev << 1) | (t & 1)
        t >>= 1
    return rev


@functools.lru_cache(maxsize=None)
def _index(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    perm = _sequency_perm(n)
    return torch.from_numpy(np.argsort(perm) if inverse else perm).to(device)


def _scaled(y: torch.Tensor, n: int) -> torch.Tensor:
    """``y / √n`` as a true division of each real component by √n in y's
    real dtype (a divisor on y's device, so CUDA does not multiply by its
    reciprocal), which is what the kernel computes in float32."""
    re = torch.view_as_real(y) if y.is_complex() else y
    out = re / torch.tensor(math.sqrt(n), dtype=re.dtype, device=y.device)
    return torch.view_as_complex(out) if y.is_complex() else out


def _check_ordering(ordering: str) -> None:
    if ordering not in ("sequency", "natural"):
        raise ValueError(f"unknown ordering {ordering!r}")


def fwht_plain(x: torch.Tensor, ordering: str = "sequency") -> torch.Tensor:
    """Orthonormal FWHT along the last axis ('sequency' or 'natural' order);
    self-inverse in natural order."""
    _check_ordering(ordering)
    n = x.shape[-1]
    y = _fwht_natural(x)
    if ordering == "sequency":
        y = y[..., _index(n, False, y.device)]
    return _scaled(y, n)


def ifwht_plain(y: torch.Tensor, ordering: str = "sequency") -> torch.Tensor:
    """Inverse (= adjoint) of :func:`fwht_plain`."""
    _check_ordering(ordering)
    n = y.shape[-1]
    if ordering == "sequency":
        y = y[..., _index(n, True, y.device)]
    return _scaled(_fwht_natural(y), n)


def fwht_kernel(x: torch.Tensor, ordering: str = "sequency", inverse: bool = False) -> torch.Tensor:
    """The orthonormal FWHT (``inverse=True``: its inverse) along the last
    axis of x, (..., n) float32 or complex64 with n a power of two.
    Returns a new tensor."""
    if x.device.type == "cpu":
        return (ifwht_plain if inverse else fwht_plain)(x, ordering)
    if x.device.type != "cuda":
        raise ValueError(f"fwht_kernel runs on CPU or CUDA tensors, got {x.device}")
    _check_ordering(ordering)
    if x.dtype not in (torch.float32, torch.complex64):
        raise ValueError(f"fwht_kernel takes float32 or complex64, got {x.dtype}")
    n = x.shape[-1]
    log2n = _log2(n)
    lib = _library()
    if log2n < 1 or log2n > lib.fwht_max_log2n():
        raise ValueError(f"fwht_kernel supports n from 2 to 2^{lib.fwht_max_log2n()}, got n = {n}")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    rows = xc.numel() // n
    if rows == 0:
        return out
    cplx = xc.is_complex()
    scratch = out if n <= lib.fwht_row_limit(8 if cplx else 4) else torch.empty_like(xc)
    rc = lib.fwht_launch(
        xc.data_ptr(), out.data_ptr(), scratch.data_ptr(), rows, log2n, int(cplx),
        _MODES[(ordering, inverse)], math.sqrt(n), torch.cuda.current_stream(x.device).cuda_stream,
    )
    raise_on_launch_error("fwht_kernel", rc)
    fwht_kernel.launches += 1
    return out


fwht_kernel.launches = 0
