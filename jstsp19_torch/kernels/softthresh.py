"""Complex soft threshold in one CUDA pass.

Counterpart of ``jstsp19_tpu/kernels/softthresh.py::fused_soft_threshold``
(the Pallas TPU kernel).  The CUDA kernel (``csrc/soft_threshold.cu``) reads
torch's interleaved complex64 once and writes it once, 16 bytes a thread,
with one τ for everything or one τ per (n, m) matrix, read once by each
thread; its source note says what bounds it.  The plain version
(:func:`fused_soft_threshold_plain`) is ``solvers/sparse.py::soft_threshold``.

:func:`fused_soft_threshold` takes the plain version for CPU tensors only;
for CUDA tensors it launches the kernel or raises.
``fused_soft_threshold.launches`` counts kernel launches.  The solvers call
:func:`fused_soft_threshold_routed`, which takes the kernel only for a v it
takes (:func:`kernel_takes`: complex64) and the plain version for any other.
"""
from __future__ import annotations

import ctypes
import functools
import numbers

import torch

from jstsp19_torch.kernels.build import check_tensor, current_stream, raise_on_launch_error
from jstsp19_torch.solvers.sparse import soft_threshold


class _Params(ctypes.Structure):
    """The library's ``SoftParams``: what a launch needs besides the pointers
    and a τ given by value."""

    _fields_ = [("tau_stride", ctypes.c_longlong), ("group", ctypes.c_longlong), ("groups", ctypes.c_longlong)]


@functools.lru_cache(maxsize=None)
def _call(total: int, group: int):
    """(the address of the launch's ``SoftParams``, the ``SoftParams``) for
    ``total`` entries in groups of ``group`` with one τ each (one group: one τ
    for all), one per layout for the process."""
    args = _Params(1 if group < total else 0, group, total // group)
    return ctypes.addressof(args), args


@functools.lru_cache(maxsize=None)
def _matrix_size(v_shape: torch.Size, tau_shape: torch.Size) -> int:
    """n·m where τ has one entry per matrix of v, ``v_shape[:-2] + (1, 1)``,
    as the solve passes it; else 0."""
    return v_shape[-2] * v_shape[-1] if tuple(tau_shape) == tuple(v_shape[:-2]) + (1, 1) else 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from jstsp19_torch.kernels.build import load

    lib = load("soft_threshold")
    vp = ctypes.c_void_p
    lib.soft_threshold_launch.argtypes = [vp, vp, vp, vp, ctypes.c_float, vp]
    lib.soft_threshold_launch.restype = ctypes.c_int
    return lib


def _tau_per_matrix(tau, v: torch.Tensor) -> torch.Tensor:
    """τ as a tensor of v's real dtype (float32 for the kernel's complex64)
    of shape () (one for all) or v.shape[:-2] (one per matrix, a broadcast
    view where τ broadcasts).  Takes a number or a (..., 1, 1) tensor that
    broadcasts over v's leading dimensions, as the solve's ``thr_S`` is."""
    t = torch.as_tensor(tau, dtype=v.real.dtype, device=v.device)
    if t.dim() == 0:
        return t
    if t.dim() < 2 or t.shape[-2:] != (1, 1):
        raise ValueError(f"tau must be a number or shaped (..., 1, 1), got {tuple(t.shape)}")
    return t[..., 0, 0].broadcast_to(v.shape[:-2])


def kernel_takes(dtype: torch.dtype) -> bool:
    """Whether :func:`fused_soft_threshold` takes a v of this dtype:
    complex64.  The callers' route (:func:`fused_soft_threshold_routed`) is
    decided by this, before any launch.  Pure Python."""
    return dtype is torch.complex64


def fused_soft_threshold_plain(v: torch.Tensor, tau) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``solvers/sparse.py::soft_threshold``
    with τ broadcast over the last two axes."""
    return soft_threshold(v, _tau_per_matrix(tau, v)[..., None, None])


def fused_soft_threshold(v: torch.Tensor, tau) -> torch.Tensor:
    """``sign(Re v)·max(|Re v|−τ, 0) + j·sign(Im v)·max(|Im v|−τ, 0)``.

    v is (..., n, m) complex64; τ is a number or one τ per matrix, shaped
    (..., 1, 1).  Returns a new tensor.  A number goes to the kernel by
    value and a float32 τ on v's device as it lies (a broadcast one with
    stride 0), so a call copies nothing to the device; only a τ broadcast
    over some leading dimensions and not over others is made contiguous.
    """
    if not v.is_cuda:
        if v.is_cpu:
            return fused_soft_threshold_plain(v, tau)
        raise ValueError(f"fused_soft_threshold runs on CPU or CUDA tensors, got {v.device}")
    shape, dev = v.shape, v.device
    if len(shape) < 2:
        raise ValueError(f"v must be (..., n, m), got shape {tuple(shape)}")
    if not (v.dtype is torch.complex64 and v.is_contiguous() and not v.is_conj()):
        v = v.resolve_conj()  # the kernel reads memory, which a lazy conjugate leaves unconjugated
        check_tensor("v", v, shape, torch.complex64, dev)  # raises with what is wrong
    total, ptr, value = v.numel(), None, 0.0
    group = total  # entries under one τ
    if (isinstance(tau, torch.Tensor) and tau.dtype is torch.float32 and tau.device == dev
            and tau.is_contiguous() and _matrix_size(shape, tau.shape)):
        group, ptr = _matrix_size(shape, tau.shape), tau.data_ptr()
    elif isinstance(tau, numbers.Real):
        value = float(tau)
    else:
        t = _tau_per_matrix(tau, v)
        if t.dim() > 0 and any(t.stride()):
            if not t.is_contiguous():
                t = t.contiguous()
            group = shape[-2] * shape[-1]
        ptr = t.data_ptr()
    out = torch.empty_like(v)
    if total > 0:
        args, _ = _call(total, group)
        rc = _library().soft_threshold_launch(v.data_ptr(), out.data_ptr(), ptr, args, value, current_stream(dev))
        if rc:
            raise_on_launch_error("fused_soft_threshold", rc)
        fused_soft_threshold.launches += 1
    return out


fused_soft_threshold.launches = 0


def fused_soft_threshold_routed(v: torch.Tensor, tau) -> torch.Tensor:
    """The soft threshold by the route v allows, decided before any launch:
    :func:`fused_soft_threshold`'s kernel for a CUDA v it takes
    (:func:`kernel_takes`), else :func:`fused_soft_threshold_plain` on v's
    device and at its dtype, as the JAX package's solvers compute it.
    ``fused_soft_threshold_routed.kernel_calls`` and ``.plain_calls`` count
    the calls of each route."""
    if v.is_cuda and kernel_takes(v.dtype):
        fused_soft_threshold_routed.kernel_calls += 1
        return fused_soft_threshold(v, tau)
    fused_soft_threshold_routed.plain_calls += 1
    return fused_soft_threshold_plain(v, tau)


fused_soft_threshold_routed.kernel_calls = fused_soft_threshold_routed.plain_calls = 0
