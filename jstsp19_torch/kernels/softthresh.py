"""Complex soft threshold in one CUDA pass.

Counterpart of ``jstsp19_tpu/kernels/softthresh.py::fused_soft_threshold``
(the Pallas TPU kernel).  The CUDA kernel (``csrc/soft_threshold.cu``) reads
torch's interleaved complex64 once and writes it once, with one τ for
everything or one τ per (n, m) matrix; its source note says what bounds it.  The plain version (:func:`fused_soft_threshold_plain`)
is ``solvers/sparse.py::soft_threshold``.

:func:`fused_soft_threshold` takes the plain version for CPU tensors only;
for CUDA tensors it launches the kernel or raises.
``fused_soft_threshold.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import torch

from jstsp19_torch.kernels.build import check_tensor, raise_on_launch_error
from jstsp19_torch.solvers.sparse import soft_threshold


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from jstsp19_torch.kernels.build import load

    lib = load("soft_threshold")
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.soft_threshold_launch.argtypes = [vp, vp, ll, vp, ll, vp]
    lib.soft_threshold_launch.restype = ctypes.c_int
    return lib


def _tau_per_matrix(tau, v: torch.Tensor) -> torch.Tensor:
    """τ as a float32 tensor of shape () (one for all) or v.shape[:-2] (one
    per matrix).  Takes a number or a (..., 1, 1) tensor that broadcasts
    over v's leading dimensions, as the solve's ``thr_S`` is."""
    t = torch.as_tensor(tau, dtype=torch.float32, device=v.device)
    if t.dim() == 0:
        return t
    if t.dim() < 2 or t.shape[-2:] != (1, 1):
        raise ValueError(f"tau must be a number or shaped (..., 1, 1), got {tuple(t.shape)}")
    return t[..., 0, 0].broadcast_to(v.shape[:-2])


def fused_soft_threshold_plain(v: torch.Tensor, tau) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``solvers/sparse.py::soft_threshold``
    with τ broadcast over the last two axes."""
    return soft_threshold(v, _tau_per_matrix(tau, v)[..., None, None])


def fused_soft_threshold(v: torch.Tensor, tau) -> torch.Tensor:
    """``sign(Re v)·max(|Re v|−τ, 0) + j·sign(Im v)·max(|Im v|−τ, 0)``.

    v is (..., n, m) complex64; τ is a number or one τ per matrix, shaped
    (..., 1, 1).  Returns a new tensor.
    """
    if v.device.type == "cpu":
        return fused_soft_threshold_plain(v, tau)
    if v.device.type != "cuda":
        raise ValueError(f"fused_soft_threshold runs on CPU or CUDA tensors, got {v.device}")
    if v.dim() < 2:
        raise ValueError(f"v must be (..., n, m), got shape {tuple(v.shape)}")
    dev = v.device
    check_tensor("v", v, v.shape, torch.complex64, dev)
    t = _tau_per_matrix(tau, v).contiguous()
    out = torch.empty_like(v)
    mat_size = 0 if t.dim() == 0 else v.shape[-2] * v.shape[-1]
    total = v.numel()
    if total > 0:
        rc = _library().soft_threshold_launch(
            v.data_ptr(), t.data_ptr(), mat_size, out.data_ptr(), total,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        raise_on_launch_error("fused_soft_threshold", rc)
        fused_soft_threshold.launches += 1
    return out


fused_soft_threshold.launches = 0
