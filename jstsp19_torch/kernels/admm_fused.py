"""Fused tracked-SVT ADMM: the whole Imax-iteration solve in one CUDA launch.

Counterpart of ``jstsp19_tpu/kernels/admm_fused.py::fused_tracked_admm``
(the Pallas TPU kernel).  The CUDA kernel (``csrc/admm_fused.cu``) runs one
thread block per realization with the iteration loop inside the block; its
source note says what bounds it and what the design does about that.  The
plain version (:func:`fused_tracked_admm_plain`) is the port's
``proposed_admm(svt_method='tracked')`` over the batch.

:func:`fused_tracked_admm` takes the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises.  ``fused_tracked_admm.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from jstsp19_torch.core.config import use_full_fp32
from jstsp19_torch.kernels.build import SMEM_LIMIT_BYTES, check_tensor as _check, raise_on_launch_error
from jstsp19_torch.ops.jacobi import _round_robin_schedule
from jstsp19_torch.solvers.admm import proposed_admm


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from jstsp19_torch.kernels.build import load

    lib = load("admm_fused")
    lib.fused_tracked_admm_launch.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p
    ]
    lib.fused_tracked_admm_launch.restype = ctypes.c_int
    lib.fused_tracked_admm_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.fused_tracked_admm_smem_bytes.restype = ctypes.c_longlong
    return lib


def smem_bytes(N: int, M: int, Gr: int, K: int) -> int:
    """Dynamic shared memory one block of the kernel needs (from the library)."""
    return int(_library().fused_tracked_admm_smem_bytes(N, M, Gr, K))


def fused_tracked_admm_plain(
    subY, Omega, A, B, tau_Y, tau_S, rho, Imax=100, support_rank=None,
    track_rounds=1, support_base=10, support_step=5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version: the batched tracked-SVT ADMM, with
    the per-op kernels off so that it stays plain PyTorch on the card."""
    res = proposed_admm(
        subY, Omega, A, B, Imax, tau_Y, tau_S, rho, support_rank=support_rank,
        support_base=support_base, support_step=support_step,
        svt_method="tracked", track_rounds=track_rounds, use_kernels=False,
    )
    return res.S, res.Y


def fused_tracked_admm(
    subY: torch.Tensor,       # (B, N, M) complex64
    Omega: torch.Tensor,      # (B, N, M) float32
    A: torch.Tensor,          # (B, N, Gr) complex64
    B: torch.Tensor,          # (B, K, M) complex64
    tau_Y: torch.Tensor,      # (B,)
    tau_S: torch.Tensor,      # (B,)
    rho: torch.Tensor,        # (B,)
    Imax: int = 100,
    support_rank: Optional[torch.Tensor] = None,  # (B, Gr, K) int32
    track_rounds: int = 1,
    support_base: int = 10,
    support_step: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched fused tracked-SVT ADMM.

    Returns ``(S, Y)``: the (B, Gr, K) post-threshold beamspace estimate and
    the (B, N, M) completed low-rank observation, matching
    ``proposed_admm(svt_method='tracked')`` over the batch.  ``support_rank``
    enables the Algorithm-3 schedule.  Needs an even N ≤ M.
    """
    Bt, N, M = subY.shape
    Gr = A.shape[-1]
    K = B.shape[-2]
    if N % 2 or N > M:
        raise ValueError("fused tracked ADMM needs even N <= M")
    if subY.device.type == "cpu":
        return fused_tracked_admm_plain(
            subY, Omega, A, B, tau_Y, tau_S, rho, Imax, support_rank,
            track_rounds, support_base, support_step,
        )
    if subY.device.type != "cuda":
        raise ValueError(f"fused_tracked_admm runs on CPU or CUDA tensors, got {subY.device}")

    dev = subY.device
    _check("subY", subY, (Bt, N, M), torch.complex64, dev)
    _check("Omega", Omega, (Bt, N, M), torch.float32, dev)
    _check("A", A, (Bt, N, Gr), torch.complex64, dev)
    _check("B", B, (Bt, K, M), torch.complex64, dev)
    for name, x in (("tau_Y", tau_Y), ("tau_S", tau_S), ("rho", rho)):
        _check(name, x, (Bt,), torch.float32, dev)
    if support_rank is not None:
        _check("support_rank", support_rank, (Bt, Gr, K), torch.int32, dev)
    if Imax < 0 or track_rounds < 0:
        raise ValueError("Imax and track_rounds must be non-negative")
    need = smem_bytes(N, M, Gr, K)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"shapes N={N} M={M} Gr={Gr} K={K} need {need} B of shared memory, "
            f"more than the {SMEM_LIMIT_BYTES} B a block may use"
        )
    use_full_fp32()

    # products outside the solve, as the JAX wrapper computes them
    hp = torch.stack([rho, tau_Y / rho, tau_S / rho, 1.0 / rho], dim=1).contiguous()
    dinv = (1.0 / (Omega + 2.0 * rho[:, None, None])).contiguous()
    AhA = A.mH @ A
    BBh = B @ B.mH
    sched = torch.as_tensor(_round_robin_schedule(N), device=dev).contiguous()
    planes = [
        subY.real.contiguous(), subY.imag.contiguous(), dinv,
        A.real.contiguous(), A.imag.contiguous(), B.real.contiguous(), B.imag.contiguous(),
        AhA.real.contiguous(), AhA.imag.contiguous(), BBh.real.contiguous(), BBh.imag.contiguous(),
    ]
    s_re = torch.empty((Bt, Gr, K), dtype=torch.float32, device=dev)
    s_im = torch.empty_like(s_re)
    y_re = torch.empty((Bt, N, M), dtype=torch.float32, device=dev)
    y_im = torch.empty_like(y_re)
    work = torch.empty((Bt, 8, N, M), dtype=torch.float32, device=dev)
    rank_ptr = support_rank.data_ptr() if support_rank is not None else None

    if Bt > 0:
        rc = _library().fused_tracked_admm_launch(
            *(x.data_ptr() for x in planes), rank_ptr, hp.data_ptr(), sched.data_ptr(),
            s_re.data_ptr(), s_im.data_ptr(), y_re.data_ptr(), y_im.data_ptr(), work.data_ptr(),
            Bt, N, M, Gr, K, Imax, track_rounds, support_base, support_step,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        raise_on_launch_error("fused_tracked_admm", rc)
        fused_tracked_admm.launches += 1
    return torch.complex(s_re, s_im), torch.complex(y_re, y_im)


fused_tracked_admm.launches = 0
