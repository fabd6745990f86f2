"""Fused tracked-SVT ADMM: the whole Imax-iteration solve in one CUDA launch.

Counterpart of ``jstsp19_tpu/kernels/admm_fused.py::fused_tracked_admm``
(the Pallas TPU kernel).  The CUDA kernel (``csrc/admm_fused.cu``) runs one
thread block per realization with the iteration loop inside the block and
streams the (N, M) and (K, M) operands through shared memory in column
tiles; its source note says what bounds it and what the design does about
that.  :func:`plan` picks the tile width and says how many blocks share an
SM.  The plain version (:func:`fused_tracked_admm_plain`) is the port's
``proposed_admm(svt_method='tracked')`` over the batch.

:func:`fused_tracked_admm` takes the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises.  ``fused_tracked_admm.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from jstsp19_torch.core.config import use_full_fp32
from jstsp19_torch.kernels.build import SMEM_LIMIT_BYTES, check_tensor as _check, current_stream, raise_on_launch_error
from jstsp19_torch.ops.jacobi import _round_robin_schedule
from jstsp19_torch.solvers.admm import proposed_admm


@functools.lru_cache(maxsize=None)
def _library(extra_flags: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernel's library; ``extra_flags`` builds a variant of its own
    (``("-DADMM_PHASES",)``: the per-phase clock stamps of
    ``tools/torch_admm_phases.py``)."""
    from jstsp19_torch.kernels.build import load

    lib = load("admm_fused", tuple(extra_flags))
    lib.fused_tracked_admm_launch.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p
    ]
    lib.fused_tracked_admm_launch.restype = ctypes.c_int
    lib.fused_tracked_admm_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.fused_tracked_admm_smem_bytes.restype = ctypes.c_longlong
    lib.fused_tracked_admm_registers.argtypes = [ctypes.c_int] * 2
    lib.fused_tracked_admm_registers.restype = ctypes.c_int
    lib.fused_tracked_admm_phase_names.restype = ctypes.c_char_p
    lib.fused_tracked_admm_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fused_tracked_admm_phase_cycles.restype = ctypes.c_int
    return lib


THREADS = 256  # threads of a block (kThreads in csrc/admm_fused.cu)
TILE_WIDTH = 32  # columns of a tile: one a lane (kTW)
SM_SMEM_BYTES = 233_472  # shared memory of one H100 SM
BLOCK_RESERVED_BYTES = 1_024  # shared memory the card reserves for each resident block


class Plan(NamedTuple):
    """How the kernel runs one realization: column tile width, groups of 32
    rows, threads, dynamic shared memory of a block, and how many blocks
    share an SM."""
    tw: int
    row_groups: int
    threads: int
    smem_bytes: int
    blocks_per_sm: int


def _round4(n: int) -> int:
    return (n + 3) & ~3


def _layout_floats(N: int, Gr: int, K: int) -> int:
    """Floats of the kernel's shared-memory layout: ``Layout`` in
    ``csrc/admm_fused.cu``, term by term."""
    NP = _round4(N)
    ldn = N + 1
    ldt = NP + 4 if (NP // 4) % 2 == 0 else NP
    ldb = ldw = TILE_WIDTH + 1
    planes = [  # (plane size, complex buffers of that size)
        (N * ldn, 1), (N * Gr, 1), (Gr * Gr, 1), (K * K, 1), (Gr * K, 2), (K * NP, 1), (N * K, 1),
        (N * ldn, 1), (max(N * ldn, Gr * K, TILE_WIDTH * ldt), 1), (max(N * ldn, N * NP, K * Gr), 1),
        (K * ldb, 1), (N * ldw, 1),
    ]
    total = sum(2 * _round4(n) * count for n, count in planes)
    return total + _round4(3 * (N // 2)) + _round4(N) + _round4(2 * THREADS // 32)


def fits(N: int, M: int, Gr: int, K: int) -> bool:
    """Whether one block of the kernel holds the operands it keeps whole (the
    N x N, Gr x Gr, Gr x K and K x K ones) in shared memory: the shapes
    :func:`plan` accepts.  Pure Python, from the same layout."""
    return 4 * _layout_floats(N, Gr, K) <= SMEM_LIMIT_BYTES


def plan(N: int, M: int, Gr: int, K: int) -> Plan:
    """Two blocks to an SM where their shared memory fits, else one.  Raises,
    with the bytes, for shapes whose operands kept whole (the N x N, Gr x K
    and K x K ones) are too large for a block (see :func:`fits`)."""
    smem = 4 * _layout_floats(N, Gr, K)
    if not fits(N, M, Gr, K):
        raise ValueError(
            f"shapes N={N} M={M} Gr={Gr} K={K} need {smem} B of shared memory, "
            f"more than the {SMEM_LIMIT_BYTES} B a block may use"
        )
    blocks = 2 if 2 * (smem + BLOCK_RESERVED_BYTES) <= SM_SMEM_BYTES else 1
    return Plan(TILE_WIDTH, -(-N // 32), THREADS, smem, blocks)


def smem_bytes(N: int, Gr: int, K: int) -> int:
    """Dynamic shared memory one block of the kernel needs (from the library)."""
    return int(_library().fused_tracked_admm_smem_bytes(N, Gr, K))


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
    enables the Algorithm-3 schedule.  Needs an even N ≤ M; on the card,
    operands that :func:`plan` fits.
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
    smem = plan(N, M, Gr, K).smem_bytes
    out = _launch(_library(), smem, subY, Omega, A, B, tau_Y, tau_S, rho, Imax, support_rank,
                  track_rounds, support_base, support_step)
    if Bt > 0:
        fused_tracked_admm.launches += 1
    return out


def _launch(
    lib, smem_bytes, subY, Omega, A, B, tau_Y, tau_S, rho, Imax, support_rank,
    track_rounds, support_base, support_step,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launches ``lib``'s kernel with ``smem_bytes`` of dynamic shared memory
    (the plan's, or more to keep a second block off an SM) on checked
    inputs and returns ``(S, Y)``."""
    Bt, N, M = subY.shape
    Gr, K = A.shape[-1], B.shape[-2]
    dev = subY.device
    use_full_fp32()
    # products outside the solve, as the JAX wrapper computes them; the
    # small complex operands go in as (re, im) plane pairs, the (N, M) ones
    # as a record per element
    hp = torch.stack([rho, tau_Y / rho, tau_S / rho, 1.0 / rho], dim=1).contiguous()
    dinv = 1.0 / (Omega + 2.0 * rho[:, None, None])
    planes = torch.stack([subY.real, subY.imag, dinv, torch.zeros_like(dinv)], dim=-1).contiguous()
    A_p = torch.view_as_real(A).movedim(-1, 1).contiguous()
    B_p = torch.view_as_real(B).movedim(-1, 1).contiguous()
    AhA_t = torch.view_as_real((A.mH @ A).transpose(-2, -1)).movedim(-1, 1).contiguous()  # [j][q] = (A^H A)[q][j]
    BBh = torch.view_as_real(B @ B.mH).movedim(-1, 1).contiguous()
    sched = torch.as_tensor(_round_robin_schedule(N), dtype=torch.int32, device=dev).contiguous()
    s = torch.empty((Bt, 2, Gr, K), dtype=torch.float32, device=dev)
    y = torch.zeros((Bt, N, M, 2), dtype=torch.float32, device=dev)
    work = torch.zeros(Bt * N * M * 6, dtype=torch.float32, device=dev)  # (X, V1) records, then V2
    rank_ptr = support_rank.data_ptr() if support_rank is not None else None
    if Bt > 0:
        rc = lib.fused_tracked_admm_launch(
            planes.data_ptr(), A_p.data_ptr(), B_p.data_ptr(), AhA_t.data_ptr(), BBh.data_ptr(),
            rank_ptr, hp.data_ptr(), sched.data_ptr(), s.data_ptr(), y.data_ptr(), work.data_ptr(),
            Bt, N, M, Gr, K, Imax, track_rounds, support_base, support_step, smem_bytes,
            current_stream(dev),
        )
        raise_on_launch_error("fused_tracked_admm", rc)
    return torch.complex(s[:, 0], s[:, 1]), torch.view_as_complex(y)


fused_tracked_admm.launches = 0
