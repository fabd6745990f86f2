"""Fused tracked-SVT ADMM: the whole Imax-iteration solve in one CUDA launch.

Counterpart of ``jstsp19_tpu/kernels/admm_fused.py::fused_tracked_admm``
(the Pallas TPU kernel).  The CUDA kernel (``csrc/admm_fused.cu``) runs one
thread block per realization with the iteration loop inside the block and
streams the (N, M) and (K, M) operands through shared memory in column
tiles; its source note says what bounds it and what the design does about
that.  :func:`plan` picks the block's threads (and with them the tile
width) from the shapes and the layout's bytes, and says how many blocks
share an SM; on the card :func:`instance` names the kernel instance that
runs a shape and :func:`blocks_per_sm` reads how many of its blocks an SM
holds.
The plain version (:func:`fused_tracked_admm_plain`) is the port's
``proposed_admm(svt_method='tracked')`` over the batch.  The kernel takes
N ≤ M; ``solvers/admm_transposed.py`` hands it N > M problems on the
transpose.

:func:`fused_tracked_admm` takes the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises.  ``fused_tracked_admm.launches``
counts kernel launches, ``fused_tracked_admm.wide_launches`` those of them
in blocks of :data:`WIDE_THREADS` threads.  Under ``core.trace.recording()``
the wrapper's operand packing is a ``pack`` span and the launch a
``launch`` span (attribute ``threads``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from jstsp19_torch.core.config import use_full_fp32
from jstsp19_torch.core.trace import span
from jstsp19_torch.kernels.build import SMEM_LIMIT_BYTES, check_tensor as _check, current_stream, raise_on_launch_error
from jstsp19_torch.ops.jacobi import _round_robin_schedule


@functools.lru_cache(maxsize=None)
def _library(extra_flags: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernel's library; ``extra_flags`` builds a variant of its own
    (``("-DADMM_PHASES",)``: the per-phase clock stamps of
    ``tools/torch_admm_phases.py``)."""
    from jstsp19_torch.kernels.build import load

    lib = load("admm_fused", tuple(extra_flags))
    lib.fused_tracked_admm_launch.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p
    ]
    lib.fused_tracked_admm_launch.restype = ctypes.c_int
    lib.fused_tracked_admm_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.fused_tracked_admm_smem_bytes.restype = ctypes.c_longlong
    lib.fused_tracked_admm_registers.argtypes = [ctypes.c_int] * 4
    lib.fused_tracked_admm_registers.restype = ctypes.c_int
    lib.fused_tracked_admm_instance.argtypes = [ctypes.c_int] * 4
    lib.fused_tracked_admm_instance.restype = ctypes.c_char_p
    lib.fused_tracked_admm_blocks_per_sm.argtypes = [ctypes.c_int] * 5
    lib.fused_tracked_admm_blocks_per_sm.restype = ctypes.c_int
    lib.fused_tracked_admm_phase_names.restype = ctypes.c_char_p
    lib.fused_tracked_admm_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fused_tracked_admm_phase_cycles.restype = ctypes.c_int
    return lib


THREADS = 256  # threads of a block
WIDE_THREADS = 512  # threads of a block that runs alone on an SM (N = Gr = 32)
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


def tile_width(threads: int) -> int:
    """Columns of a column tile for a block of ``threads`` threads, each
    owning 4 rows of one column in each group of 32 (``tile_width`` in
    ``csrc/admm_fused.cu``)."""
    return threads // 8


def _layout_floats(N: int, Gr: int, K: int, threads: int = THREADS) -> int:
    """Floats of the kernel's shared-memory layout for a block of
    ``threads`` threads: ``Layout`` in ``csrc/admm_fused.cu``, term by term."""
    tw = tile_width(threads)
    NP = _round4(N)
    ldn = N + 1
    ldt = NP + 4 if (NP // 4) % 2 == 0 else NP
    ldb = ldw = tw + 1
    planes = [  # (plane size, complex buffers of that size)
        (N * ldn, 1), (N * Gr, 1), (Gr * Gr, 1), (K * K, 1), (Gr * K, 2), (K * NP, 1), (N * K, 1),
        (N * ldn, 1), (max(N * ldn, Gr * K, tw * ldt), 1), (max(N * ldn, N * NP, K * Gr), 1),
        (K * ldb, 1), (max(N * ldw, tw * ldt) if threads == WIDE_THREADS else N * ldw, 1),
    ]
    total = sum(2 * _round4(n) * count for n, count in planes)
    return total + _round4(3 * (N // 2)) + _round4(N) + _round4(2 * threads // 32)


def _two_fit(smem: int) -> bool:
    """Whether two blocks of ``smem`` bytes of shared memory fit one SM."""
    return 2 * (smem + BLOCK_RESERVED_BYTES) <= SM_SMEM_BYTES


def _threads(N: int, Gr: int, K: int) -> int:
    """The block's threads for these sizes: :data:`WIDE_THREADS` at N = Gr =
    32 where two blocks of :data:`THREADS` do not fit an SM's shared memory
    (one such block would leave the SM 8 warps) and a wide block's layout
    fits, else :data:`THREADS`."""
    if N == 32 and Gr == 32 and not _two_fit(4 * _layout_floats(N, Gr, K, THREADS)) and (
            4 * _layout_floats(N, Gr, K, WIDE_THREADS) <= SMEM_LIMIT_BYTES):
        return WIDE_THREADS
    return THREADS


def fits(N: int, M: int, Gr: int, K: int) -> bool:
    """Whether one block of the kernel holds the operands it keeps whole (the
    N x N, Gr x Gr, Gr x K and K x K ones) in shared memory: the shapes
    :func:`plan` accepts.  Pure Python, from the same layout."""
    return 4 * _layout_floats(N, Gr, K, _threads(N, Gr, K)) <= SMEM_LIMIT_BYTES


def plan(N: int, M: int, Gr: int, K: int) -> Plan:
    """Two blocks to an SM where their shared memory fits, else one (every
    256-thread instance's launch bounds leave registers for two; one may
    leave room for more, as :func:`blocks_per_sm` reads on the card).  At
    N = Gr = 32 a block that runs alone on an SM takes :data:`WIDE_THREADS`
    threads and 64-column tiles (:func:`_threads`).  Raises, with the bytes,
    for shapes whose operands kept whole (the N x N, Gr x K and K x K ones)
    are too large for a block (see :func:`fits`)."""
    threads = _threads(N, Gr, K)
    smem = 4 * _layout_floats(N, Gr, K, threads)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"shapes N={N} M={M} Gr={Gr} K={K} need {smem} B of shared memory, "
            f"more than the {SMEM_LIMIT_BYTES} B a block may use"
        )
    return Plan(tile_width(threads), -(-N // 32), threads, smem, 2 if _two_fit(smem) else 1)


def smem_bytes(N: int, Gr: int, K: int) -> int:
    """Dynamic shared memory one block of the kernel needs (from the library)."""
    return int(_library().fused_tracked_admm_smem_bytes(N, Gr, K, _threads(N, Gr, K)))


def instance(N: int, Gr: int, K: int) -> str:
    """The kernel instance that runs these sizes, as ``csrc/admm_fused.cu``
    names it: ``'fused_admm_kernel<NT, GT, RG, KT, MINB, TH>'``."""
    return f"fused_admm_kernel<{_library().fused_tracked_admm_instance(N, Gr, K, _threads(N, Gr, K)).decode()}>"


def blocks_per_sm(N: int, Gr: int, K: int, smem: int) -> int:
    """Blocks of that instance one SM of the current card holds at once with
    ``smem`` bytes of dynamic shared memory each (the CUDA occupancy
    calculator: registers, shared memory and launch bounds together)."""
    blocks = _library().fused_tracked_admm_blocks_per_sm(N, Gr, K, _threads(N, Gr, K), smem)
    if blocks < 0:
        raise RuntimeError(f"fused_tracked_admm_blocks_per_sm: CUDA error {-blocks}")
    return blocks


def fused_tracked_admm_plain(
    subY, Omega, A, B, tau_Y, tau_S, rho, Imax=100, support_rank=None,
    track_rounds=1, support_base=10, support_step=5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version: the batched tracked-SVT ADMM, with
    the per-op kernels off so that it stays plain PyTorch on the card."""
    from jstsp19_torch.solvers.admm import proposed_admm  # solvers.admm imports this module

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
    pl = plan(N, M, Gr, K)
    out = _launch(_library(), pl.smem_bytes, subY, Omega, A, B, tau_Y, tau_S, rho, Imax, support_rank,
                  track_rounds, support_base, support_step)
    if Bt > 0:
        fused_tracked_admm.launches += 1
        if pl.threads == WIDE_THREADS:
            fused_tracked_admm.wide_launches += 1
    return out


def _launch(
    lib, smem_bytes, subY, Omega, A, B, tau_Y, tau_S, rho, Imax, support_rank,
    track_rounds, support_base, support_step,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launches ``lib``'s kernel, in blocks of the threads :func:`plan` gives
    the shapes, with ``smem_bytes`` of dynamic shared memory (the plan's, or
    more to keep a second block off an SM) on checked inputs and returns
    ``(S, Y)``."""
    with span("pack"):
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
        threads = _threads(N, Gr, K)
        with span("launch", threads=threads):
            rc = lib.fused_tracked_admm_launch(
                planes.data_ptr(), A_p.data_ptr(), B_p.data_ptr(), AhA_t.data_ptr(), BBh.data_ptr(),
                rank_ptr, hp.data_ptr(), sched.data_ptr(), s.data_ptr(), y.data_ptr(), work.data_ptr(),
                Bt, N, M, Gr, K, Imax, track_rounds, support_base, support_step, smem_bytes, threads,
                current_stream(dev),
            )
        raise_on_launch_error("fused_tracked_admm", rc)
    return torch.complex(s[:, 0], s[:, 1]), torch.view_as_complex(y)


fused_tracked_admm.launches = 0
fused_tracked_admm.wide_launches = 0
