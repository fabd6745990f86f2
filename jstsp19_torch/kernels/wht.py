"""Orthonormal fast Walsh–Hadamard transform along the last axis in CUDA.

Counterpart of ``jstsp19_tpu/kernels/wht.py::pallas_fwht`` (the Pallas TPU
kernel) and of the XLA butterflies of ``jstsp19_tpu/ops/fourier.py``.  The
CUDA kernel (``csrc/fwht.cu``) runs the natural-order radix-2 butterflies,
divides by √n and folds the sequency permutation into its loads or stores;
float32 rows, or complex64 rows read as interleaved pairs.  :func:`plan_fwht`
picks its path by the bytes of a row (one block, a thread-block cluster, or
a two-pass split) and the wrapper hands the plan to the library; the
source note says what bounds the kernel and what each path does about it.
Unlike ``pallas_fwht``, which casts to float32, a complex input keeps its
imaginary part, as the JAX package's ``fwht`` does.

The plain versions (:func:`fwht_plain`, :func:`ifwht_plain`) are
``ops/fourier.py::fwht``/``ifwht`` of the JAX package in torch, with the
same arithmetic as the kernel, so the two agree bit for bit.
:func:`fwht_kernel` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  ``fwht_kernel.launches`` counts
kernel launches.  :func:`kernel_takes` says which operands the kernel
takes, so that a caller can route the others to the plain version before
any launch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from jstsp19_torch.kernels.build import current_stream, raise_on_launch_error

_MODES = {("natural", False): 0, ("natural", True): 0, ("sequency", False): 1, ("sequency", True): 2}


@functools.lru_cache(maxsize=None)
def _library(extra_flags: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernel's library; ``extra_flags`` builds a variant of its own
    (``("-DFWHT_PHASES",)``: the per-phase clock stamps of
    ``tools/torch_fwht_phases.py``; ``("-DFWHT_CLUSTER=4",)``: clusters of
    4 blocks, which the tool compares with CLUSTER)."""
    from jstsp19_torch.kernels.build import load

    lib = load("fwht", tuple(extra_flags))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.fwht_launch.argtypes = [vp, vp, vp, ll, i, i, i, ctypes.c_float, i, i, i, vp]
    lib.fwht_launch.restype = i
    lib.fwht_cluster_capacity.argtypes = [i, i, i]
    lib.fwht_cluster_capacity.restype = i
    lib.fwht_phase_names.restype = ctypes.c_char_p
    lib.fwht_phase_cycles.argtypes = [vp, i]
    lib.fwht_phase_cycles.restype = i
    return lib


ROW_BYTES = 128 * 1024  # one block holds a row up to this size (kRowBytes in csrc/fwht.cu)
CLUSTER = 8  # blocks a cluster on the cluster path (kClusterSize)
MAX_THREADS = 512  # threads of a block (kMaxThreads)
REG_BYTES = 128  # entries a thread holds in registers: 32 float32 or 16 complex64 (kRegBytes)
MAX_LOG2N = 24
PATHS = {"row": 0, "cluster": 1, "split": 2}  # the path codes fwht_launch takes
CLUSTER_UNPLACEABLE = -1  # fwht_launch's code for a cluster the card cannot place


class FwhtPlan(NamedTuple):
    """How the kernel transforms one row: the path ('row': one block holds
    the row; 'cluster': a thread-block cluster holds it, 1/cluster a block;
    'split': two passes through device memory), the cluster size, the
    threads of a block and its dynamic shared memory in bytes."""
    path: str
    cluster: int
    threads: int
    smem_bytes: int


def _log2(n: int) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"FWHT length must be a power of two, got {n}")
    return n.bit_length() - 1


def plan_fwht(n: int, elem_bytes: int) -> FwhtPlan:
    """The plan of a row of n entries of ``elem_bytes`` (4: float32, 8:
    complex64).  Up to ROW_BYTES a row, one block holds it; up to
    CLUSTER x ROW_BYTES, a cluster of CLUSTER blocks, each holding 1/CLUSTER
    of the row; above, the two-pass split.  A row-path thread holds
    REG_BYTES of entries, so a block has (its bytes) / REG_BYTES threads, at
    least one warp and at most MAX_THREADS; a cluster-path thread takes two
    such units (the kernel's cross-block tiles need exactly (part bytes) /
    256 threads).  CLUSTER = 8, the largest portable size, is the one size
    whose parts fit a block for every row up to 1 MB, and it spreads the
    GAMP slice's (32, 65536) float32 over all the SMs: 256 blocks of 32 KB
    and 128 threads.  (On an H100, clusters of 2 blocks of 128 KB ran as
    fast there, and of 4 slower: PERF.md, section 6.)  Pure Python: the
    wrapper hands the plan to the library."""
    log2n = _log2(n)
    if elem_bytes not in (4, 8):
        raise ValueError(f"elem_bytes is 4 (float32) or 8 (complex64), got {elem_bytes}")
    if not 1 <= log2n <= MAX_LOG2N:
        raise ValueError(f"fwht_kernel supports n from 2 to 2^{MAX_LOG2N}, got n = {n}")
    row = n * elem_bytes
    if row > CLUSTER * ROW_BYTES:
        return FwhtPlan("split", 1, MAX_THREADS, 0)
    cluster = 1 if row <= ROW_BYTES else CLUSTER
    block_bytes = row // cluster
    units = block_bytes // REG_BYTES if cluster == 1 else block_bytes // (2 * REG_BYTES)
    threads = min(MAX_THREADS, max(32, units))
    return FwhtPlan("row" if cluster == 1 else "cluster", cluster, threads, block_bytes)


def kernel_takes(dtype: torch.dtype, n: int) -> bool:
    """Whether :func:`fwht_kernel` takes rows of n entries of this dtype:
    float32 or complex64, n a power of two from 2 to 2^MAX_LOG2N.  The
    callers' route (``ops/fourier.py``) is decided by this, before any
    launch; everything else takes the plain version.  Pure Python."""
    return dtype in (torch.float32, torch.complex64) and 2 <= n <= 1 << MAX_LOG2N and not n & (n - 1)


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
    axis of x, (..., n) float32 or complex64 with n a power of two, on the
    plan of :func:`plan_fwht`.  Returns a new tensor."""
    if x.device.type == "cpu":
        return (ifwht_plain if inverse else fwht_plain)(x, ordering)
    if x.device.type != "cuda":
        raise ValueError(f"fwht_kernel runs on CPU or CUDA tensors, got {x.device}")
    _check_ordering(ordering)
    if x.dtype not in (torch.float32, torch.complex64):
        raise ValueError(f"fwht_kernel takes float32 or complex64, got {x.dtype}")
    out = _launch(_library(), x, ordering, inverse, plan_fwht(x.shape[-1], x.element_size()))
    if out.numel():
        fwht_kernel.launches += 1
    return out


def _launch(lib, x: torch.Tensor, ordering: str, inverse: bool, plan: FwhtPlan) -> torch.Tensor:
    """Launches ``lib``'s kernel on checked x with ``plan`` (the tools pass
    the plans of builds with another cluster size); returns the transform."""
    n = x.shape[-1]
    log2n = _log2(n)
    xc = x.resolve_conj().contiguous()  # the kernel reads memory, which a lazy conjugate leaves unconjugated
    if xc.data_ptr() % 16:  # the kernel moves rows in 16-byte vectors
        xc = xc.clone()
    out = torch.empty_like(xc)
    rows = xc.numel() // n
    if rows == 0:
        return out
    scratch = torch.empty_like(xc) if plan.path == "split" else out
    rc = lib.fwht_launch(
        xc.data_ptr(), out.data_ptr(), scratch.data_ptr(), rows, log2n, int(xc.is_complex()),
        _MODES[(ordering, inverse)], math.sqrt(n), PATHS[plan.path], plan.threads, plan.smem_bytes,
        current_stream(x.device),
    )
    if rc == CLUSTER_UNPLACEABLE:
        raise RuntimeError(f"fwht_kernel: the card cannot place a cluster of {plan.cluster} blocks "
                           f"with {plan.smem_bytes} B of shared memory each")
    raise_on_launch_error("fwht_kernel", rc)
    return out


fwht_kernel.launches = 0
