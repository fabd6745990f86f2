"""Build the port's CUDA kernels at first use, and check what their wrappers
hand them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface under ``kernels/build/``, named by a
hash of the source and the flags, and loaded with ``ctypes``.  Only the
sources in the checkout are used; nothing is fetched.  Build and load happen
inside the call that needs the kernel, never at import.  :func:`build_all`
starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Iterable, Tuple

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = ("admm_fused", "dict_correlation", "soft_threshold", "fwht")
SMEM_LIMIT_BYTES = 232_448  # dynamic shared memory one block may use on Hopper


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME/bin`` (PyTorch's lookup)."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path(name: str, extra_flags: Tuple[str, ...] = ()) -> pathlib.Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source and
    the flags: a build with ``extra_flags`` (say, ``-DADMM_PHASES``) gets a
    name of its own beside the normal one."""
    src = CSRC / f"{name}.cu"
    flags = " ".join(NVCC_FLAGS + tuple(extra_flags))
    digest = hashlib.sha256(src.read_bytes() + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Iterable[str], extra_flags: Tuple[str, ...] = ()) -> Dict[str, float]:
    """Compile each ``csrc/<name>.cu`` whose library (same hash) is missing,
    one ``nvcc`` per source, all started together, with ``NVCC_FLAGS`` and
    ``extra_flags``.  Returns the seconds from the common start until each
    build ended (0.0 where the library existed).  The compiler's report
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside each
    library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    running = {}
    seconds = {}
    for name in names:
        out = library_path(name, extra_flags)
        if out.exists():
            seconds[name] = 0.0
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running[name] = (proc, tmp, out)
    failed = []
    while running:
        for name, (proc, tmp, out) in list(running.items()):
            if proc.poll() is None:
                continue
            seconds[name] = time.time() - t0
            stdout, stderr = proc.communicate()
            out.with_suffix(".log").write_text(stdout + stderr)
            del running[name]
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"nvcc failed for {name}.cu:\n{stderr}")
            else:
                os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        time.sleep(0.05)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def build(name: str, extra_flags: Tuple[str, ...] = ()) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists."""
    build_all([name], extra_flags)
    return library_path(name, extra_flags)


@functools.lru_cache(maxsize=None)
def load(name: str, extra_flags: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>``; one handle per process and
    set of flags."""
    return ctypes.CDLL(str(build(name, extra_flags)))


def check_tensor(name: str, x: torch.Tensor, shape, dtype, device) -> None:
    """Raise unless ``x`` has the device, dtype and shape a kernel takes and
    is contiguous."""
    if x.device != device:
        raise ValueError(f"{name} is on device {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def current_stream(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``, as
    Triton's launcher reads it: no ``torch.cuda.Stream`` object is built."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def raise_on_launch_error(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
