"""The host library: the orthonormal FWHT and the sparse-output product
Aᴴ·X in C++, bound with ctypes (counterpart of
``jstsp19_tpu/utils/native.py``).

The reference ships two first-party MEX kernels (``main/fastWHtrans.cpp``,
``BiGAMP/sparseMult2.c``); their counterparts are the C++ sources in
``csrc/`` beside this module, with a C ABI.  They serve as a float64 oracle
that uses neither torch nor a card: numpy in, numpy out, float64 and
complex128.  ``chip_smoke.py`` holds the FWHT kernel against
:func:`native_fwht`.

The library is built at first use, never at import: ``g++ -O3 -shared
-fPIC``, with ``-march=native`` tried first, into ``kernels/build/``
(git-ignored), named by a hash of the sources, the compiler, the flags and
the host's target, and written through a temporary file and a rename, so
that processes building at once never load half a file.  Without a build
(no compiler, no sources), :func:`native_available` is False and both
functions raise ``RuntimeError``.

The outputs are those of the JAX package's bindings, edge cases included:
a row whose length is not a power of two comes back unchanged (neither
binding pads, where the reference MEX pads to the next power of two), a
row of one entry is its own transform, the output is float64 whatever
the input, and a (row, col) pair outside Z gives 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import subprocess
import tempfile
from typing import Optional

import numpy as np

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "kernels" / "build"
SOURCES = ("fwht.cpp", "sparse_mult.cpp")
CXX = "g++"
FLAGS = ("-O3", "-shared", "-fPIC")
TUNED = ("-march=native",)  # tried first; some hosts' toolchains reject it


def _target(flags) -> str:
    """What ``-march=native`` means on this host (the compiler's resolved
    ``-march``), so that a library tuned for one host is never loaded on
    another from a shared checkout; '' without it."""
    if "-march=native" not in flags:
        return ""
    out = subprocess.run([CXX, "-march=native", "-Q", "--help=target"], capture_output=True, text=True,
                         timeout=60).stdout
    found = re.search(r"^\s*-march=\s*(\S+)", out, re.M)
    return found.group(1) if found else "unknown"


def _build() -> Optional[pathlib.Path]:
    """The library's path after building it if needed, or None where it
    cannot be built."""
    sources = [CSRC / name for name in SOURCES]
    if not all(s.exists() for s in sources):
        return None
    for flags in (FLAGS + TUNED, FLAGS):
        try:
            key = b"".join(s.read_bytes() for s in sources) + " ".join((CXX, *flags, _target(flags))).encode()
            out = BUILD_DIR / f"libjstsp19_native-{hashlib.sha256(key).hexdigest()[:16]}.so"
            if out.exists():
                return out
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run([CXX, *flags, "-o", tmp, *map(str, sources)], check=True, capture_output=True,
                               timeout=120)
                os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            return out
        except (subprocess.SubprocessError, OSError):
            continue
    return None


@functools.lru_cache(maxsize=None)
def _lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call of the process; None
    where it cannot be built (tried once)."""
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    pd, pi, i64 = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64), ctypes.c_int64
    lib.fwht_sequency.argtypes = [pd, pd, i64]
    lib.fwht_natural.argtypes = [pd, i64]
    lib.sparse_conj_mult.argtypes = [pd, pd, pi, pi, pd, i64, i64, i64, i64]
    return lib


def native_available() -> bool:
    return _lib() is not None


def native_fwht(x: np.ndarray, ordering: str = "sequency") -> np.ndarray:
    """Orthonormal FWHT along the last axis (power-of-two length), float64."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native library unavailable (g++ build failed)")
    x = np.ascontiguousarray(x, dtype=np.float64)
    n = x.shape[-1]
    out = x.reshape(-1, n).copy()
    scratch = np.empty(n, np.float64)
    pd = ctypes.POINTER(ctypes.c_double)
    for row in out:
        if ordering == "sequency":
            lib.fwht_sequency(row.ctypes.data_as(pd), scratch.ctypes.data_as(pd), n)
        elif ordering == "natural":
            lib.fwht_natural(row.ctypes.data_as(pd), n)
        else:
            raise ValueError(f"unknown ordering {ordering!r}")
    return out.reshape(x.shape)


def native_sparse_conj_mult(A: np.ndarray, X: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Selected entries ``Z[rows[k], cols[k]]`` of ``Z = Aᴴ·X``, complex128."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native library unavailable (g++ build failed)")
    A = np.asfortranarray(A, dtype=np.complex128)
    X = np.asfortranarray(X, dtype=np.complex128)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    m = rows.shape[0]
    out = np.empty(m, np.complex128)
    n, r = A.shape
    c = X.shape[1]
    pd, pi = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)
    lib.sparse_conj_mult(A.ctypes.data_as(pd), X.ctypes.data_as(pd), rows.ctypes.data_as(pi),
                         cols.ctypes.data_as(pi), out.ctypes.data_as(pd), n, r, c, m)
    return out
