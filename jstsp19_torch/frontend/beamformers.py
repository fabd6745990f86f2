"""Analog combiner factory (counterpart of ``jstsp19_tpu/frontend/beamformers.py``).

The combiner families of ``createBeamformer.m:4-31`` as closed-form phase
matrices; each returns an (N, N) complex matrix with unit-norm columns.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from jstsp19_torch.core.config import COMPLEX_DTYPE, REAL_DTYPE

_RAND_PS_GRID = 32  # `Gr = 32` inside the 'rand_ps' branch, createBeamformer.m:10
_ZC_ROOT = 11  # Zadoff-Chu root, createBeamformer.m:16


def _phase_matrix(omega_cols: torch.Tensor, N: int) -> torch.Tensor:
    """``B[n, c] = exp(-j·n·omega_cols[c]) / sqrt(N)``."""
    n = torch.arange(N, dtype=REAL_DTYPE, device=omega_cols.device)[:, None]
    return (torch.exp(-1j * n * omega_cols[None, :]) / math.sqrt(N * 1.0)).to(COMPLEX_DTYPE)


def _quantized(N: int, bits: int, device) -> torch.Tensor:
    """Phase-quantized combiner; each of the 2^bits levels repeats
    ceil(N/2^bits) times in a row, as MATLAB's ``vec(kron(ones(K,1), A))``
    does (``createBeamformer.m:18-30``)."""
    levels = 2**bits
    K = -(-N // levels)
    a = torch.arange(levels, dtype=REAL_DTYPE, device=device).repeat_interleave(K)[:N]
    return _phase_matrix(2.0 * math.pi / levels * a, N)


def create_beamformer(
    N: int, kind: str = "ZC", gen: Optional[torch.Generator] = None, device=None
) -> torch.Tensor:
    """Build an (N, N) analog combiner of the given family.

    kinds (``createBeamformer.m``): 'fft' and 'ps' (DFT phases), 'ZC'
    (Zadoff-Chu bank, root 11), 'quantized_4' / 'quantized' (4 / 6-bit
    phase grids), and the random 'rand' (QPSK entries) and 'rand_ps'
    (32-level phase shifters), which draw from ``gen`` on its device.
    """
    if kind in ("rand", "rand_ps"):
        if gen is None:
            raise ValueError(f"{kind!r} beamformer needs a generator")
        device = gen.device
    if kind in ("fft", "ps"):
        n = torch.arange(N, dtype=REAL_DTYPE, device=device)
        return _phase_matrix(2.0 * math.pi * n / N, N)
    if kind == "ZC":
        # B[n,c] = exp(-j·R·n·pi·(c+1)/N)/sqrt(N)  (createBeamformer.m:15-17)
        c = torch.arange(1, N + 1, dtype=REAL_DTYPE, device=device)
        return _phase_matrix(_ZC_ROOT * math.pi * c / N, N)
    if kind == "quantized_4":
        return _quantized(N, 4, device)
    if kind == "quantized":
        return _quantized(N, 6, device)
    if kind == "rand":
        alphabet = torch.tensor([1.0, -1.0, 1.0j, -1.0j], dtype=COMPLEX_DTYPE, device=device)
        idx = torch.randint(0, 4, (N, N), generator=gen, device=device)
        return alphabet[idx] / math.sqrt(N * 1.0)
    if kind == "rand_ps":
        g = torch.randint(1, _RAND_PS_GRID + 1, (N,), generator=gen, device=device)
        return _phase_matrix(2.0 * math.pi * g.to(REAL_DTYPE) / _RAND_PS_GRID, N)
    raise ValueError(f"unknown beamformer kind {kind!r}")
