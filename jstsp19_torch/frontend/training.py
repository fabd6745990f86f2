"""Training-frame generation (counterpart of ``jstsp19_tpu/frontend/training.py``).

Antenna k transmits ``toeplitz(s_k)`` of a random symbol sequence and tap l
sees row l of it (``hbf.m:12-20``); only the first L rows are built.
"""
from __future__ import annotations

from typing import Tuple

import torch

from jstsp19_torch.core import prng
from jstsp19_torch.core.config import COMPLEX_DTYPE
from jstsp19_torch.frontend.modulation import qam4_mod


def _toeplitz_rows(s: torch.Tensor, L: int) -> torch.Tensor:
    """First L rows of the Hermitian Toeplitz matrix with first column ``s``:
    row l, column t is ``s[l-t]`` if l >= t else ``conj(s[t-l])``.
    s: (..., T) → (..., L, T)."""
    T = s.shape[-1]
    d = (
        torch.arange(L, device=s.device)[:, None]
        - torch.arange(T, device=s.device)[None, :]
    )
    gathered = s[..., d.abs()]  # (..., L, T)
    return torch.where(d >= 0, gathered, gathered.conj())


def qam4_training_frames(
    gen: torch.Generator, Nt: int, T: int, L: int, batch: Tuple[int, ...] = ()
) -> torch.Tensor:
    """4-QAM Toeplitz training, per-tap view: (..., L, Nt, T)
    (``plot_errorVSsnr.m:63-67`` + ``hbf.m:14-17``)."""
    s = qam4_mod(gen, tuple(batch) + (Nt, T))
    return _toeplitz_rows(s, L).transpose(-3, -2).to(COMPLEX_DTYPE)


def gaussian_training_frames(
    gen: torch.Generator, Nt: int, T: int, L: int, batch: Tuple[int, ...] = ()
) -> torch.Tensor:
    """Complex-Gaussian Toeplitz training, per-tap view: (..., L, Nt, T)
    (the ``wideband_hybBF_comm_system_training.m:19-22`` variant)."""
    s = prng.complex_normal(gen, tuple(batch) + (Nt, T))
    return _toeplitz_rows(s, L).transpose(-3, -2).to(COMPLEX_DTYPE)


def awgn(
    gen: torch.Generator, Nr: int, T: int, noise_var, batch: Tuple[int, ...] = ()
) -> torch.Tensor:
    """Circular white Gaussian noise CN(0, noise_var) of shape (..., Nr, T)."""
    return prng.complex_normal(gen, tuple(batch) + (Nr, T), var=noise_var)
