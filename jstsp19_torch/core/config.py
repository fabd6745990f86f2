"""Typed configuration and the dtype policy of the PyTorch port.

Counterpart of ``jstsp19_tpu/core/config.py``: one frozen dataclass per
script's parameter block (``plot_errorVSsnr.m:7-25``), MATLAB rounding, the
SNR → noise-variance map and complex64/float32 as the working types.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


def matlab_round(x: float) -> int:
    """MATLAB ``round``: nearest integer, ties AWAY from zero — unlike
    Python's banker's rounding (``round(2.5) == 2`` vs MATLAB 3).  The
    difference is load-bearing at shipped sweep points (e.g. errorVSnrf's
    Mr=16/T=5: T/(Nr/Mr)=2.5 -> T_hbf 12 vs 8)."""
    return int(math.floor(x + 0.5)) if x >= 0 else -int(math.floor(-x + 0.5))


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """Static description of the wideband hybrid-beamforming sounding system
    (``plot_errorVSsnr.m:7-25``); field meanings as in the JAX package.

    - ``Nt`` / ``Nr``: transmit / receive antennas (ULA).
    - ``Mr_e``: wide analog combiner outputs available to the switch network.
    - ``Mr``: RF chains observed per training instant.
    - ``Gr`` / ``Gt``: beamspace dictionary grid sizes.
    - ``L``: delay taps; ``n_clusters`` / ``n_rays``: scattering geometry.
    - ``T``: baseline training length (``T_prop = T·Nt`` for the proposed
      receiver, ``T_hbf = round(T/(Nr/Mr))·Nt`` for the conventional one).
    """

    Nt: int = 4
    Nr: int = 32
    Mr_e: int = 32
    Mr: int = 4
    Gr: int = 32
    Gt: int = 4
    L: int = 4
    n_clusters: int = 2
    n_rays: int = 3
    T: int = 35
    beamformer: str = "ZC"
    Imax: int = 100
    num_nonzero: int = 100  # `numOfnz = 5*20` in plot_errorVSsnr.m:20

    @property
    def Np(self) -> int:
        return self.n_clusters * self.n_rays

    @property
    def T_prop(self) -> int:
        return self.T * self.Nt

    @property
    def T_hbf(self) -> int:
        return matlab_round(self.T / (self.Nr / self.Mr)) * self.Nt

    @property
    def beamspace_shape(self) -> Tuple[int, int]:
        return (self.Gr, self.L * self.Gt)


def canonical_system() -> SystemConfig:
    """The canonical errorVSsnr configuration (``plot_errorVSsnr.m:8-25``)."""
    return SystemConfig()


def snr_db_to_noise_var(snr_db) -> torch.Tensor:
    """Noise variance ``10^(-SNR/10)`` (``plot_errorVSsnr.m:49``) as float32."""
    snr = torch.as_tensor(snr_db, dtype=torch.float64)
    return (10.0 ** (-snr / 10.0)).to(REAL_DTYPE)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the one named, else the card.
    Without a card and without a name it raises rather than run on the CPU;
    the CPU is taken only when asked for with ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device; pass device="cpu" to run on the CPU')
    return torch.device("cuda")


def use_full_fp32() -> None:
    """Keep every float32 product on the card in full float32: PyTorch lets
    cuDNN use TF32 by default, and either flag may have been flipped by the
    caller's process.  The port's CUDA entry points call this."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# Default dtype policy: complex64 everywhere, float32 for real parts.
COMPLEX_DTYPE = torch.complex64
REAL_DTYPE = torch.float32
