"""Frequency-selective (delay-tap) wideband mmWave MIMO channel generator.

Counterpart of ``jstsp19_tpu/channel/widemmwave.py``: the paper model by
default, and with ``quirks=True`` the reference implementation's actual
ensemble (cosh angle sampler, tap-1 steering reuse, per-cluster partial-sum
double count — see the JAX module's docstring).  A batch of realizations is
a leading dimension; the DFT dictionaries are shared by the batch.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from jstsp19_torch.core import prng
from jstsp19_torch.core.config import COMPLEX_DTYPE, REAL_DTYPE

# 90 GHz carrier, half-wavelength ULA spacing => k·d = pi
# (`wideband_mmwave_channel.m:44-49`).
KD = math.pi
DEFAULT_SIGMA_PHI_RAD = 50.0 * math.pi / 180.0


def ula_steering(phi: torch.Tensor, M: int) -> torch.Tensor:
    """Unnormalized ULA steering vector(s) ``exp(+j·k·d·sin(phi)·m)``.

    The sign is the reference's (``wideband_mmwave_channel.m:42-52``) and is
    observable under the asymmetric quirks-mode angle marginal — keep it.
    ``phi``: (...,) radians → (..., M) complex.
    """
    m = torch.arange(M, dtype=REAL_DTYPE, device=phi.device)
    phase = KD * torch.sin(-phi)[..., None] * m
    return torch.exp(-1j * phase).to(COMPLEX_DTYPE)


def truncated_laplacian(
    gen: torch.Generator, shape, sigma: float = DEFAULT_SIGMA_PHI_RAD
) -> torch.Tensor:
    """Angles from a Laplacian PAS truncated to [-pi, pi] (inverse CDF):
    ``phi = -(sigma/√2)·sign(u)·log(1 − 2|u|·(1 − e^{−√2·pi/sigma}))``,
    u ~ U(-1/2, 1/2)."""
    u = torch.rand(shape, generator=gen, dtype=REAL_DTYPE, device=gen.device) - 0.5
    b = sigma / math.sqrt(2.0)
    trunc = 1.0 - math.exp(-math.pi / b)
    return -b * torch.sign(u) * torch.log1p(-2.0 * u.abs() * trunc)


def quirk_laplacian(gen: torch.Generator, shape) -> torch.Tensor:
    """The reference's ``genLaplacianSamples`` verbatim
    (``wideband_mmwave_channel.m:56-62``): u ~ U(0,1), sigma_phi = 50,
    ``beta·(e^{−√2·pi/sigma_phi} − cosh(u))`` with
    ``beta = 1/(1 − e^{−√2·pi/sigma_phi})`` — confined to ≈[−7.39, −1.00]."""
    u = torch.rand(shape, generator=gen, dtype=REAL_DTYPE, device=gen.device)
    c = math.exp(-math.sqrt(2.0) * math.pi / 50.0)
    beta = 1.0 / (1.0 - c)
    return beta * (c - torch.cosh(u))


def dft_dictionary(M: int, G: int, device=None) -> torch.Tensor:
    """Beamspace DFT dictionary ``D[m,g] = exp(-j·2π·m·g/G)/sqrt(M)``
    (``wideband_mmwave_channel.m:9-10``)."""
    m = torch.arange(M, dtype=REAL_DTYPE, device=device)[:, None]
    g = torch.arange(G, dtype=REAL_DTYPE, device=device)[None, :]
    return (torch.exp(-2j * math.pi * m * g / G) / math.sqrt(M * 1.0)).to(COMPLEX_DTYPE)


class Channel(NamedTuple):
    """A batch of wideband channel realizations.

    H:    (..., L, Mr, Mt)   delay-tap antenna-space channel
    Zbar: (..., Gr, L*Gt)    beamspace channel, taps concatenated column-wise
    Ar:   (..., L, Np, Mr)   receive steering vectors per tap
    At:   (..., L, Np, Mt)   transmit steering vectors per tap
    Dr:   (Mr, Gr)           receive beamspace dictionary
    Dt:   (Mt, Gt)           transmit beamspace dictionary
    """

    H: torch.Tensor
    Zbar: torch.Tensor
    Ar: torch.Tensor
    At: torch.Tensor
    Dr: torch.Tensor
    Dt: torch.Tensor


def beamspace(H: torch.Tensor, Dr: torch.Tensor, Dt: torch.Tensor) -> torch.Tensor:
    """Per-tap ``Z_l = Drᴴ H_l Dt`` flattened to (..., Gr, L·Gt), taps
    concatenated along columns."""
    Z = torch.einsum("...mg,...lmn,...nh->...lgh", Dr.conj(), H, Dt)
    L, Gr, Gt = Z.shape[-3:]
    return Z.transpose(-3, -2).reshape(*Z.shape[:-3], Gr, L * Gt)


def wideband_mmwave_channel(
    gen: torch.Generator,
    L: int,
    Mr: int,
    Mt: int,
    n_clusters: int,
    n_rays: int,
    Gr: int,
    Gt: int,
    sigma_phi: float = DEFAULT_SIGMA_PHI_RAD,
    quirks: bool = False,
    batch: Tuple[int, ...] = (),
) -> Channel:
    """Generate ``batch`` wideband mmWave channel realizations on ``gen``'s
    device: per tap ``H_l = sqrt(1/Np)·Σ_p α_p a_r(φr_p) a_t(φt_p)ᴴ`` with
    α ~ CN(0,1) and truncated-Laplacian angles
    (``wideband_mmwave_channel.m:13-36``).

    ``quirks=True`` reproduces the reference implementation's ensemble
    (cosh sampler, tap-1 steering vectors for every tap, cluster c rays
    weighted ``n_clusters − c``); ``sigma_phi`` is then ignored, as the
    reference hard-codes it inside its sampler.
    """
    batch = tuple(batch)
    Np = n_clusters * n_rays
    device = gen.device
    alpha = prng.complex_normal(gen, batch + (L, Np))
    if quirks:
        phi_r = quirk_laplacian(gen, batch + (L, Np))
        phi_t = quirk_laplacian(gen, batch + (L, Np))
    else:
        phi_r = truncated_laplacian(gen, batch + (L, Np), sigma_phi)
        phi_t = truncated_laplacian(gen, batch + (L, Np), sigma_phi)

    Ar = ula_steering(phi_r, Mr)  # (..., L, Np, Mr)
    At = ula_steering(phi_t, Mt)  # (..., L, Np, Mt)
    if quirks:
        w = (n_clusters - torch.arange(Np, device=device) // n_rays).to(COMPLEX_DTYPE)
        H = torch.einsum(
            "...lp,...pm,...pn->...lmn", alpha * w, Ar[..., 0, :, :], At[..., 0, :, :].conj()
        ) / math.sqrt(Np * 1.0)
    else:
        H = torch.einsum("...lp,...lpm,...lpn->...lmn", alpha, Ar, At.conj()) / math.sqrt(
            Np * 1.0
        )

    Dr = dft_dictionary(Mr, Gr, device)
    Dt = dft_dictionary(Mt, Gt, device)
    Zbar = beamspace(H, Dr, Dt)
    return Channel(H=H, Zbar=Zbar, Ar=Ar, At=At, Dr=Dr, Dt=Dt)
