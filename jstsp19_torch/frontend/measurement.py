"""Hybrid-beamforming measurement models
(counterpart of ``jstsp19_tpu/frontend/measurement.py``).

Conventional HBF (``hbf.m``) keeps the first Lr combiner outputs; the
proposed HBF (``proposed_hbf.m``) observes a random Lr-subset of Lr_e
outputs per training instant, expressed as a binary mask Omega; the
communication-system wrapper (``wideband_hybBF_comm_system_training.m``)
does the same with Gaussian training over all Nr outputs.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Tuple

import torch

from jstsp19_torch.core import prng
from jstsp19_torch.core.config import REAL_DTYPE, matlab_round
from jstsp19_torch.frontend.beamformers import create_beamformer
from jstsp19_torch.frontend.training import awgn, gaussian_training_frames


def received_frame(H: torch.Tensor, Psi: torch.Tensor, N: torch.Tensor) -> torch.Tensor:
    """``R = Σ_l H_l·Psi_l + N``; H (..., L, Nr, Nt), Psi (..., L, Nt, T),
    N (..., Nr, T)."""
    return torch.einsum("...lmn,...lnt->...mt", H, Psi) + N


def hbf(
    H: torch.Tensor, N: torch.Tensor, Psi: torch.Tensor, Lr: int, W: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conventional HBF observation ``(W_cᴴ R, W_c)`` with ``W_c = W[:, :Lr]``
    (``hbf.m:22-25``)."""
    R = received_frame(H, Psi, N)
    W_c = W[..., :, :Lr]
    return W_c.mH @ R, W_c


def sample_omega(
    gen: torch.Generator, Lr_e: int, Lr: int, T: int, batch: Tuple[int, ...] = ()
) -> torch.Tensor:
    """Random spatial-sampling mask (``proposed_hbf.m:36-41``): per training
    instant a uniformly random Lr-subset of the Lr_e outputs, drawn as the
    double stable argsort of uniform scores (the ``randperm`` equivalent).
    Returns a real (..., Lr_e, T) 0/1 mask whose every column holds Lr ones."""
    scores = torch.rand(
        tuple(batch) + (T, Lr_e), generator=gen, dtype=REAL_DTYPE, device=gen.device
    )
    order = torch.argsort(scores, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return (ranks < Lr).to(REAL_DTYPE).transpose(-2, -1)


class ProposedObservation(NamedTuple):
    Y: torch.Tensor  # (..., Lr_e, T) masked observation  Omega ∘ (W_eᴴ R)
    Omega: torch.Tensor  # (..., Lr_e, T) binary sampling mask
    W_e: torch.Tensor  # (Nr, Lr_e) wide analog combiner
    Y_full: torch.Tensor  # (..., Lr_e, T) unmasked combined frame


def proposed_hbf(
    gen: torch.Generator,
    H: torch.Tensor,
    N: torch.Tensor,
    Psi: torch.Tensor,
    Lr_e: int,
    Lr: int,
    W: torch.Tensor,
) -> ProposedObservation:
    """Proposed random-spatial-sampling HBF observation (``proposed_hbf.m``);
    the mask batch follows the leading dimensions of the received frame."""
    R = received_frame(H, Psi, N)
    W_e = W[..., :, :Lr_e]
    Y_full = W_e.mH @ R
    Omega = sample_omega(gen, Lr_e, Lr, R.shape[-1], batch=tuple(R.shape[:-2]))
    return ProposedObservation(Y=Omega * Y_full, Omega=Omega, W_e=W_e, Y_full=Y_full)


def comm_system_training(
    gens: Mapping[int, torch.Generator],
    H: torch.Tensor,
    T: int,
    noise_var,
    sub_sampling_ratio: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int, torch.Tensor]:
    """The ``wideband_hybBF_comm_system_training.m`` front end on H
    (..., L, Nr, Nt): complex-Gaussian Toeplitz training, the FFT combiner
    over all Nr outputs, and random spatial sampling of
    Lr = round(ratio·Nr) outputs per training instant.  Draws the training,
    the noise and the mask from ``gens``' training, noise and mask roles.

    Returns (Y_proposed, Y_conventional, W, Omega, Lr, Psi); Psi (..., L, Nt, T)
    is the training actually sent, so a driver builds B from the same frames
    (``wideband_hybBF_comm_system_training.m:1,28-30``)."""
    L, Nr, Nt = H.shape[-3:]
    batch = tuple(H.shape[:-3])
    Lr = matlab_round(sub_sampling_ratio * Nr)
    Psi = gaussian_training_frames(gens[prng.ROLE_TRAINING], Nt, T, L, batch=batch)
    # noise of variance noise_var before the combiner
    # (wideband_hybBF_comm_system_training.m:16)
    N = awgn(gens[prng.ROLE_NOISE], Nr, T, noise_var, batch=batch)
    W = create_beamformer(Nr, "fft", device=H.device)
    Y_conv = W.mH @ received_frame(H, Psi, N)
    Omega = sample_omega(gens[prng.ROLE_MASK], Nr, Lr, T, batch=batch)
    return Omega * Y_conv, Y_conv, W, Omega, Lr, Psi
