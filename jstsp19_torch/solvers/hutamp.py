"""Hyperspectral unmixing via bilinear AMP, the HUTAMP capability
(counterpart of ``jstsp19_tpu/solvers/hutamp.py``).

Given per-pixel spectra

    Y (N_pixels × T_bands) = S·A + W,

jointly estimate non-negative abundances S (N × R) whose rows sum to one
and non-negative endmember spectra A (R × T).  The bilinear core is
:func:`jstsp19_torch.solvers.bigamp.bigamp` with truncated-Gaussian-mixture
(non-negative) priors on both factors; the sum-to-one constraint is
imposed with an extra pseudo-band ``delta·1`` appended to Y.  EM
noise-variance refitting runs between restarts.

Real-valued and batched: Y (B, N, T); the endmember prior's scale, the
noise variance and the pseudo-band are per realization, and the simplex
renormalization is per row.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from jstsp19_torch.core import prng
from jstsp19_torch.solvers.bigamp import bigamp
from jstsp19_torch.solvers.bigamp_full import _per_realization
from jstsp19_torch.solvers.estim import NNGMPrior


class HutampResult(NamedTuple):
    S: torch.Tensor  # (B, N, R) abundances, rows ~ simplex
    A: torch.Tensor  # (B, R, T) endmember spectra, non-negative
    Z: torch.Tensor  # (B, N, T) reconstructed spectra


def _priors(y_energy: torch.Tensor, R: int):
    """The abundance and endmember priors for the per-realization |Y|²
    means ``y_energy`` (B, 1, 1): a dense mixture on [0,1]-scale values of
    mean 1/R, and one scaled to the data's per-band energy, its mean and
    variance (B, 1, 1, 1) beside the (K,) = (1,) components."""
    dt, dev = y_energy.dtype, y_energy.device

    def t(*v):
        return torch.tensor(v, dtype=dt, device=dev)

    prior_s = NNGMPrior(t(1.0), t(1.0 / R), t(1.0 / R), p1=t(1.0 - 1e-6)[0])
    a_scale = (torch.sqrt(torch.clamp(y_energy, min=1e-12)) * (R * 1.0) ** 0.5)[..., None]
    prior_a = NNGMPrior(t(1.0), t(1.0) * a_scale, t(1.0) * a_scale**2, p1=t(1.0 - 1e-6)[0])
    return prior_s, prior_a


def hutamp(
    Y: torch.Tensor,
    n_materials: int,
    key,
    noise_var=None,
    nit: int = 150,
    n_em: int = 3,
    step: float = 0.3,
    delta: float = 1.0,
) -> HutampResult:
    """Unmix ``Y ≈ S·A`` into R = ``n_materials`` non-negative factors.

    ``delta`` weights the sum-to-one pseudo-band (larger = harder
    constraint).  ``noise_var`` defaults to a 100:1 SNR guess and is
    EM-refit from the residual between restarts.

    Constraint handling note (round 5): the pseudo-band's endmember
    column is NOT pinned at delta — it carries the same free NN prior as
    the real bands — so during the bilinear fit the augmentation enforces
    only that abundance ROWS share a common sum (any constant c with
    a_col = delta/c fits the pseudo-band); the exact simplex projection
    happens in the post-hoc row renormalization below.  This is a
    deliberate softening of HUTAMP.m's pinned-column augmentation: a
    pinned column needs a per-column prior override that BiG-AMP's
    homogeneous prior interface here does not carry, and the
    equal-row-sum + renormalize combination recovers the same factors on
    the tested unmixing problems.
    """
    B, N, T = Y.shape
    R = n_materials
    rdt, dev = Y.dtype, Y.device
    # one |Y|² mean, noise variance and prior scale a realization
    y_energy = (Y**2).mean((1, 2), keepdim=True)
    nv = y_energy / 101.0 if noise_var is None else _per_realization(noise_var, B, 2, rdt, dev)

    # augmented observation, per realization: the extra band forces S·(delta·1) ≈ delta·1
    Y_aug = torch.cat([Y, torch.full((B, N, 1), delta, dtype=rdt, device=dev)], -1)
    mask = torch.ones(Y_aug.shape, dtype=rdt, device=dev)
    prior_s, prior_a = _priors(y_energy, R)

    k = key
    res = None
    for _ in range(n_em):
        res = bigamp(Y_aug, mask, R, prior_s, prior_a, nv, k, nit=nit, step=step)
        nv = torch.clamp(((Y_aug - res.Z) ** 2).mean((1, 2), keepdim=True), min=1e-12)
        k = prng.fold_in(k, 1)
    # drop the pseudo-band, clip negatives, renormalize each row to the simplex
    A = torch.clamp(res.X[..., :T].real, min=0.0)
    S = torch.clamp(res.A.real, min=0.0)
    S = S / torch.clamp(S.sum(-1, keepdim=True), min=1e-12)
    return HutampResult(S=S, A=A, Z=S @ A)
