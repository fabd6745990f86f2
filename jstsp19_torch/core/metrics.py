"""Error, capacity and energy-efficiency metrics (counterpart of
``jstsp19_tpu/core/metrics.py``).

NMSE convention: ``norm(S-Zbar)^2/norm(Zbar)^2`` with MATLAB's default
matrix norm — the spectral norm — and a clamp at 1 per realization
(``plot_errorVSsnr.m:138-141``).  Batched over leading dimensions.
"""
from __future__ import annotations

import math

import torch


def _sq_norm(X: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "fro":
        return torch.sum(X.abs() ** 2, dim=(-2, -1))
    if kind == "spectral":
        # largest singular value squared == largest eigenvalue of the
        # thin-side Gram
        n, m = X.shape[-2], X.shape[-1]
        G = X @ X.mH if n <= m else X.mH @ X
        ev = torch.linalg.eigvalsh(G)
        return torch.clamp(ev[..., -1], min=0.0)
    raise ValueError(f"unknown norm kind {kind!r}")


def nmse(est: torch.Tensor, ref: torch.Tensor, kind: str = "spectral") -> torch.Tensor:
    """Normalized matrix error ``‖est−ref‖² / ‖ref‖²``."""
    return _sq_norm(est - ref, kind) / _sq_norm(ref, kind)


def clamped_nmse(est: torch.Tensor, ref: torch.Tensor, kind: str = "spectral") -> torch.Tensor:
    """NMSE clamped at 1, as in every reference script (``plot_errorVSsnr.m:139``)."""
    return torch.clamp(nmse(est, ref, kind), max=1.0)


def spectral_efficiency(Y: torch.Tensor, W: torch.Tensor, noise_var, Nt: int) -> torch.Tensor:
    """Achievable spectral efficiency of a combined observation,
    ``C = log2 det(I + (1/(σ²·Nt))·Wᴴ·Y·Yᴴ·W)`` (``plot_capacity.m:44-64``):
    W (..., Nr, M) the combiner, Y (..., Nr, T) the noiseless frame."""
    return combined_spectral_efficiency(W.mH @ Y, noise_var, Nt)


def combined_spectral_efficiency(G: torch.Tensor, noise_var, Nt: int) -> torch.Tensor:
    """:func:`spectral_efficiency` of the combined frame G = Wᴴ·Y (..., M, T),
    through ``slogdet``: a zero row of G (a combiner column left out) adds
    an identity block and nothing to the log-det."""
    K = G @ G.mH
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    _, logdet = torch.linalg.slogdet(eye + K / (noise_var * Nt))
    return logdet.real / math.log(2.0)


def achievable_rate(Zbar: torch.Tensor, nmse_val, noise_var, Nr: int) -> torch.Tensor:
    """The rate driver's proxy ``log2 det(I + (1/Nr)·Z̄·Z̄ᴴ/(σ² + NMSE))``
    (``plot_rateVSframelength.m:81,113,130,135``) of the unclamped NMSE,
    through the Gram's eigenvalues, clamped at 0 before the log."""
    lam = torch.clamp(torch.linalg.eigvalsh(Zbar @ Zbar.mH), min=0.0)
    nmse_val = torch.as_tensor(nmse_val, dtype=lam.dtype, device=lam.device)
    return torch.sum(torch.log2(1.0 + lam / (Nr * (noise_var + nmse_val[..., None]))), dim=-1)


# Power model of plot_ee.m:69-77 (Watts).
P_LNA = 0.02
P_PS = 0.015
P_ZC = 0.06
P_SW = 0.005


def power_proposed(Nr: int, Mr_e: int) -> float:
    """The proposed front end, ``Mr_e·Nr·P_lna + Mr_e·P_sw + Nr·(Mr_e+1)·P_ps``
    (``plot_ee.m:77``)."""
    return Mr_e * Nr * P_LNA + Mr_e * P_SW + Nr * (Mr_e + 1) * P_PS


def power_digital_bf(Nr: int) -> float:
    """The fully digital front end, ``Nr²·P_lna + Nr·(Nr+1)·P_zc`` (``plot_ee.m:74``)."""
    return Nr * Nr * P_LNA + Nr * (Nr + 1) * P_ZC


def power_conventional_hbf(Nr: int, Mr: int, zc: bool = False) -> float:
    """The conventional HBF front end, ``Mr·Nr·P_lna + Nr·(Mr+1)·P_ps``, or
    the ZC network's price with ``zc`` (``plot_ee.m:75-76``)."""
    return Mr * Nr * P_LNA + Nr * (Mr + 1) * (P_ZC if zc else P_PS)


def energy_efficiency(capacity_bits, power_watts) -> torch.Tensor:
    """EE = capacity / power in bits/Joule (``plot_ee.m:84-87``)."""
    return torch.as_tensor(capacity_bits) / power_watts
