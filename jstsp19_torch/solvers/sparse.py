"""Sparse recovery: complex soft thresholding and the l1 beamspace ADMM
(counterpart of ``jstsp19_tpu/solvers/sparse.py``: ``soft_threshold`` and
``sparse_admm``; reference ``benchmark_algorithms/sparse_admm.m``, fixed
ρ = 0.01, τ_s = 1e-4).

``sparse_admm`` is batched over realizations: every observation carries a
leading batch dimension, and the dictionaries are shared or one per
realization.  Its two products of the form Aᴴ·K·Bᴴ and its soft threshold
go through the kernels' routes (``kernels/dictionary.py``,
``kernels/softthresh.py``), which this module imports inside the solve:
``kernels/softthresh.py`` takes :func:`soft_threshold` from here as its
plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch


def soft_threshold(v: torch.Tensor, tau) -> torch.Tensor:
    """``max(|Re|−τ,0)·sign(Re) + j·max(|Im|−τ,0)·sign(Im)``
    (``proposed_algorithm.m:56``, ``sparse_admm.m:22``); ``tau`` broadcasts."""
    re = torch.sign(v.real) * torch.clamp(v.real.abs() - tau, min=0.0)
    im = torch.sign(v.imag) * torch.clamp(v.imag.abs() - tau, min=0.0)
    return torch.complex(re, im)


def sparse_admm(Htrue: torch.Tensor, OH: torch.Tensor, Dr: torch.Tensor, Dt: torch.Tensor, Imax: int,
                rho: float = 0.01, tau_s: float = 1e-4, use_kernels: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beamspace-sparse ADMM recovery of S from an observation OH ≈ Dr·S·Dtᴴ.

    Htrue and OH are (B, Mr, Mt); Dr is (Mr, Gr) and Dt (Mt, Gt), shared, or
    (B, Mr, Gr) and (B, Mt, Gt).  The reference's ``kron(conj(Dt), Dr)``
    stays implicit: ``A·vec(S) = vec(Dr·S·Dtᴴ)``, ``Aᴴ·vec(Y) =
    vec(Drᴴ·Y·Dt)``, and ``(AᴴA − ρI)⁻¹`` is applied in the eigenbasis of
    DrᴴDr ⊗ (DtᴴDt)*, eigenvalues ``outer(dr, dt) − ρ``.

    With ``use_kernels`` (the default) ``Drᴴ·OH·Dt`` and each solve's
    ``Urᴴ·K·Ut`` go through ``dict_correlation_routed`` (Aᴴ·K·Bᴴ with B =
    Dtᴴ and Utᴴ: Imax + 1 kernel launches a solve on the card) and the
    threshold through ``fused_soft_threshold_routed`` (Imax launches); each
    takes its kernel only for complex64 CUDA operands the kernel takes, and
    its plain version at the operands' dtype for any other (a complex128
    solve launches nothing).  Without ``use_kernels``, the plain versions.
    Returns (S (B, Gr, Gt), the NMSE of Dr·S·Dtᴴ against Htrue per
    iteration, (B, Imax)).
    """
    from jstsp19_torch.kernels.dictionary import dict_correlation_plain, dict_correlation_routed
    from jstsp19_torch.kernels.softthresh import fused_soft_threshold_routed

    dr, Ur = torch.linalg.eigh(Dr.mH @ Dr)
    dt, Ut = torch.linalg.eigh(Dt.mH @ Dt)
    eig = dr[..., :, None] * dt[..., None, :] - rho  # eigenvalues of AᴴA − ρI
    if use_kernels:  # the kernel reads dense operands (eigh's vectors are column-major)
        Dr, OH, Ur = Dr.contiguous(), OH.contiguous(), Ur.contiguous()
        Dt_h, Ut_h = Dt.mH.contiguous(), Ut.mH.contiguous()
        ah_k_b, threshold = dict_correlation_routed, fused_soft_threshold_routed
    else:
        Dt_h, Ut_h = Dt.mH, Ut.mH
        ah_k_b, threshold = dict_correlation_plain, soft_threshold
    AhOH = ah_k_b(Dr, OH, Dt_h)  # Aᴴ vec(OH), matrix form
    h2 = (Htrue.abs() ** 2).sum((-2, -1))
    R = Z = torch.zeros(OH.shape[:-2] + eig.shape[-2:], dtype=OH.dtype, device=OH.device)
    errs = []
    for _ in range(Imax):
        S = threshold(R + Z / rho, tau_s / rho)
        R_new = Ur @ (ah_k_b(Ur, Z - rho * S + AhOH, Ut_h) / eig) @ Ut_h  # (AᴴA − ρI)⁻¹ K
        Z = Z + rho * (R_new - S)
        R = R_new
        errs.append(((Dr @ S @ Dt_h - Htrue).abs() ** 2).sum((-2, -1)) / h2)
    return S, torch.stack(errs, -1)
