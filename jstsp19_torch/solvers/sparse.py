"""Complex soft-thresholding (counterpart of ``jstsp19_tpu/solvers/sparse.py:14``)."""
from __future__ import annotations

import torch


def soft_threshold(v: torch.Tensor, tau) -> torch.Tensor:
    """``max(|Re|−τ,0)·sign(Re) + j·max(|Im|−τ,0)·sign(Im)``
    (``proposed_algorithm.m:56``, ``sparse_admm.m:22``); ``tau`` broadcasts."""
    re = torch.sign(v.real) * torch.clamp(v.real.abs() - tau, min=0.0)
    im = torch.sign(v.imag) * torch.clamp(v.imag.abs() - tau, min=0.0)
    return torch.complex(re, im)
