"""Optimum uniform scalar quantizer for complex samples (counterpart of
``jstsp19_tpu/frontend/quantizer.py``).

``optimum_uniform_quantizer.m``: mid-rise uniform quantization of I and Q
apart, the step being the component's RMS over the whole array times Max's
optimal step for the bit count; returns the quantized value and the cell's
upper and lower edges.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# Max's optimal uniform quantizer steps for a unit-variance Gaussian, 1 to 8
# bits (optimum_uniform_quantizer.m:9-10)
OPTIMUM_STEPSIZE = np.asarray([1.5958, 0.9957, 0.586, 0.3352, 0.1881, 0.1041, 0.0569, 0.0308])
_FALLBACK_STEP = 0.01  # above 8 bits (optimum_uniform_quantizer.m:4-5)


def optimum_uniform_quantizer(x: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize complex samples; returns (quantized, upper edge, lower edge).

    Per component c of I and Q: the step is D = rms(c)·Δ(bits) and the level
    ``sign(c)·(min(ceil(|c|/D), 2^(bits-1)) − 1/2)·D``
    (``optimum_uniform_quantizer.m:12-24``)."""
    if not isinstance(bits, int) or bits < 1:
        raise ValueError("bits must be a positive integer")
    step = _FALLBACK_STEP if bits > 8 else float(OPTIMUM_STEPSIZE[bits - 1])
    half_levels = 2 ** (bits - 1)

    def component(c):
        d = torch.sqrt(torch.mean(c**2)) * step
        mag = torch.clamp(torch.ceil(c.abs() / d), max=half_levels) - 0.5
        return torch.sign(c) * mag * d, d

    qr, dr = component(x.real)
    qi, di = component(x.imag)
    return (torch.complex(qr, qi), torch.complex(qr + dr / 2, qi + di / 2),
            torch.complex(qr - dr / 2, qi - di / 2))
