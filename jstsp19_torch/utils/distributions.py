"""Discrete-distribution helpers (counterpart of
``jstsp19_tpu/utils/distributions.py``: ``DisDist`` and ``weibull_grid``;
``main/DisDist.m`` and ``main/Weibull.m``).

The reference's estimator test harness and its neural-connectivity
simulator build signals from a gridded discrete distribution.  Sampling is
inverse-CDF with ``torch.searchsorted`` on a ``torch.Generator``'s device, not
the reference's per-sample loop; the draws differ from JAX's, their
distribution does not.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jstsp19_torch.core.config import resolve_device


@dataclasses.dataclass(frozen=True)
class DisDist:
    """A discrete distribution over support points ``x`` with probabilities
    ``px``, normalized on construction (``main/DisDist.m``)."""

    x: torch.Tensor
    px: torch.Tensor

    def __post_init__(self):
        px = torch.as_tensor(self.px, dtype=torch.float32)
        object.__setattr__(self, "px", px / px.sum())
        object.__setattr__(self, "x", torch.as_tensor(self.x, device=px.device))

    def mean_var(self):
        """The mean and variance (``DisDist.m:19-24``)."""
        m = (self.x * self.px).sum()
        return m, ((self.x - m).abs() ** 2 * self.px).sum()

    def sample(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """n i.i.d. draws by inverse CDF (``DisDist.m:27-35``) on the
        generator's device."""
        cdf = torch.cumsum(self.px, 0).to(gen.device)
        u = torch.rand(n, generator=gen, device=gen.device)
        idx = torch.searchsorted(cdf, u, side="right")
        return self.x.to(gen.device)[torch.clamp(idx, 0, self.x.shape[0] - 1)]


def weibull_grid(k: float, lam: float, xmax: float = 10.0, nx0: int = 1000, device=None):
    """The Weibull(k, λ) pdf discretized on a uniform grid (``main/Weibull.m``,
    which evaluates ``wblpdf`` at the half-cell offsets and normalizes):
    ``(x0, px0)`` float32 on ``device`` (the card unless named), ready for
    :class:`DisDist`."""
    x0 = np.linspace(0.0, xmax, nx0)
    xs = x0 + xmax / (2 * nx0)
    px0 = (k / lam) * (xs / lam) ** (k - 1) * np.exp(-((xs / lam) ** k))
    dev = resolve_device(device)
    return (torch.as_tensor(x0, dtype=torch.float32, device=dev),
            torch.as_tensor(px0 / px0.sum(), dtype=torch.float32, device=dev))
