"""Scalar prior and likelihood modules of the jstsp19 VAMP baseline
(counterpart of ``jstsp19_tpu/solvers/estim.py``: ``CAwgnPrior``,
``SparsePrior`` and ``CAwgnLikelihood``, the three on the experiment path).

Each has ``estim(rhat, rvar) -> (xhat, xvar)``, the posterior moments,
natively complex (circular Gaussians).  Parameters and variances are
tensors that broadcast against the estimates, so a batch of realizations
carries one variance each as a (batch, 1, 1) tensor.  The other modules of
the JAX package wait for the GAMP long tail.
"""
from __future__ import annotations

import dataclasses
import math

import torch

_MAXARG = 500.0  # exparg clamp of SparseScaEstim.m:106-115
_EPS32 = torch.finfo(torch.float32).eps


@dataclasses.dataclass(frozen=True)
class CAwgnPrior:
    """x ~ CN(mean0, var0).  Posterior from rhat = x + CN(0, rvar):
    ``gain = var0/(var0+rvar)`` (``CAwgnEstimIn.m:93-101``)."""

    mean0: object = 0.0
    var0: object = 1.0

    def estim(self, rhat, rvar):
        gain = self.var0 / (self.var0 + rvar)
        return gain * (rhat - self.mean0) + self.mean0, gain * rvar

    def loglikey(self, rhat, rvar):
        """log p(rhat) with rhat = x + CN(0, rvar) (``CAwgnEstimIn.m:176-181``)."""
        v = self.var0 + rvar
        return -(math.log(math.pi) + torch.log(v) + (rhat - self.mean0).abs() ** 2 / v)


@dataclasses.dataclass(frozen=True)
class SparsePrior:
    """Bernoulli spike-slab: x = base w.p. p1, else 0.  Posterior activity
    from the log-domain likelihood ratio with a ±500 clamp
    (``SparseScaEstim.m:77-115``); complex (circular) spike likelihood."""

    base: CAwgnPrior
    p1: float = 0.5

    def estim(self, rhat, rvar):
        rvar = torch.clamp(torch.as_tensor(rvar), min=_EPS32)
        loglike1 = self.base.loglikey(rhat, rvar)
        loglike0 = -(math.log(math.pi) + torch.log(rvar) + rhat.abs() ** 2 / rvar)
        exparg = loglike0 - loglike1 + math.log1p(-self.p1) - math.log(self.p1)
        py1 = 1.0 / (1.0 + torch.exp(torch.clamp(exparg, -_MAXARG, _MAXARG)))
        xhat1, xvar1 = self.base.estim(rhat, rvar)
        xhat = py1 * xhat1
        xvar = py1 * (xhat1.abs() ** 2 + xvar1) - xhat.abs() ** 2
        return xhat, xvar


@dataclasses.dataclass(frozen=True)
class CAwgnLikelihood:
    """y = scale·z + CN(0, wvar).  Posterior of z from z ~ CN(phat, pvar):
    ``gain = pvar/(scale²·pvar + wvar)`` (``CAwgnEstimOut.m:100-112``)."""

    y: torch.Tensor
    wvar: object
    scale: object = 1.0

    def estim(self, phat, pvar):
        gain = pvar / (self.scale**2 * pvar + self.wvar)
        zhat = (self.scale * gain) * (self.y - self.scale * phat) + phat
        return zhat, self.wvar * gain
