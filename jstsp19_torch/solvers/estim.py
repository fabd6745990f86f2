"""Scalar prior and likelihood modules of the message-passing solvers
(counterpart of ``jstsp19_tpu/solvers/estim.py``: ``CAwgnPrior``,
``AwgnPrior``, ``SparsePrior`` and ``CAwgnLikelihood``).

Each has ``estim(rhat, rvar) -> (xhat, xvar)``, the posterior moments,
natively complex (circular Gaussians) where the estimates are complex, with
the utilities the GAMP core's adaptive step and max-sum mode call.
Parameters and variances are numbers or tensors that broadcast against the
estimates, so a batch of realizations carries one parameter each as a
(batch, 1) tensor beside (batch, n) estimates (VAMP's matrices: (batch, 1,
1)).  The other modules of the JAX package wait for the GAMP long tail.
"""
from __future__ import annotations

import dataclasses
import math

import torch

_MAXARG = 500.0  # exparg clamp of SparseScaEstim.m:106-115
_EPS32 = torch.finfo(torch.float32).eps
_LOG_PI = math.log(math.pi)
_LOG_2PI = math.log(2 * math.pi)


def _log(v):
    """``log`` of a number or a tensor; a number outside the domain gives
    what ``jnp.log`` gives: NaN below 0, −inf at 0."""
    if isinstance(v, (int, float)):
        return math.log(v) if v > 0 else (-math.inf if v == 0 else math.nan)
    return torch.log(v)


def _log1p(v):
    """``log1p`` with ``jnp.log1p``'s values outside the domain: NaN below
    −1, −inf at −1."""
    if isinstance(v, (int, float)):
        return math.log1p(v) if v > -1 else (-math.inf if v == -1 else math.nan)
    return torch.log1p(v)


def _clamp(v, lo=None, hi=None):
    """``clip`` of a number or a tensor."""
    if isinstance(v, (int, float)):
        return min(max(v, -math.inf if lo is None else lo), math.inf if hi is None else hi)
    return torch.clamp(v, min=lo, max=hi)


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
        return -(_LOG_PI + torch.log(v) + (rhat - self.mean0).abs() ** 2 / v)

    def val_neg_kl(self, rhat, rvar, xhat, xvar):
        """Per-element −D(p(x|r) ‖ p(x)), the adaptive step's utility
        (``CAwgnEstimIn.m:147-154``)."""
        ratio = rvar / (self.var0 + rvar)
        return torch.log(ratio) + (1.0 - ratio) - (xhat - self.mean0).abs() ** 2 / self.var0

    def estim_map(self, rhat, rvar):
        """Max-sum (MAP) branch: MMSE for a Gaussian prior."""
        return self.estim(rhat, rvar)

    def val_map(self, xhat):
        """log p(xhat), the max-sum utility (``CAwgnEstimIn.m:160-166``)."""
        return -(_LOG_PI + _log(self.var0) + (xhat - self.mean0).abs() ** 2 / self.var0)

    def init_moments(self):
        return self.mean0, self.var0


@dataclasses.dataclass(frozen=True)
class AwgnPrior:
    """Real Gaussian prior x ~ N(mean0, var0) (``AwgnEstimIn.m``)."""

    mean0: object = 0.0
    var0: object = 1.0

    def estim(self, rhat, rvar):
        gain = self.var0 / (self.var0 + rvar)
        return gain * (rhat - self.mean0) + self.mean0, gain * rvar

    def loglikey(self, rhat, rvar):
        v = self.var0 + rvar
        return -0.5 * (_LOG_2PI + torch.log(v) + (rhat - self.mean0) ** 2 / v)

    def val_neg_kl(self, rhat, rvar, xhat, xvar):
        """Real-Gaussian −D(p(x|r) ‖ p(x)) (``AwgnEstimIn.m`` val)."""
        ratio = rvar / (self.var0 + rvar)
        return 0.5 * (torch.log(ratio) + (1.0 - ratio) - (xhat - self.mean0) ** 2 / self.var0)

    def estim_map(self, rhat, rvar):
        return self.estim(rhat, rvar)

    def val_map(self, xhat):
        return -0.5 * (_LOG_2PI + _log(self.var0) + (xhat - self.mean0) ** 2 / self.var0)

    def init_moments(self):
        return self.mean0, self.var0


@dataclasses.dataclass(frozen=True)
class SparsePrior:
    """Bernoulli spike-slab: x = base w.p. p1, else 0.  Posterior activity
    from the log-domain likelihood ratio with a ±500 clamp
    (``SparseScaEstim.m:77-115``); a complex rhat takes the circular spike
    likelihood, a real one the real."""

    base: object
    p1: object = 0.5

    def _activity(self, rhat, rvar):
        """P(x ≠ 0 | rhat), with rvar floored at the float32 eps."""
        rvar = torch.clamp(torch.as_tensor(rvar), min=_EPS32)
        loglike1 = self.base.loglikey(rhat, rvar)
        if rhat.is_complex():
            loglike0 = -(_LOG_PI + torch.log(rvar) + rhat.abs() ** 2 / rvar)
        else:
            loglike0 = -0.5 * (_LOG_2PI + torch.log(rvar) + rhat**2 / rvar)
        exparg = loglike0 - loglike1 + _log1p(-self.p1) - _log(self.p1)
        return 1.0 / (1.0 + torch.exp(torch.clamp(exparg, -_MAXARG, _MAXARG)))

    def estim(self, rhat, rvar):
        py1 = self._activity(rhat, rvar)
        xhat1, xvar1 = self.base.estim(rhat, torch.clamp(torch.as_tensor(rvar), min=_EPS32))
        xhat = py1 * xhat1
        xvar = py1 * (xhat1.abs() ** 2 + xvar1) - xhat.abs() ** 2
        return xhat, xvar

    def init_moments(self):
        m1, v1 = self.base.init_moments()
        xhat = self.p1 * m1
        return xhat, self.p1 * (abs(m1) ** 2 + v1) - abs(xhat) ** 2

    def val_neg_kl(self, rhat, rvar, xhat, xvar):
        """Spike-slab −KL: the activity-weighted slab KL plus the Bernoulli
        mixing terms (``SparseScaEstim.m:166-171``)."""
        py1 = self._activity(rhat, rvar)
        py0 = 1.0 - py1
        x1, v1 = self.base.estim(rhat, rvar)
        kl1 = self.base.val_neg_kl(rhat, rvar, x1, v1)
        p1 = _clamp(self.p1, 1e-8, 1.0)
        return (
            py1 * kl1
            + py1 * torch.log(_clamp(p1, 1e-8) / torch.clamp(py1, min=1e-8))
            + py0 * torch.log(_clamp(1.0 - p1, 1e-8) / torch.clamp(py0, min=1e-8))
        )


@dataclasses.dataclass(frozen=True)
class CAwgnLikelihood:
    """y = scale·z + CN(0, wvar), or + N(0, wvar) for a real y.  Posterior of
    z from z ~ CN(phat, pvar): ``gain = pvar/(scale²·pvar + wvar)``
    (``CAwgnEstimOut.m:100-112``)."""

    y: torch.Tensor
    wvar: object
    scale: object = 1.0

    def estim(self, phat, pvar):
        gain = pvar / (self.scale**2 * pvar + self.wvar)
        zhat = (self.scale * gain) * (self.y - self.scale * phat) + phat
        return zhat, self.wvar * gain

    def loglike(self, phat, pvar):
        """E[log p(y|z)] with z ~ CN(phat, pvar), up to the constant
        −log(π·wvar) (``CAwgnEstimOut.m:218-233``, sum-product branch)."""
        w = _clamp(self.wvar, 1e-20)
        return -((self.y - self.scale * phat).abs() ** 2 + self.scale**2 * pvar) / w

    def logscale(self, axhat, pvar, phat):
        """Bethe output cost, closed form (``CAwgnEstimOut.m:241-262``)."""
        w = _clamp(self.wvar, 1e-20)
        s2 = abs(self.scale) ** 2
        return -torch.log(s2 * pvar + w) - (self.y - self.scale * axhat).abs() ** 2 / w - _LOG_PI

    def tune_wvar_ml(self, phat, pvar):
        """ML noise-variance update ``wvar = mean(|y − s·phat|² − s²·pvar)``
        over the last axis, one per realization (``autoTune``/'ML',
        ``CAwgnEstimOut.m:117-131``)."""
        s2 = abs(self.scale) ** 2
        w1 = ((self.y - self.scale * phat).abs() ** 2 - s2 * pvar).mean(-1, keepdim=True)
        return torch.clamp(w1, min=1e-20)

    def tune_wvar_em(self, zhat, zvar):
        """EM noise-variance update ``wvar = mean(|y − s·zhat|² + s²·zvar)``
        over the last axis (``CAwgnEstimOut.m:132-146``)."""
        s2 = abs(self.scale) ** 2
        w1 = ((self.y - self.scale * zhat).abs() ** 2 + s2 * zvar).mean(-1, keepdim=True)
        return torch.clamp(w1, min=1e-20)

    def estim_map(self, phat, pvar):
        """Max-sum branch: MAP is MMSE for the Gaussian channel."""
        return self.estim(phat, pvar)
