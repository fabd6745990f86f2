"""Scalar prior and likelihood modules of the message-passing solvers
(counterpart of ``jstsp19_tpu/solvers/estim.py``: all 45 of its classes).

Each has ``estim(rhat, rvar) -> (xhat, xvar)``, the posterior moments,
natively complex (circular Gaussians) where the estimates are complex, with
the utilities the GAMP core's adaptive step and max-sum mode call
(``val_neg_kl``, ``loglike``, ``logscale``, ``estim_map``, ``val_map``) and
``init_moments`` where the JAX class has them.  Parameters and variances are
numbers or tensors that broadcast against the estimates, so a batch of
realizations carries one parameter each as a (batch, 1) tensor beside
(batch, n) estimates (VAMP's matrices: (batch, 1, 1)); a mixture's
per-component parameters are (K,), or (batch, 1, K) per realization.
Where JAX reduces over its one problem (the DMM thresholds, the
function-handle prior's divergence, the truth reporter, ``L1Likelihood``'s
auto scale), the port reduces per realization: over every axis but the
leading (batch) one of a tensor of two or more dimensions, over the one
axis of a vector.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_MAXARG = 500.0  # exparg clamp of SparseScaEstim.m:106-115
_EPS32 = torch.finfo(torch.float32).eps
_LOG_PI = math.log(math.pi)
_LOG_2PI = math.log(2 * math.pi)
_LOG_2 = 0.6931472  # log 2, as JAX's _log1mexp writes it
_TAIL = 12.0  # standard deviations beyond which a half-line's moments take the Mills-ratio series


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


def _t(v, ref: torch.Tensor) -> torch.Tensor:
    """A number or a tensor as a tensor on ``ref``'s device (a number in
    ``ref``'s real dtype)."""
    if isinstance(v, torch.Tensor):
        return v.to(ref.device)
    return torch.as_tensor(v, dtype=ref.real.dtype if ref.is_complex() else ref.dtype, device=ref.device)


def _node(p):
    """A per-realization parameter ((batch, 1) or a number) lined up against
    an extra trailing axis of quadrature nodes or particles."""
    return p[..., None] if isinstance(p, torch.Tensor) and p.dim() > 0 else p


def _pdims(v: torch.Tensor):
    """The axes of one realization: all but the leading one, or the one axis
    of a vector."""
    return tuple(range(1, v.dim())) if v.dim() >= 2 else tuple(range(v.dim()))


def _pmean(v):
    """Mean over each realization (``_pdims``), kept as (batch, 1, …)."""
    if not isinstance(v, torch.Tensor) or v.dim() == 0:
        return v
    return v.mean(_pdims(v), keepdim=True)


def _psum(v: torch.Tensor) -> torch.Tensor:
    return v.sum(_pdims(v), keepdim=True) if v.dim() else v


def _where_scalar(cond, a, b):
    """``jnp.where`` whose condition may be a Python bool."""
    if isinstance(cond, bool):
        return a if cond else b
    return torch.where(cond, a, b)


def _log1mexp(d):
    """log(1 − e^d) for d ≤ 0, accurate for tiny |d| (Mächler's log1mexp:
    the log(−expm1) branch keeps precision where log1p(−exp) cancels; exp(d)
    rounds to 1 below the float eps, so the clamp only guards d = 0)."""
    d = torch.clamp(d, max=-1e-30)
    return torch.where(d > -_LOG_2, torch.log(-torch.expm1(d)), torch.log1p(-torch.exp(d)))


def _log_ndiff(a, b):
    """log(Φ(b) − Φ(a)) for a ≤ b, stable in both tails: the lower-tail form
    log Φ(b) + log1mexp(log Φ(a) − log Φ(b)) where the interval sits in the
    left half, the mirrored upper-tail form (Φ(−a) − Φ(−b)) in the right."""
    logcdf = torch.special.log_ndtr
    lo_b, lo_a = logcdf(b), logcdf(a)
    lower = lo_b + _log1mexp(lo_a - lo_b)
    up_a, up_b = logcdf(-a), logcdf(-b)
    upper = up_a + _log1mexp(up_b - up_a)
    return torch.where(a + b > 0, upper, lower)


def _tn_moments(phat, pvar, lo, hi):
    """Moments of N(phat, pvar) truncated to [lo, hi]: (mean, var, logZ) with
    logZ = log P(lo ≤ x ≤ hi), the pdf/mass ratios formed in the log domain
    so that extreme truncation stays finite.  For a finite interval pvar is
    capped at 1e2·width² (the float32 guard of the JAX package: beyond it
    the raw formulas cancel, and the capped moments are exact to float32);
    half-lines (±inf endpoints) are left uncapped.

    A half-line more than ``_TAIL`` standard deviations from phat takes the
    asymptotic series of the inverse Mills ratio instead (here the port
    departs from the JAX formula, which it equals to 1e-5 at the switch):
    there φ(a)/Z is exp of a difference of terms of order a²/2, whose
    float32 rounding (ulp(a²/2)) grows without bound — at a ~ 1e5 it is
    e^±512, and the mean comes out ±inf or of the wrong sign, where the
    truncated mean is the edge plus σ/a and the variance (σ/a)².  BiG-AMP's
    non-negative priors (``hutamp``) reach such a on a diverging step."""
    ref = phat if isinstance(phat, torch.Tensor) else pvar
    phat, pvar, lo, hi = (_t(v, ref) for v in (phat, pvar, lo, hi))
    width2 = (hi - lo) ** 2
    cap = 1e2 * torch.clamp(width2, min=1e-30)
    pvar = torch.where(torch.isfinite(width2), torch.minimum(pvar, cap), pvar)
    sig = torch.sqrt(pvar)
    a = (lo - phat) / sig
    b = (hi - phat) / sig
    logZ = _log_ndiff(a, b)
    log_norm = -0.5 * _LOG_2PI
    # φ(a)/Z and φ(b)/Z through exp(logpdf − logZ); ±inf endpoints give 0
    pa = torch.where(torch.isfinite(a), torch.exp(log_norm - 0.5 * a**2 - logZ), 0.0)
    pb = torch.where(torch.isfinite(b), torch.exp(log_norm - 0.5 * b**2 - logZ), 0.0)
    apa = torch.where(torch.isfinite(a), a * pa, 0.0)
    bpb = torch.where(torch.isfinite(b), b * pb, 0.0)
    mean = phat + sig * (pa - pb)
    t = 1.0 + (apa - bpb) - (pa - pb) ** 2
    # far-tail half-lines, [lo, ∞) with a > _TAIL or (−∞, hi] with b < −_TAIL:
    # λ(c) − c = 1/c − 2/c³ + 10/c⁵ − 74/c⁷ + 706/c⁹ and
    # Var/σ² = 1/c² − 6/c⁴ + 50/c⁶ − 518/c⁸, c = a or −b
    lower = torch.isinf(hi) & torch.isfinite(lo) & (a > _TAIL)
    upper = torch.isinf(lo) & torch.isfinite(hi) & (b < -_TAIL)
    c = torch.clamp(torch.where(upper, -b, a), min=_TAIL)
    ic2 = 1.0 / c**2
    delta = (1.0 - ic2 * (2.0 - ic2 * (10.0 - ic2 * (74.0 - 706.0 * ic2)))) / c
    t_tail = ic2 * (1.0 - ic2 * (6.0 - ic2 * (50.0 - 518.0 * ic2)))
    mean = torch.where(lower, lo + sig * delta, torch.where(upper, hi - sig * delta, mean))
    t = torch.where(lower | upper, t_tail, t)
    return mean, torch.clamp(pvar * t, min=1e-30), logZ


def _gaussian_loglike(r, v, cplx=None):
    """log N(r; 0, v): circular where ``cplx`` (default: r is complex), real
    otherwise."""
    if r.is_complex() if cplx is None else cplx:
        return -(_LOG_PI + _log(v) + r.abs() ** 2 / v)
    return -0.5 * (_LOG_2PI + _log(v) + r**2 / v)


def _soft(r, thresh):
    """sign(r)·max(|r| − thresh, 0) with the shrunk magnitude: (x, shrunk)."""
    mag = r.abs()
    shrunk = torch.clamp(mag - thresh, min=0.0)
    return torch.where(mag > 0, r / torch.clamp(mag, min=1e-30) * shrunk, 0.0), shrunk


# -- the Gaussian priors, the spike-slab wrapper and the AWGN channel ---------


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
        loglike0 = _gaussian_loglike(rhat, rvar)
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
class SoftThreshPrior:
    """Laplacian-MAP denoiser (``SoftThreshEstimIn``):
    ``xhat = sign(r)·max(|r|−λ·rvar, 0)`` with the df-based variance."""

    lam: object = 1.0

    def estim(self, rhat, rvar):
        xhat, shrunk = _soft(rhat, self.lam * rvar)
        return xhat, rvar * (shrunk > 0).to(torch.float32)

    def estim_map(self, rhat, rvar):
        """Already the Laplacian-MAP prox (max-sum only in the reference)."""
        return self.estim(rhat, rvar)

    def val_map(self, xhat):
        return -self.lam * xhat.abs()

    def init_moments(self):
        return 0.0, 2.0 / self.lam**2


@dataclasses.dataclass(frozen=True)
class CGMPrior:
    """Circular Gaussian-mixture prior x ~ Σ_k w_k·CN(mu_k, v_k) (the
    ``GMEstimIn`` analog): responsibility-weighted component posteriors.
    ``weights``, ``means`` and ``variances`` are (K,), or (batch, 1, K)."""

    weights: torch.Tensor
    means: torch.Tensor
    variances: torch.Tensor

    def estim(self, rhat, rvar):
        r = rhat[..., None]
        rv = _node(_t(rvar, rhat))
        v = self.variances + rv
        loglike = -(_LOG_PI + torch.log(v) + (r - self.means).abs() ** 2 / v)
        logw = torch.log(self.weights) + loglike
        resp = torch.exp(logw - torch.logsumexp(logw, -1, keepdim=True))
        gain = self.variances / v
        post_mean = gain * (r - self.means) + self.means
        post_var = gain * rv
        xhat = (resp * post_mean).sum(-1)
        ex2 = (resp * (post_mean.abs() ** 2 + post_var)).sum(-1)
        return xhat, torch.clamp(ex2 - xhat.abs() ** 2, min=0.0)

    def loglikey(self, rhat, rvar):
        """log p(r) with r = x + CN(0, rvar), the mixture marginal that
        :class:`SparsePrior` weighs its spike against."""
        rv = _node(rvar)
        v = self.variances + rv
        loglike = -(_LOG_PI + torch.log(v) + (rhat[..., None] - self.means).abs() ** 2 / v)
        return torch.logsumexp(torch.log(self.weights) + loglike, -1)

    def init_moments(self):
        m = (self.weights * self.means).sum(-1)
        v = (self.weights * (self.means.abs() ** 2 + self.variances)).sum(-1) - m.abs() ** 2
        return m, v


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


# -- the classification and quantized channels ------------------------------------


@dataclasses.dataclass(frozen=True)
class ProbitLikelihood:
    """Binary y ∈ {0,1} of sign(z + N(0, wvar)), real z (``ProbitEstimOut``):
    posterior moments of z ~ N(phat, pvar)."""

    y: torch.Tensor
    wvar: object = 1e-2

    def estim(self, phat, pvar):
        s = 2.0 * self.y - 1.0
        denom = torch.sqrt(pvar + self.wvar)
        alpha = s * phat / denom
        logpdf = -0.5 * alpha**2 - 0.5 * _LOG_2PI
        ratio = torch.exp(logpdf - torch.special.log_ndtr(alpha))
        zhat = phat + s * pvar / denom * ratio
        zvar = pvar - pvar**2 / (pvar + self.wvar) * ratio * (alpha + ratio)
        return zhat, torch.clamp(zvar, min=1e-12)

    def loglike(self, phat, pvar):
        """log Φ(±phat/√(pvar + wvar)), the sum-product logLike of
        ``classification/ProbitEstimOut.m:340-356``."""
        s = 2.0 * self.y - 1.0
        return torch.special.log_ndtr(s * phat / torch.sqrt(pvar + self.wvar))


@dataclasses.dataclass(frozen=True)
class PoissonLikelihood:
    """Counts y ~ Poisson(scale·z), z ≥ 0 (``PoissonEstim``): a Gaussian
    posterior from the quadratic expansion of the log-likelihood."""

    y: torch.Tensor
    scale: object = 1.0

    def estim(self, phat, pvar):
        z0 = torch.clamp(phat, min=1e-6)
        grad = self.y / z0 - self.scale
        curv = self.y / z0**2
        post_prec = 1.0 / pvar + curv
        zhat = z0 + (grad + (phat - z0) / pvar) / post_prec
        return torch.clamp(zhat, min=0.0), 1.0 / post_prec


@dataclasses.dataclass(frozen=True)
class QuantizedLikelihood:
    """Interval observation of a uniform scalar quantizer: z known to lie in
    [lo, hi] per component (the few-bit-ADC receiver); the moments of
    N(phat, pvar) truncated to it."""

    lo: torch.Tensor
    hi: torch.Tensor

    def estim(self, phat, pvar):
        zhat, zvar, _ = _tn_moments(phat, pvar, self.lo, self.hi)
        return zhat, torch.clamp(zvar, min=1e-12)


@dataclasses.dataclass(frozen=True)
class OutlierLikelihood:
    """y = z + noise, the noise CN(0, wvar) w.p. 1−lam and CN(0, wvar_out)
    w.p. lam (robust PCA's sparse outliers)."""

    y: torch.Tensor
    wvar: object
    wvar_out: object
    lam: object = 0.05

    def estim(self, phat, pvar):
        def comp(wv):
            v = pvar + wv
            loglike = -(_LOG_PI + torch.log(v) + (self.y - phat).abs() ** 2 / v)
            gain = pvar / v
            return loglike, phat + gain * (self.y - phat), wv * gain

        l0, z0, v0 = comp(self.wvar)
        l1, z1, v1 = comp(self.wvar_out)
        exparg = torch.clamp(l1 - l0 + _log(self.lam) - _log1p(-self.lam), -_MAXARG, _MAXARG)
        r1 = 1.0 / (1.0 + torch.exp(-exparg))
        zhat = (1 - r1) * z0 + r1 * z1
        ez2 = (1 - r1) * (z0.abs() ** 2 + v0) + r1 * (z1.abs() ** 2 + v1)
        return zhat, torch.clamp(ez2 - zhat.abs() ** 2, min=1e-12)


@dataclasses.dataclass(frozen=True)
class AwbgnLikelihood:
    """Additive white Bernoulli-Gaussian noise (``main/AwbgnEstimOut.m``):
    p(y|z) = (1−λ)·δ(z−y) + λ·N(z; y, wvar), real."""

    y: torch.Tensor
    wvar: object
    lam: object = 0.1

    def estim(self, phat, pvar):
        d2 = (phat - self.y) ** 2
        loglike0 = -0.5 * (_LOG_2PI + torch.log(pvar) + d2 / pvar)
        v1 = pvar + self.wvar
        loglike1 = -0.5 * (_LOG_2PI + torch.log(v1) + d2 / v1)
        exparg = torch.clamp(loglike0 - loglike1 + _log1p(-self.lam) - _log(self.lam), -_MAXARG, _MAXARG)
        py1 = 1.0 / (1.0 + torch.exp(exparg))  # Pr{z ≠ y | y}
        py0 = 1.0 - py1
        nu = self.wvar * pvar / v1
        gamma = (self.wvar * phat + self.y * pvar) / v1
        zhat = py1 * gamma + py0 * self.y
        ez2 = py1 * (gamma**2 + nu) + py0 * self.y**2
        return zhat, torch.clamp(ez2 - zhat**2, min=1e-14)

    def loglike(self, zhat, zvar):
        """The lower-bound cost of ``AwbgnEstimOut.m:96-103`` with only the
        quadratic term over wvar, as the JAX package corrects it."""
        wv = _clamp(self.wvar, 1e-20)
        return -0.5 * (_LOG_2PI + _log(wv) + ((self.y - zhat) ** 2 + zvar) / wv) + _log(self.lam)


@dataclasses.dataclass(frozen=True)
class TruthReporterPrior:
    """Debugging wrapper that prints, once per realization and call, the
    in-flight diagnostics of ``main/TruthReporter.m`` against a known truth:
    |corr(rhat − x, x)|, rhatMSE/rvar, xhatMSE/xvar and the NMSE in dB.  The
    other hooks are the wrapped prior's."""

    base: object
    truth: torch.Tensor

    def report(self, rhat, rvar, xhat, xvar):
        """The four diagnostics, one per realization, as 1-D tensors."""
        err = rhat - self.truth
        e0, t0 = err - _pmean(err), self.truth - _pmean(self.truth)
        ec = _psum(e0.conj() * t0)
        denom = torch.sqrt(_psum(e0.abs() ** 2) * _psum(t0.abs() ** 2))
        corr = ec.abs() / torch.clamp(denom, min=1e-30)
        r = _pmean(err.abs() ** 2) / torch.clamp(_pmean(_t(rvar, rhat)), min=1e-30)
        x = _pmean((xhat - self.truth).abs() ** 2) / torch.clamp(_pmean(_t(xvar, rhat)), min=1e-30)
        nmse = 10.0 * torch.log10(_psum((xhat - self.truth).abs() ** 2)
                                  / torch.clamp(_psum(self.truth.abs() ** 2), min=1e-30))
        return tuple(v.reshape(-1) for v in torch.broadcast_tensors(corr, r, x, nmse))

    def estim(self, rhat, rvar):
        xhat, xvar = self.base.estim(rhat, rvar)
        for c, r, x, n in zip(*(v.tolist() for v in self.report(rhat, rvar, xhat, xvar))):
            print(f"truth: |corr(rhat-x,x)|={c:.2f} rhatMSE/rvar={r:.4f} xhatMSE/xvar={x:.4f} NMSE={n:.2f} dB")
        return xhat, xvar

    def __getattr__(self, name):
        # estim_map / val_neg_kl / ... are the wrapped prior's; the guard on
        # dunders and own fields keeps copy and unpickling from recursing
        if name.startswith("__") or name in ("base", "truth"):
            raise AttributeError(name)
        return getattr(self.base, name)


# -- priors on the real line and the half-line ---------------------------------------


@dataclasses.dataclass(frozen=True)
class LaplacePrior:
    """Laplacian MMSE prior p(x) = (lam/2)·exp(−lam|x|), real
    (``LaplaceEstimIn.m``): the posterior is two half-line truncated
    Gaussians, TN(r − lam·rvar, rvar, [0, ∞)) and its mirror."""

    lam: object = 1.0

    def estim(self, rhat, rvar):
        lam = self.lam
        rvar = _t(rvar, rhat)
        sig = torch.sqrt(rvar)
        mp = rhat - lam * rvar
        mm = rhat + lam * rvar
        logw_p = -lam * rhat + torch.special.log_ndtr(mp / sig)
        logw_m = lam * rhat + torch.special.log_ndtr(-mm / sig)
        wmax = torch.maximum(logw_p, logw_m)
        wp, wm = torch.exp(logw_p - wmax), torch.exp(logw_m - wmax)
        pi_p = wp / (wp + wm)
        mean_p, var_p, _ = _tn_moments(mp, rvar, 0.0, math.inf)
        mean_m, var_m, _ = _tn_moments(mm, rvar, -math.inf, 0.0)
        xhat = pi_p * mean_p + (1 - pi_p) * mean_m
        ex2 = pi_p * (mean_p**2 + var_p) + (1 - pi_p) * (mean_m**2 + var_m)
        return xhat, torch.clamp(ex2 - xhat**2, min=1e-30)

    def estim_map(self, rhat, rvar):
        """Max-sum branch: the soft-threshold prox of lam·|x|."""
        xhat = torch.sign(rhat) * torch.clamp(rhat.abs() - self.lam * rvar, min=0.0)
        return xhat, rvar * (xhat.abs() > 0)

    def val_map(self, xhat):
        return _log(self.lam / 2.0) - self.lam * xhat.abs()

    def init_moments(self):
        return 0.0, 2.0 / self.lam**2


@dataclasses.dataclass(frozen=True)
class UnifPrior:
    """Uniform prior x ~ U[lo, hi], real (``UnifEstimIn.m``): the posterior
    is the normal truncated to [lo, hi]."""

    lo: object = 0.0
    hi: object = 1.0

    def estim(self, rhat, rvar):
        xhat, xvar, _ = _tn_moments(rhat, rvar, self.lo, self.hi)
        return xhat, xvar

    def estim_map(self, rhat, rvar):
        """Max-sum branch: clip to the support; the curvature is rvar inside
        and 0 at an active bound."""
        lo, hi = _t(self.lo, rhat), _t(self.hi, rhat)
        xhat = torch.minimum(torch.maximum(rhat, lo), hi)
        return xhat, rvar * ((rhat > lo) & (rhat < hi))

    def init_moments(self):
        return (self.lo + self.hi) / 2.0, (self.hi - self.lo) ** 2 / 12.0


@dataclasses.dataclass(frozen=True)
class NNGMPrior:
    """Non-negative Bernoulli–truncated-Gaussian-mixture prior, real (the
    estimator of the reference's EM-NN-AMP): x = 0 w.p. 1−p1, else
    Σ_k w_k·N(mu_k, v_k) truncated to x ≥ 0, each component's responsibility
    carrying its truncation mass.  ``p1 = 1`` is the dense prior."""

    weights: torch.Tensor
    means: torch.Tensor
    variances: torch.Tensor
    p1: object = 1.0

    def estim(self, rhat, rvar):
        rvar = _t(rvar, rhat)
        r = rhat[..., None]
        rv = rvar[..., None] if rvar.dim() else rvar
        v = self.variances + rv
        gain = self.variances / v
        m = gain * (r - self.means) + self.means
        s = gain * rv * torch.ones_like(m)
        mean_k, var_k, logZ_k = _tn_moments(m, s, 0.0, math.inf)
        # evidence of component k: N(r; mu_k, v)·Z_k / Φ(mu_k/√v_k)
        log_ev = (-0.5 * (_LOG_2PI + torch.log(v) + (r - self.means) ** 2 / v) + logZ_k
                  - torch.special.log_ndtr(self.means / torch.sqrt(self.variances)))
        logw = torch.log(self.weights) + log_ev
        log_slab = torch.logsumexp(logw, -1)
        resp = torch.exp(logw - log_slab[..., None])
        slab_mean = (resp * mean_k).sum(-1)
        slab_ex2 = (resp * (mean_k**2 + var_k)).sum(-1)
        log_spike = -0.5 * (_LOG_2PI + torch.log(rvar) + rhat**2 / rvar)
        exparg = torch.clamp(log_spike - log_slab + _log1p(-_clamp(self.p1, hi=1 - 1e-12)) - _log(self.p1),
                             -_MAXARG, _MAXARG)
        py1 = 1.0 / (1.0 + torch.exp(exparg))
        py1 = _where_scalar(self.p1 >= 1.0, torch.ones_like(py1), py1)
        xhat = py1 * slab_mean
        return xhat, torch.clamp(py1 * slab_ex2 - xhat**2, min=1e-30)

    def init_moments(self):
        mean_k, var_k, _ = _tn_moments(self.means, self.variances, 0.0, math.inf)
        m = self.p1 * (self.weights * mean_k).sum(-1)
        ex2 = self.p1 * (self.weights * (mean_k**2 + var_k)).sum(-1)
        return m, torch.clamp(ex2 - m**2, min=1e-30)


@dataclasses.dataclass(frozen=True)
class SNIPEPrior:
    """SNIPE (``main/SNIPEstim.m``), the limit of a Bernoulli × flat-slab
    prior: 0 w.p. 1−g and N(rhat, rvar) w.p. g, with
    g = sigmoid(|rhat|²/(c·rvar) − omega), c = 2 for real r, 1 for complex."""

    omega: object = 2.0

    def estim(self, rhat, rvar):
        c = 1.0 if rhat.is_complex() else 2.0
        exparg = torch.clamp(rhat.abs() ** 2 / (c * rvar) - self.omega, -_MAXARG, _MAXARG)
        g = 1.0 / (1.0 + torch.exp(-exparg))
        xhat = g * rhat
        ex2 = g * (rhat.abs() ** 2 + rvar)
        return xhat, torch.clamp(ex2 - xhat.abs() ** 2, min=1e-30)

    def init_moments(self):
        return 0.0, 1.0


@dataclasses.dataclass(frozen=True)
class EllpPrior:
    """l_p MAP denoiser, 0 < p ≤ 1 (``main/EllpEstimIn.m``): one reweighted
    soft threshold with the weight lam·p·|rhat|^(p−1) (exact at p = 1)."""

    lam: object = 1.0
    p: object = 1.0

    def estim(self, rhat, rvar):
        w = self.lam * self.p * torch.clamp(rhat.abs(), min=1e-12) ** (self.p - 1.0)
        xhat, shrunk = _soft(rhat, w * rvar)
        return xhat, torch.clamp(rvar * (shrunk > 0).to(torch.float32), min=1e-30)

    def init_moments(self):
        return 0.0, 2.0 / self.lam**2


@dataclasses.dataclass(frozen=True)
class DiscretePrior:
    """Finite alphabet x ∈ {a_k} w.p. w_k (``main/DisScaEstim.m``, and
    ``DisCScaEstim.m:29-52`` where the alphabet or rhat is complex): the
    softmax over the atoms.  ``atoms`` and ``weights`` are (K,)."""

    atoms: torch.Tensor
    weights: torch.Tensor

    def estim(self, rhat, rvar):
        r = rhat[..., None]
        rv = _node(rvar)
        if self.atoms.is_complex() or rhat.is_complex():
            loglike = -(r - self.atoms).abs() ** 2 / rv
        else:
            loglike = -((r - self.atoms) ** 2) / (2.0 * rv)
        logw = torch.log(self.weights) + loglike
        resp = torch.exp(logw - torch.logsumexp(logw, -1, keepdim=True))
        xhat = (resp * self.atoms).sum(-1)
        ex2 = (resp * self.atoms.abs() ** 2).sum(-1)
        return xhat, torch.clamp(ex2 - xhat.abs() ** 2, min=1e-30)

    def init_moments(self):
        m = (self.weights * self.atoms).sum(-1)
        return m, (self.weights * self.atoms.abs() ** 2).sum(-1) - m.abs() ** 2


@dataclasses.dataclass(frozen=True)
class GroupSparsePrior:
    """Group-shared spike-slab: the last axis is a group, active or inactive
    as a whole (turboGAMP's group sparsity); the log-likelihood ratios pool
    over that axis before the sigmoid."""

    base: object
    p1: object = 0.5

    def estim(self, rhat, rvar):
        rvar = torch.clamp(_t(rvar, rhat), min=_EPS32)
        loglike1 = self.base.loglikey(rhat, rvar)
        loglike0 = _gaussian_loglike(rhat, rvar)
        pooled = (loglike0 - loglike1).sum(-1, keepdim=True)
        exparg = torch.clamp(pooled + _log1p(-self.p1) - _log(self.p1), -_MAXARG, _MAXARG)
        py1 = 1.0 / (1.0 + torch.exp(exparg))
        xhat1, xvar1 = self.base.estim(rhat, rvar)
        xhat = py1 * xhat1
        xvar = py1 * (xhat1.abs() ** 2 + xvar1) - xhat.abs() ** 2
        return xhat, torch.clamp(xvar, min=1e-30)

    def init_moments(self):
        m1, v1 = self.base.init_moments()
        xhat = self.p1 * m1
        return xhat, self.p1 * (abs(m1) ** 2 + v1) - abs(xhat) ** 2


# the Gauss–Hermite rules for N(0, 1) expectations: 17 nodes, and 33 for the
# heavy-tailed robit channel (numpy's nodes, as the JAX package's)
_GH_X, _GH_W = np.polynomial.hermite.hermgauss(17)
_GH_X, _GH_W = _GH_X * np.sqrt(2.0), _GH_W / np.sqrt(np.pi)
_GH33_X, _GH33_W = np.polynomial.hermite.hermgauss(33)
_GH33_X, _GH33_W = _GH33_X * np.sqrt(2.0), _GH33_W / np.sqrt(np.pi)


def _rule(nodes, weights, ref: torch.Tensor):
    """A quadrature rule as float32 tensors on ``ref``'s device: (x, log w)."""
    x = torch.as_tensor(nodes, dtype=torch.float32, device=ref.device)
    return x, torch.log(torch.as_tensor(weights, dtype=torch.float32, device=ref.device))


def _quadrature_moments(z, logw):
    """Mean and variance of the nodes ``z`` (…, Q) under the unnormalized
    log weights ``logw``."""
    w = torch.exp(logw - torch.logsumexp(logw, -1, keepdim=True))
    zhat = (w * z).sum(-1)
    ez2 = (w * z**2).sum(-1)
    return zhat, torch.clamp(ez2 - zhat**2, min=1e-12)


@dataclasses.dataclass(frozen=True)
class LogitLikelihood:
    """Binary logistic channel p(y=1|z) = sigmoid(scale·z), y ∈ {0,1}, real
    (``main/LogitEstimOut.m``): moments by the 17-node Gauss–Hermite rule."""

    y: torch.Tensor
    scale: object = 1.0

    def estim(self, phat, pvar):
        gx, glw = _rule(_GH_X, _GH_W, phat)
        z = phat[..., None] + torch.sqrt(_t(pvar, phat))[..., None] * gx
        s = (2.0 * self.y - 1.0)[..., None]
        a = -s * _node(self.scale) * z
        return _quadrature_moments(z, glw - torch.logaddexp(torch.zeros_like(a), a))


@dataclasses.dataclass(frozen=True)
class RobustProbitLikelihood:
    """Outlier-robust probit (``classification/RobustProbitEstimOut.m``):
    the label flipped w.p. p_flip, so
    p(y=1|z) = p_flip + (1 − 2·p_flip)·Φ(z/√wvar); closed-form moments
    (``RobustProbitEstimOut.m:120-150``)."""

    probit: ProbitLikelihood
    p_flip: object = 0.05

    def estim(self, phat, pvar):
        p = self.p_flip
        s = 2.0 * self.probit.y - 1.0
        c_bar = phat / torch.sqrt(self.probit.wvar + pvar)
        scdf = (1.0 - 2.0 * p) * torch.special.ndtr(s * c_bar)
        C = torch.clamp(p + scdf, min=1e-30)
        part = scdf / C
        zhat_std, zvar_std = self.probit.estim(phat, pvar)
        zhat = p * phat / C + part * zhat_std
        secmom = p * (pvar + phat.abs() ** 2) / C + part * (zvar_std + zhat_std.abs() ** 2)
        return zhat, torch.clamp(secmom - zhat.abs() ** 2, min=1e-12)

    def loglike(self, phat, pvar):
        s = 2.0 * self.probit.y - 1.0
        cdf = torch.special.ndtr(s * phat / torch.sqrt(pvar + self.probit.wvar))
        return torch.log(torch.clamp(self.p_flip + (1 - 2 * self.p_flip) * cdf, min=1e-30))


@dataclasses.dataclass(frozen=True)
class RobustLogitLikelihood:
    """Outlier-robust logistic channel
    p(y|z) = p_flip + (1 − 2·p_flip)·sigmoid(scale·s·z), s = ±1
    (``classification/RobustLogitEstimOut.m:15-18``), on the 17-node rule."""

    y: torch.Tensor
    p_flip: object = 0.05
    scale: object = 1.0

    def _node_loglike(self, z):
        s = (2.0 * self.y - 1.0)[..., None]
        a = -s * _node(self.scale) * z
        sig = torch.exp(-torch.logaddexp(torch.zeros_like(a), a))
        p = _node(self.p_flip)
        return torch.log(torch.clamp(p + (1 - 2 * p) * sig, min=1e-30))

    def estim(self, phat, pvar):
        gx, glw = _rule(_GH_X, _GH_W, phat)
        z = phat[..., None] + torch.sqrt(_t(pvar, phat))[..., None] * gx
        return _quadrature_moments(z, glw + self._node_loglike(z))


def _t2_logcdf(x):
    """log F₂(x) of the Student-t (ν=2) CDF 0.5·(1 + x/√(2+x²)), in the
    cancellation-free form F = 1/(√(2+x²)·(√(2+x²) − x)), with
    √(2+x²) − x = 2/(√(2+x²) + x) for x > 0."""
    r = torch.sqrt(2.0 + x**2)
    diff = torch.where(x > 0, 2.0 / (r + x.abs()), r - x)
    return -torch.log(r) - torch.log(diff)


@dataclasses.dataclass(frozen=True)
class TDistLikelihood:
    """Robit channel p(y=1|z) = F₂(z/sigma) (``classification/TDistEstimOut.m``):
    sum-product moments on the 33-node Gauss–Hermite rule."""

    y: torch.Tensor
    sigma: object = 0.1

    def estim(self, phat, pvar):
        gx, glw = _rule(_GH33_X, _GH33_W, phat)
        z = phat[..., None] + torch.sqrt(_t(pvar, phat))[..., None] * gx
        s = (2.0 * self.y - 1.0)[..., None]
        return _quadrature_moments(z, glw + _t2_logcdf(s * z / _node(self.sigma)))

    def loglike(self, phat, pvar):
        return _t2_logcdf((2.0 * self.y - 1.0) * phat / self.sigma)


@dataclasses.dataclass(frozen=True)
class MultiLogitLikelihood:
    """Multinomial logistic channel (``classification/MultiLogitEstimOut.m``):
    z ∈ R^D per sample, p(y=d|z) = softmax(scale·z)_d.  Moments by
    self-normalized importance sampling from the prior with a fixed particle
    set: numpy's ``default_rng(seed)`` normals, the JAX package's very
    particles.  y is (…, M) integer labels, phat and pvar (…, M, D)."""

    y: torch.Tensor
    D: int = 2
    scale: object = 1.0
    n_particles: int = 128
    seed: int = 0

    def _nodes(self, ref):
        rng = np.random.default_rng(self.seed)
        eps = rng.standard_normal((self.n_particles, self.D)).astype(np.float32)
        return torch.as_tensor(eps, device=ref.device)

    def _labels(self, logits):
        """log softmax(logits) at the labels, over the last axis."""
        idx = self.y.to(torch.int64).reshape(self.y.shape + (1,) * (logits.dim() - self.y.dim()))
        idx = idx.expand(*logits.shape[:-1], 1)
        return torch.gather(logits, -1, idx)[..., 0] - torch.logsumexp(logits, -1)

    def estim(self, phat, pvar):
        eps = self._nodes(phat)  # (P, D)
        z = phat[..., None, :] + torch.sqrt(_t(pvar, phat))[..., None, :] * eps  # (…, M, P, D)
        logp = self._labels(_node(_node(self.scale)) * z)  # (…, M, P)
        w = torch.exp(logp - torch.logsumexp(logp, -1, keepdim=True))[..., None]
        zhat = (w * z).sum(-2)
        ez2 = (w * z**2).sum(-2)
        return zhat, torch.clamp(ez2 - zhat**2, min=1e-12)

    def loglike(self, phat, pvar):
        return self._labels(_node(self.scale) * phat)


@dataclasses.dataclass(frozen=True)
class LaplaceLikelihood:
    """Laplacian noise y = z + Laplace(lam), real (``main/LaplaceEstimOut.m``):
    the posterior splits at z = y into two truncated Gaussians."""

    y: torch.Tensor
    lam: object = 1.0

    def estim(self, phat, pvar):
        lam = self.lam
        pvar = _t(pvar, phat)
        sig = torch.sqrt(pvar)
        mp = phat + lam * pvar
        mm = phat - lam * pvar
        logw_p = lam * (phat - self.y) + torch.special.log_ndtr((self.y - mp) / sig)  # z ≤ y
        logw_m = lam * (self.y - phat) + torch.special.log_ndtr(-(self.y - mm) / sig)  # z ≥ y
        wmax = torch.maximum(logw_p, logw_m)
        wp, wm = torch.exp(logw_p - wmax), torch.exp(logw_m - wmax)
        pi_p = wp / (wp + wm)
        mean_p, var_p, _ = _tn_moments(mp, pvar, -math.inf, self.y)
        mean_m, var_m, _ = _tn_moments(mm, pvar, self.y, math.inf)
        zhat = pi_p * mean_p + (1 - pi_p) * mean_m
        ez2 = pi_p * (mean_p**2 + var_p) + (1 - pi_p) * (mean_m**2 + var_m)
        return zhat, torch.clamp(ez2 - zhat**2, min=1e-12)


@dataclasses.dataclass(frozen=True)
class MagnitudeLikelihood:
    """Magnitude-only channel y = |z + w|, w ~ CN(0, wvar)
    (``main/ncCAwgnEstimOut.m``, PR-GAMP's phase retrieval): the phase of
    z + w given y is von Mises with kappa = 2·y·|phat|/(pvar + wvar), so
    R = I1/I0(kappa) through the scaled ``i1e``/``i0e``."""

    y: torch.Tensor
    wvar: object

    def estim(self, phat, pvar):
        tot = pvar + self.wvar
        mag_p = phat.abs()
        direction = torch.where(mag_p > 1e-30, phat / torch.clamp(mag_p, min=1e-30), 0.0)
        kappa = 2.0 * self.y * mag_p / tot
        R = torch.special.i1e(kappa) / torch.clamp(torch.special.i0e(kappa), min=1e-30)
        g = pvar / tot
        zhat = (1.0 - g) * phat + g * self.y * R * direction
        zvar = pvar * self.wvar / tot + g**2 * self.y**2 * (1.0 - R**2)
        return zhat, torch.clamp(zvar, min=1e-12)


# -- point masses, the flat prior and the elastic-net and exponential priors ----------


@dataclasses.dataclass(frozen=True)
class DiracPrior:
    """Point mass x = x0 (``main/DiracEstimIn.m``)."""

    x0: object = 0.0

    def estim(self, rhat, rvar):
        rvar = _t(rvar, rhat)
        return self.x0 * torch.ones_like(rhat), torch.zeros(rhat.shape, dtype=rvar.dtype, device=rhat.device)

    def estim_map(self, rhat, rvar):
        return self.estim(rhat, rvar)

    def loglikey(self, rhat, rvar):
        return _gaussian_loglike(rhat - self.x0, rvar, rhat.is_complex())

    def init_moments(self):
        return self.x0, 0.0


@dataclasses.dataclass(frozen=True)
class NullPrior:
    """Non-informative (flat) prior (``main/NullEstimIn.m``): the posterior
    is the incoming message."""

    def estim(self, rhat, rvar):
        return rhat, rvar

    def estim_map(self, rhat, rvar):
        return rhat, rvar

    def init_moments(self):
        return 0.0, 1.0


@dataclasses.dataclass(frozen=True)
class ElasticNetPrior:
    """Elastic-net MAP denoiser (``main/ElasticNetEstimIn.m``), the prox of
    lam1·|x| + (lam2/2)·x²: ``soft(r, lam1·rvar)/(1 + lam2·rvar)``, real or
    complex."""

    lam1: object = 1.0
    lam2: object = 1.0

    def estim(self, rhat, rvar):
        xhat, shrunk = _soft(rhat, self.lam1 * rvar)
        shrink = 1.0 + self.lam2 * rvar
        return xhat / shrink, torch.clamp(rvar * (shrunk > 0).to(torch.float32) / shrink, min=1e-30)

    def estim_map(self, rhat, rvar):
        """Already the elastic-net prox."""
        return self.estim(rhat, rvar)

    def val_map(self, xhat):
        return -self.lam1 * xhat.abs() - 0.5 * self.lam2 * xhat.abs() ** 2

    def init_moments(self):
        return 0.0, 1.0 / (self.lam1**2 + self.lam2)


@dataclasses.dataclass(frozen=True)
class NNSoftThreshPrior:
    """Exponential prior lam·exp(−lam·x)·1{x ≥ 0}, real
    (``main/NNSoftThreshEstimIn.m``): the exact posterior, N(r − lam·rvar,
    rvar) truncated to [0, ∞)."""

    lam: object = 1.0

    def estim(self, rhat, rvar):
        xhat, xvar, _ = _tn_moments(rhat - self.lam * rvar, rvar, 0.0, math.inf)
        return xhat, xvar

    def loglikey(self, rhat, rvar):
        """log ∫ N(r; x, rvar)·lam·e^(−lam·x) dx over x ≥ 0."""
        rvar = _t(rvar, rhat)
        m = rhat - self.lam * rvar
        return _log(self.lam) + 0.5 * self.lam**2 * rvar - self.lam * rhat + torch.special.log_ndtr(m / torch.sqrt(rvar))

    def estim_map(self, rhat, rvar):
        """Max-sum branch: the prox of lam·x + 1{x ≥ 0}."""
        xhat = torch.clamp(rhat - self.lam * rvar, min=0.0)
        return xhat, rvar * (xhat > 0)

    def val_map(self, xhat):
        return _log(self.lam) - self.lam * xhat

    def init_moments(self):
        return 1.0 / self.lam, 1.0 / self.lam**2


@dataclasses.dataclass(frozen=True)
class MixPrior:
    """Two-component mixture w·p_a(x) + (1−w)·p_b(x) (``main/MixScaEstimIn.m``):
    responsibilities from each component's ``loglikey``."""

    base_a: object
    base_b: object
    w: object = 0.5

    def estim(self, rhat, rvar):
        la = self.base_a.loglikey(rhat, rvar)
        lb = self.base_b.loglikey(rhat, rvar)
        exparg = torch.clamp(lb - la + _log1p(-self.w) - _log(self.w), -_MAXARG, _MAXARG)
        ra = 1.0 / (1.0 + torch.exp(exparg))
        xa, va = self.base_a.estim(rhat, rvar)
        xb, vb = self.base_b.estim(rhat, rvar)
        xhat = ra * xa + (1 - ra) * xb
        ex2 = ra * (xa.abs() ** 2 + va) + (1 - ra) * (xb.abs() ** 2 + vb)
        return xhat, torch.clamp(ex2 - xhat.abs() ** 2, min=1e-30)

    def loglikey(self, rhat, rvar):
        la = self.base_a.loglikey(rhat, rvar)
        lb = self.base_b.loglikey(rhat, rvar)
        return torch.logaddexp(_log(self.w) + la, _log1p(-self.w) + lb)

    def init_moments(self):
        ma, va = self.base_a.init_moments()
        mb, vb = self.base_b.init_moments()
        m = self.w * ma + (1 - self.w) * mb
        ex2 = self.w * (abs(ma) ** 2 + va) + (1 - self.w) * (abs(mb) ** 2 + vb)
        return m, ex2 - abs(m) ** 2


# -- block concatenation (mean removal's augmentation) and the output wrappers --------


def _block(v, sl: slice, n: int):
    """Block ``sl`` of a variance that is per element over a last axis of
    ``n``; a number, or a tensor that broadcasts (last axis 1), stays."""
    if isinstance(v, torch.Tensor) and v.dim() and v.shape[-1] == n:
        return v[..., sl]
    return v


def _blocks(parts, sizes, method: str, a, v):
    """Each part's ``method(a_k, v_k)`` on its block of the last axis, the
    two outputs concatenated; a variance is broadcast to its block first."""
    off, outs, vars_ = 0, [], []
    n = a.shape[-1]
    for part, size in zip(parts, sizes):
        sl = slice(off, off + size)
        x, xv = getattr(part, method)(a[..., sl], _block(v, sl, n))
        outs.append(x)
        vars_.append(xv * torch.ones_like(x.real))
        off += size
    return torch.cat(outs, -1), torch.cat(vars_, -1)


def _blockwise_cost(parts, sizes, name: str, *arrays):
    """Each part's cost hook on its block; a part without the hook costs 0."""
    off, vals = 0, []
    n = arrays[0].shape[-1]
    for part, size in zip(parts, sizes):
        sl = slice(off, off + size)
        blocks = [_block(a, sl, n) for a in arrays]
        if hasattr(part, name):
            vals.append(getattr(part, name)(*blocks))
        else:
            vals.append(torch.zeros(blocks[0].shape, device=blocks[0].device))
        off += size
    return torch.cat(vals, -1)


def _broadcast_init(v, size: int) -> torch.Tensor:
    """An initial moment (a number, a 0-d tensor or (…, 1)) over a block of
    ``size`` entries of the last axis."""
    v = torch.as_tensor(v)
    v = v.reshape(1) if v.dim() == 0 else v
    return v.expand(*v.shape[:-1], size)


@dataclasses.dataclass(frozen=True)
class ConcatPrior:
    """Blockwise prior over the last axis (``main/EstimInConcat.m``): block k
    of static size ``sizes[k]`` uses ``priors[k]``."""

    priors: tuple
    sizes: tuple

    def estim(self, rhat, rvar):
        return _blocks(self.priors, self.sizes, "estim", rhat, rvar)

    def estim_map(self, rhat, rvar):
        return _blocks(self.priors, self.sizes, "estim_map", rhat, rvar)

    def val_neg_kl(self, rhat, rvar, xhat, xvar):
        """Blockwise input utility; a block whose prior has no cost hook
        (mean removal's NullPrior entries) contributes zero."""
        return _blockwise_cost(self.priors, self.sizes, "val_neg_kl", rhat, rvar, xhat, xvar)

    def init_moments(self):
        parts = [tuple(_broadcast_init(v, size) for v in prior.init_moments())
                 for prior, size in zip(self.priors, self.sizes)]
        device = next((t.device for p in parts for t in p if t.device.type != "cpu"), torch.device("cpu"))
        out = []
        for k in range(2):
            vs = [p[k].to(device) for p in parts]
            batch = torch.broadcast_shapes(*(v.shape[:-1] for v in vs))
            dtype = vs[0].dtype
            for v in vs[1:]:
                dtype = torch.promote_types(dtype, v.dtype)
            out.append(torch.cat([v.to(dtype).expand(*batch, v.shape[-1]) for v in vs], -1))
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class DiracLikelihood:
    """Noiseless observation y = z (``main/DiracEstimOut.m``)."""

    y: torch.Tensor

    def estim(self, phat, pvar):
        pvar = _t(pvar, phat)
        return self.y * torch.ones_like(phat), torch.zeros(phat.shape, dtype=pvar.dtype, device=phat.device)

    def estim_map(self, phat, pvar):
        return self.estim(phat, pvar)

    def loglike(self, phat, pvar):
        """The constraint rows of mean removal carry no data cost."""
        return torch.zeros(phat.shape, device=phat.device)

    def logscale(self, axhat, pvar, phat):
        return torch.zeros(phat.shape, device=phat.device)


@dataclasses.dataclass(frozen=True)
class MaskedLikelihood:
    """Missing data (``main/MaskedEstimOut.m``): where ``mask`` is 0 the
    posterior is the incoming message (phat, pvar), elsewhere the base
    likelihood's."""

    base: object
    mask: torch.Tensor

    def estim(self, phat, pvar):
        zb, vb = self.base.estim(phat, pvar)
        keep = self.mask.to(torch.bool)
        return torch.where(keep, zb, phat), torch.where(keep, vb, pvar)


@dataclasses.dataclass(frozen=True)
class GaussMixLikelihood:
    """Zero-mean K-component Gaussian-mixture noise y = z + w,
    w ~ Σ_k w_k·N(0, v_k) (``main/GaussMixEstimOut.m`` /
    ``CGaussMixEstimOut.m``), real or circular by the dtype of y."""

    y: torch.Tensor
    weights: torch.Tensor
    variances: torch.Tensor

    def estim(self, phat, pvar):
        r = (self.y - phat)[..., None]
        pv = _t(pvar, phat)[..., None]
        v = pv + self.variances
        if self.y.is_complex() or phat.is_complex():
            loglike = -(_LOG_PI + torch.log(v) + r.abs() ** 2 / v)
        else:
            loglike = -0.5 * (_LOG_2PI + torch.log(v) + r**2 / v)
        logw = torch.log(self.weights) + loglike
        resp = torch.exp(logw - torch.logsumexp(logw, -1, keepdim=True))
        gain = pv / v
        zk = phat[..., None] + gain * r
        vk = self.variances * gain
        zhat = (resp * zk).sum(-1)
        ez2 = (resp * (zk.abs() ** 2 + vk)).sum(-1)
        return zhat, torch.clamp(ez2 - zhat.abs() ** 2, min=1e-12)


@dataclasses.dataclass(frozen=True)
class CMultAwgnLikelihood:
    """Known per-entry complex gain y = c∘z + CN(0, wvar)
    (``main/CMultAwgnEstimOut.m``): the Gaussian product in precision form."""

    y: torch.Tensor
    c: torch.Tensor
    wvar: object

    def estim(self, phat, pvar):
        prec = 1.0 / pvar + self.c.abs() ** 2 / self.wvar
        zvar = 1.0 / prec
        return zvar * (phat / pvar + self.c.conj() * self.y / self.wvar), zvar


@dataclasses.dataclass(frozen=True)
class HingeLikelihood:
    """SVM hinge loss p(y|z) ∝ exp(−scale·max(0, 1 − s·z)), s = ±1, real:
    in u = s·z the posterior splits at u = 1 into a plain and a tilted
    truncated Gaussian, as :class:`LaplaceLikelihood`'s."""

    y: torch.Tensor
    scale: object = 1.0

    def estim(self, phat, pvar):
        s = 2.0 * self.y - 1.0
        pvar = _t(pvar, phat)
        mu = s * phat
        sig = torch.sqrt(pvar)
        c = self.scale
        mt = mu + c * pvar
        logw_flat = torch.special.log_ndtr((mu - 1.0) / sig)
        logw_tilt = c * (mu - 1.0) + 0.5 * c**2 * pvar + torch.special.log_ndtr((1.0 - mt) / sig)
        wmax = torch.maximum(logw_flat, logw_tilt)
        wf, wt = torch.exp(logw_flat - wmax), torch.exp(logw_tilt - wmax)
        pi_f = wf / (wf + wt)
        mean_f, var_f, _ = _tn_moments(mu, pvar, 1.0, math.inf)
        mean_t, var_t, _ = _tn_moments(mt, pvar, -math.inf, 1.0)
        uhat = pi_f * mean_f + (1 - pi_f) * mean_t
        eu2 = pi_f * (mean_f**2 + var_f) + (1 - pi_f) * (mean_t**2 + var_t)
        return s * uhat, torch.clamp(eu2 - uhat**2, min=1e-12)


@dataclasses.dataclass(frozen=True)
class ConcatLikelihood:
    """Blockwise likelihood over the last axis (``main/EstimOutConcat.m``)."""

    likes: tuple
    sizes: tuple

    def estim(self, phat, pvar):
        return _blocks(self.likes, self.sizes, "estim", phat, pvar)

    def estim_map(self, phat, pvar):
        return _blocks(self.likes, self.sizes, "estim_map", phat, pvar)

    def loglike(self, phat, pvar):
        return _blockwise_cost(self.likes, self.sizes, "loglike", phat, pvar)

    def logscale(self, axhat, pvar, phat):
        return _blockwise_cost(self.likes, self.sizes, "logscale", axhat, pvar, phat)


# -- specialized spike-slab and AMP-style threshold priors -----------------------------


@dataclasses.dataclass(frozen=True)
class BGZeroMeanPrior:
    """Zero-mean Bernoulli-Gaussian prior in the folded form of
    ``main/BGZeroMeanEstimIn.m:49-90`` (= SparsePrior(AwgnPrior(0, var0),
    p1)), real."""

    var0: object = 1.0
    p1: object = 0.5

    def _fold(self, rhat, rvar):
        nu = rvar * self.var0 / (self.var0 + rvar)
        gamma = nu * rhat / rvar
        exparg = torch.clamp(-0.5 * gamma**2 / nu, -_MAXARG, _MAXARG)
        alpha = 1.0 + (1.0 - self.p1) / self.p1 * torch.sqrt(self.var0 / nu) * torch.exp(exparg)
        return nu, gamma, alpha

    def estim(self, rhat, rvar):
        nu, gamma, alpha = self._fold(rhat, _t(rvar, rhat))
        xvar = gamma**2 * (alpha - 1.0) / alpha**2 + nu / alpha
        return gamma / alpha, torch.clamp(xvar, min=1e-30)

    def val_neg_kl(self, rhat, rvar, xhat, xvar):
        """Spike-slab −KL in the folded form of ``BGZeroMeanEstimIn.m:70-84``."""
        nu, gamma, alpha = self._fold(rhat, _t(rvar, rhat))
        val = 0.5 * (torch.log(nu / self.var0) + (1.0 - nu / self.var0) - gamma**2 / self.var0)
        py1 = 1.0 / alpha
        py0 = 1.0 - py1
        p1 = _clamp(self.p1, 1e-8, 1.0)
        return (py1 * val
                + py1 * torch.log(_clamp(p1, 1e-8) / torch.clamp(py1, min=1e-8))
                + py0 * torch.log(_clamp(1.0 - p1, 1e-8) / torch.clamp(py0, min=1e-8)))

    def init_moments(self):
        return 0.0, self.var0 * self.p1


@dataclasses.dataclass(frozen=True)
class EllpDMMPrior:
    """Donoho–Maleki–Montanari l_p thresholder, 0 < p ≤ 1
    (``main/EllpDMMEstimIn.m:35-52``): the threshold alpha·√mean(rvar),
    one per realization."""

    alpha: object = 1.5
    p: float = 1.0

    def estim(self, rhat, rvar):
        rvar = _t(rvar, rhat)
        thresh = self.alpha * torch.sqrt(_pmean(rvar))
        mag = torch.clamp(rhat.abs(), min=1e-30)
        shrunk = torch.clamp(mag - thresh * mag ** (self.p - 1.0), min=0.0)
        xhat = torch.where(rhat.abs() > 0, rhat / mag * shrunk, torch.zeros_like(rhat))
        active = shrunk > 0
        # the power on active entries only: mag**(p-2) overflows at the clamp,
        # and inf·0 from the mask would be NaN
        mag_safe = torch.where(active, mag, 1.0)
        xvar = rvar * (1.0 - thresh * (self.p - 1.0) * mag_safe ** (self.p - 2.0))
        return xhat, torch.clamp(xvar.real * active.to(torch.float32), min=1e-30)

    def estim_map(self, rhat, rvar):
        return self.estim(rhat, rvar)

    def init_moments(self):
        return 0.0, 1e-2


@dataclasses.dataclass(frozen=True)
class SoftThreshDMMPrior:
    """DMM soft threshold with AMP tuning and optional debiasing
    (``main/SoftThreshDMMEstimIn.m:42-68``): the threshold alpha·√mean(rvar)
    and the variance rvar·mean(active), both per realization."""

    alpha: object = 1.5
    debias: bool = False

    def estim(self, rhat, rvar):
        rvar = _t(rvar, rhat)
        thresh = self.alpha * torch.sqrt(_pmean(rvar))
        xhat, shrunk = _soft(rhat, thresh)
        active = (shrunk > 0).to(torch.float32)
        xvar = rvar * _pmean(active) * torch.ones_like(shrunk)
        if self.debias:
            on = shrunk * active
            scale = 1.0 + thresh * _psum(on) / torch.clamp(_psum(on**2), min=1e-30)
            xhat, xvar = scale * xhat, scale * xvar
        return xhat, torch.clamp(xvar, min=1e-30)

    def estim_map(self, rhat, rvar):
        return self.estim(rhat, rvar)

    def init_moments(self):
        return 0.0, 1e-2


@dataclasses.dataclass(frozen=True)
class FxnhandlePrior:
    """Black-box (plug-and-play, D-AMP) denoiser prior
    (``main/FxnhandleEstimIn.m:49-88``): ``denoise(rhat, rvar) -> xhat``, a
    torch callable; the variance is rvar·div with the divergence estimated
    per realization by Monte-Carlo sign probes and clipped to
    [div_min, div_max].  ``key`` is a ``torch.Generator``: each call draws
    the probes from a copy of its state, so the prior is a fixed function of
    its inputs, as the JAX class with its fixed key is."""

    key: torch.Generator
    denoise: object = None
    change_factor: float = 1e-1
    n_avg: int = 1
    div_min: float = 0.0
    div_max: float = 1.0 - 1e-5

    def estim(self, rhat, rvar):
        rvar = _t(rvar, rhat)
        xhat = self.denoise(rhat, rvar)
        epsilon = self.change_factor * torch.minimum(torch.sqrt(_pmean(rvar)), _pmean(rhat.abs())) + _EPS32
        g = torch.Generator(device=self.key.device)
        g.set_state(self.key.get_state())
        div = 0.0
        for _ in range(self.n_avg):
            eta = torch.sign(torch.randn(rhat.shape, generator=g, device=self.key.device)).to(rhat.device)
            x_pert = self.denoise(rhat + epsilon * eta, rvar)
            div = div + _pmean((eta * (x_pert - xhat)).real) / epsilon
        div = torch.clamp(div / self.n_avg, self.div_min, self.div_max)
        return xhat, rvar * div * torch.ones(rhat.shape, device=rhat.device)

    def estim_map(self, rhat, rvar):
        return self.estim(rhat, rvar)

    def init_moments(self):
        return 0.0, 1.0


@dataclasses.dataclass(frozen=True)
class MultiSNIPEPrior:
    """Multi-point SNIPE (``main/MultiSNIPEstim.m:42-66``): point masses at
    ``thetas`` (L,) with gravities ``omegas`` plus an infinitely broad slab;
    a finite ``xvar_big`` caps the slab's variance."""

    thetas: torch.Tensor
    omegas: object
    xvar_big: float = float("inf")

    def _d0_eterm(self, rhat, rvar):
        dterm = (rhat[..., None] - self.thetas).abs() ** 2 / _node(rvar)
        eterm = torch.exp(torch.clamp(self.omegas - dterm / 2.0, -_MAXARG, _MAXARG))
        return eterm.sum(-1) + 1.0, eterm

    def estim(self, rhat, rvar):
        rvar = _t(rvar, rhat)
        d0, eterm = self._d0_eterm(rhat, rvar)
        d1 = (eterm * self.thetas).sum(-1) + rhat
        d2 = (eterm * self.thetas.abs() ** 2).sum(-1) + rhat.abs() ** 2 + rvar
        xhat = d1 / d0
        xvar = d2 / d0 - xhat.abs() ** 2
        if math.isfinite(self.xvar_big):
            gain = 1.0 / (1.0 + rvar / self.xvar_big)
            xhat, xvar = xhat * gain, xvar * gain
        return xhat, torch.clamp(xvar.real, min=1e-30)

    def val_neg_kl(self, rhat, rvar, xhat, xvar):
        """The val output of ``MultiSNIPEstim.m:66``: the log scale plus the
        Gaussian-entropy correction."""
        rvar = _t(rvar, rhat)
        d0, _ = self._d0_eterm(rhat, rvar)
        return torch.log(d0) + 0.5 * (torch.log(2 * math.pi * rvar) + (xhat - rhat).abs() ** 2 / rvar
                                      + xvar / rvar)

    def init_moments(self):
        return 0.0, 1.0


@dataclasses.dataclass(frozen=True)
class L1Likelihood:
    """Max-sum output estimator of fout(z) = −scale·Σ|z|
    (``main/L1EstimOut.m:57-86``): the soft-threshold prox; with
    ``auto_scale`` the scale tracks 1/mean(|zhat|), one per realization, for
    ``nit_scale`` rounds."""

    scale: object = 1.0
    auto_scale: bool = False
    scale_min: float = 1e-3
    scale_max: float = 1e3
    nit_scale: int = 5

    @staticmethod
    def _prox(scale, phat, pvar):
        zhat, shrunk = _soft(phat, scale * pvar)
        return zhat, pvar * (shrunk > 0)

    def estim(self, phat, pvar):
        if not self.auto_scale:
            return self._prox(self.scale, phat, pvar)
        zhat, zvar = self._prox(_t(self.scale, phat).to(torch.float32), phat, pvar)
        for _ in range(self.nit_scale):
            scale = torch.clamp(1.0 / torch.clamp(_pmean(zhat.abs()), min=1e-30), self.scale_min, self.scale_max)
            zhat, zvar = self._prox(scale, phat, pvar)
        return zhat, zvar

    def estim_map(self, phat, pvar):
        return self.estim(phat, pvar)

    def loglike(self, phat, pvar):
        return -self.scale * phat.abs()


@dataclasses.dataclass(frozen=True)
class NLLikelihood:
    """Nonlinear AWGN channel y = f(z) + N(0, wvar) (``main/NLEstimOut.m:41-118``):
    moments on an ``n_z``-point grid over z ~ N(phat, pvar), broadcast over
    all measurements at once.  ``out_fn`` is an elementwise torch callable."""

    y: torch.Tensor
    wvar: object = 1e-2
    out_fn: object = None
    n_z: int = 100

    def _grid(self, phat, pvar):
        umax = math.sqrt(2.0 * math.log(self.n_z / 2.0))
        u = torch.linspace(-umax, umax, self.n_z, dtype=phat.real.dtype, device=phat.device)
        z = phat[..., None] + torch.sqrt(_t(pvar, phat))[..., None] * u
        logpyu = -((self.y[..., None] - self.out_fn(z)) ** 2) / (2.0 * _node(self.wvar))
        return u, logpyu

    def estim(self, phat, pvar):
        u, logpyu = self._grid(phat, pvar)
        logpuy = logpyu - u**2 / 2.0
        puy = torch.exp(logpuy - torch.logsumexp(logpuy, -1, keepdim=True))
        umean = (puy * u).sum(-1)
        uvar = (puy * (u - umean[..., None]) ** 2).sum(-1)
        pvar = _t(pvar, phat)
        return phat + torch.sqrt(pvar) * umean, torch.clamp(pvar * uvar, min=1e-30)

    def loglike(self, zhat, zvar):
        u, logpyu = self._grid(zhat, zvar)
        pu = torch.exp(-(u**2) / 2.0)
        return (logpyu * (pu / pu.sum())).sum(-1)
