"""EM hyperparameter learning around message-passing solvers, batched
(counterpart of ``jstsp19_tpu/solvers/em.py``: ``EmGmResult``,
``em_bg_vamp``, ``EmGmFullResult``, ``_gm_responsibilities``,
``_gm_em_update``, ``em_gm_vamp``, ``EmNNGMResult``, ``_nngm_em_update`` and
``em_nngm_gamp``; the reference's ``EMGMAMP`` family,
``MPbased_solvers/EMGMAMP/EMGMAMP.m``, Vila & Schniter).

The inner solver is VAMP-SLM (``em_nngm_gamp``: sum-product GAMP); each EM
round re-fits

  - the Bernoulli–(G)M prior (activity, component weights/means/variances)
    from the component responsibilities at the final denoiser input, and
  - the noise variance from the residual energy,

then re-runs the solver.  All updates are closed-form moment matching.

y carries a batch of realizations as its leading dimensions.  Where JAX
reduces over its one problem (``mean(py1)``, the sums over all
non-component axes, ``mean|y|²`` and the noise update), the port reduces per
realization over the operator's axes, so the learned hyperparameters carry
one value each: ``noise_var`` and ``p1`` (B, 1, …) against the coefficients
(or, for GAMP's likelihood, the measurements), a mixture's weights, means and
variances (B, 1, …, n_components) with a trailing component axis.  ``rho0``
stays a number computed from the shapes, as in JAX.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from jstsp19_torch.solvers.estim import (CAwgnLikelihood, CAwgnPrior, CGMPrior, NNGMPrior, SparsePrior, _clamp, _log,
                                         _log1p, _tn_moments)
from jstsp19_torch.solvers.gamp import gamp
from jstsp19_torch.solvers.turbo import _batch, _in_dims
from jstsp19_torch.solvers.vamp_slm import vamp_slm

_LOG_PI = math.log(math.pi)
_LOG_2PI = math.log(2 * math.pi)


def _per_realization_mean(v: torch.Tensor, batch, k: int) -> torch.Tensor:
    """The mean of each realization's elements, shaped (B, 1, …) with k ones."""
    return v.reshape(batch + (-1,)).mean(-1).reshape(batch + (1,) * k)


def _rho0(op) -> float:
    """The initial activity from the sampling ratio (EMGMAMP's recipe)."""
    return min(0.5, max(0.05, math.prod(op.out_shape) / math.prod(op.in_shape) / 2))


class EmGmResult(NamedTuple):
    x: torch.Tensor
    prior: SparsePrior
    noise_var: torch.Tensor


def _bernoulli_gauss_em_update(prior: SparsePrior, r1, rvar, dims):
    """One EM round for the Bernoulli–Gaussian prior: refresh activity and
    slab variance from posterior activity probabilities (the
    ``SparseScaEstim`` autoTune rule, ``SparseScaEstim.m:120-139``), each
    over one realization's ``dims``."""
    base = prior.base
    loglike1 = base.loglikey(r1, rvar)
    loglike0 = -(_LOG_PI + torch.log(rvar) + r1.abs() ** 2 / rvar)
    exparg = torch.clamp(loglike0 - loglike1 + _log1p(-prior.p1) - _log(prior.p1), -500, 500)
    py1 = 1.0 / (1.0 + torch.exp(exparg))
    p1_new = torch.clamp(py1.mean(dims, keepdim=True), 1e-4, 1.0 - 1e-4)
    xhat1, xvar1 = base.estim(r1, rvar)
    denom = torch.clamp(py1.sum(dims, keepdim=True), min=1e-12)
    var_new = torch.clamp((py1 * (xhat1.abs() ** 2 + xvar1)).sum(dims, keepdim=True) / denom, min=1e-8)
    return SparsePrior(CAwgnPrior(base.mean0, var_new), p1_new)


def _noise_update(y, op, xhat, xvar, batch, k: int):
    """EM AWGN update: E|y − Ax|² = |y − A·xhat|² + the A-propagated
    posterior variance (EMGMAMP's update; dropping the variance term biases
    the noise variance low and over-sharpens the learned prior), mirrored
    from the JAX package as written, one per realization."""
    resid = y - op.mv(xhat)
    nv = _per_realization_mean(resid.abs() ** 2, batch, k) + _per_realization_mean(op.sq_mv(xvar), batch, k)
    return torch.clamp(nv, min=1e-10)


def _vamp_init(y, op):
    """(batch, k, dims, |y|² mean, rho0): the per-realization setting of the
    VAMP-based EM loops; the noise variance starts from a 100:1 input-SNR
    assumption, the activity from the sampling ratio."""
    batch, k = _batch(y, op), len(op.in_shape)
    y_energy = _per_realization_mean(y.abs() ** 2, batch, k).float()
    return batch, k, _in_dims(op), y_energy, _rho0(op)


def em_bg_vamp(y, op, n_em: int = 8, nit: int = 30) -> EmGmResult:
    """EM-learned Bernoulli–Gaussian VAMP (the EM-BG-AMP capability).

    Initialization follows the EMGMAMP recipe: noise variance from a 100:1
    input-SNR assumption, activity from the operator's sampling ratio.
    """
    batch, k, dims, y_energy, rho0 = _vamp_init(y, op)
    N, M = math.prod(op.in_shape), math.prod(op.out_shape)
    noise_var = y_energy / 101.0
    prior = SparsePrior(CAwgnPrior(0.0, y_energy * N / M / rho0), rho0)
    for _ in range(n_em):
        res = vamp_slm(prior, y, op, gamw=1.0 / noise_var, nit=nit)
        rvar = 1.0 / res.gam1
        prior = _bernoulli_gauss_em_update(prior, res.r1, rvar, dims)
        xhat, xvar = prior.estim(res.r1, rvar)
        noise_var = _noise_update(y, op, xhat, xvar, batch, k)
    res = vamp_slm(prior, y, op, gamw=1.0 / noise_var, nit=nit)
    return EmGmResult(x=res.x, prior=prior, noise_var=noise_var)


class EmGmFullResult(NamedTuple):
    x: torch.Tensor
    prior: SparsePrior  # SparsePrior(CGMPrior, p1)
    noise_var: torch.Tensor


def _gm_responsibilities(prior: SparsePrior, r, rvar):
    """Posterior activity py1 (spike vs slab) and per-component slab
    responsibilities + posterior moments for a spike + complex-GM prior —
    the sufficient statistics of the EM-GM-AMP M-step
    (``EMGMAMP/EMGMAMP.m``, Vila & Schniter eqs. (19)-(25))."""
    gm = prior.base
    rr = r[..., None]
    rv = rvar[..., None] if rvar.dim() else rvar
    v = gm.variances + rv
    loglike = -(_LOG_PI + torch.log(v) + (rr - gm.means).abs() ** 2 / v)
    logw = torch.log(gm.weights) + loglike
    log_slab = torch.logsumexp(logw, -1)
    resp = torch.exp(logw - log_slab[..., None])
    log_spike = -(_LOG_PI + torch.log(rvar) + r.abs() ** 2 / rvar)
    exparg = torch.clamp(log_spike - log_slab + _log1p(-prior.p1) - _log(prior.p1), -500, 500)
    py1 = 1.0 / (1.0 + torch.exp(exparg))
    gain = gm.variances / v
    gamma = gain * (rr - gm.means) + gm.means  # per-component posterior mean
    nu = gain * rv  # per-component posterior variance
    return py1, resp, gamma, nu


def _mixture_m_step(py1, resp, mean_k, second, dims):
    """The moment-matching M-step both mixtures share: the joint
    responsibility of (active, component k), reduced over each
    realization's ``dims`` (JAX: over all non-component axes of its one
    problem), to (weights, means, variances) shaped (B, 1, …, n_components)
    and the activity p1 (B, 1, …).  ``second(means)`` is each element's
    per-component second moment about the new means."""
    w = py1[..., None] * resp
    red = tuple(d - 1 for d in dims)  # the same axes, left of the component axis
    mass_k = torch.clamp(w.sum(red, keepdim=True), min=1e-12)
    weights = mass_k / torch.clamp(py1.sum(dims, keepdim=True)[..., None], min=1e-12)
    means = (w * mean_k).sum(red, keepdim=True) / mass_k
    variances = torch.clamp((w * second(means)).sum(red, keepdim=True) / mass_k, min=1e-10)
    p1 = torch.clamp(py1.mean(dims, keepdim=True), 1e-4, 1.0 - 1e-4)
    weights = torch.clamp(weights, min=1e-8)
    return weights / weights.sum(-1, keepdim=True), means, variances, p1


def _gm_em_update(prior: SparsePrior, r, rvar, dims):
    py1, resp, gamma, nu = _gm_responsibilities(prior, r, rvar)
    weights, means, variances, p1 = _mixture_m_step(py1, resp, gamma, lambda mu: (gamma - mu).abs() ** 2 + nu,
                                                    dims)
    return SparsePrior(CGMPrior(weights, means, variances), p1)


def em_gm_vamp(y, op, n_components: int = 3, n_em: int = 10, nit: int = 30) -> EmGmFullResult:
    """EM-learned spike + Gaussian-mixture prior VAMP — the full
    ``EMGMAMP`` capability (``MPbased_solvers/EMGMAMP/EMGMAMP.m``): the
    mixture weights, means, variances, activity rate and noise variance are
    all learned from the data by closed-form EM rounds around the inner
    solver, per realization; nothing is hand-tuned.

    Initialization follows the EMGMAMP recipe: noise from a 100:1 SNR
    assumption, activity from the sampling ratio, zero-mean components with
    geometrically spread variances normalized to the signal energy.
    """
    batch, k, dims, y_energy, rho0 = _vamp_init(y, op)
    N, M = math.prod(op.in_shape), math.prod(op.out_shape)
    dev = y.device
    noise_var = y_energy / 101.0
    sig_var = y_energy * N / M / rho0
    spread = 2.0 ** torch.arange(n_components, dtype=torch.float32, device=dev)
    prior = SparsePrior(CGMPrior(torch.full((n_components,), 1.0 / n_components, device=dev),
                                 torch.zeros((n_components,), dtype=torch.complex64, device=dev),
                                 sig_var[..., None] * spread / spread.mean()), rho0)
    for _ in range(n_em):
        res = vamp_slm(prior, y, op, gamw=1.0 / noise_var, nit=nit)
        rvar = 1.0 / res.gam1
        prior = _gm_em_update(prior, res.r1, rvar, dims)
        xhat, xvar = prior.estim(res.r1, rvar)
        # the noise update includes the A-propagated variance (61e4a2f), as
        # the JAX package has it
        noise_var = _noise_update(y, op, xhat, xvar, batch, k)
    res = vamp_slm(prior, y, op, gamw=1.0 / noise_var, nit=nit)
    return EmGmFullResult(x=res.x, prior=prior, noise_var=noise_var)


class EmNNGMResult(NamedTuple):
    x: torch.Tensor
    prior: NNGMPrior
    noise_var: torch.Tensor


def _nngm_em_update(prior: NNGMPrior, r, rvar, dims):
    """EM round for the non-negative spike + truncated-GM prior — the
    moment-matching M-step of ``EMNNAMP`` (Vila & Schniter, EM-NN-AMP):
    responsibilities and truncated-normal posterior moments per component,
    reduced over each realization's ``dims``."""
    gm = prior
    rr = r[..., None]
    rv = rvar[..., None] if rvar.dim() else rvar
    v = gm.variances + rv
    gain = gm.variances / v
    m = gain * (rr - gm.means) + gm.means
    s = gain * rv * torch.ones_like(m)
    mean_k, var_k, logZ_k = _tn_moments(m, s, 0.0, math.inf)
    log_ev = (-0.5 * (_LOG_2PI + torch.log(v) + (rr - gm.means) ** 2 / v) + logZ_k
              - torch.special.log_ndtr(gm.means / torch.sqrt(gm.variances)))
    logw = torch.log(gm.weights) + log_ev
    log_slab = torch.logsumexp(logw, -1)
    resp = torch.exp(logw - log_slab[..., None])
    log_spike = -0.5 * (_LOG_2PI + torch.log(rvar) + r**2 / rvar)
    exparg = torch.clamp(log_spike - log_slab + _log1p(-_clamp(prior.p1, hi=1 - 1e-12)) - _log(prior.p1), -500, 500)
    py1 = 1.0 / (1.0 + torch.exp(exparg))
    weights, means, variances, p1 = _mixture_m_step(py1, resp, mean_k, lambda mu: (mean_k - mu) ** 2 + var_k,
                                                    dims)
    return NNGMPrior(weights, means, variances, p1)


def em_nngm_gamp(y, op, n_components: int = 3, n_em: int = 10, nit: int = 40) -> EmNNGMResult:
    """EM non-negative GM AMP — the ``EMNNAMP`` capability
    (``MPbased_solvers/EMNNAMP/EMNNAMP.m``): real non-negative sparse
    recovery with all prior hyperparameters plus the noise variance learned
    by EM around sum-product GAMP with the truncated-GM prior, per
    realization.  The noise variance is (B, 1, …) against the measurements,
    as GAMP's likelihood takes it."""
    batch, k_out = _batch(y, op), len(op.out_shape)
    N, M = math.prod(op.in_shape), math.prod(op.out_shape)
    dev = y.device
    y_energy = _per_realization_mean(y**2, batch, k_out)
    noise_var = y_energy / 101.0
    rho0 = _rho0(op)
    # per-realization scalars against the coefficients, then the component axis
    sig_ex2 = (y_energy * N / M / rho0).reshape(batch + (1,) * len(op.in_shape) + (1,))
    # spread component means over [0, ~2·rms] with matched variances
    ks = torch.arange(1, n_components + 1, dtype=torch.float32, device=dev)
    means = torch.sqrt(sig_ex2) * ks / torch.sqrt((ks**2).mean())
    prior = NNGMPrior(torch.full((n_components,), 1.0 / n_components, device=dev), means,
                      (sig_ex2 / n_components).expand(means.shape), rho0)
    dims = _in_dims(op)
    for _ in range(n_em):
        res = gamp(prior, CAwgnLikelihood(y, noise_var), op, nit=nit, dtype=torch.float32)
        prior = _nngm_em_update(prior, res.rhat, res.rvar, dims)
        xhat, xvar = prior.estim(res.rhat, res.rvar)
        # includes the propagated posterior variance (see em_bg_vamp)
        noise_var = _noise_update(y, op, xhat, xvar, batch, k_out)
    res = gamp(prior, CAwgnLikelihood(y, noise_var), op, nit=nit, dtype=torch.float32)
    return EmNNGMResult(x=res.x, prior=prior, noise_var=noise_var)
