"""State evolution for GAMP/AMP and the S-transform (counterpart of
``jstsp19_tpu/solvers/gamp_se.py``: ``EstimInAvg``, ``estim_in_avg``,
``AwgnOutAvg``, ``MCOutAvg``, ``gamp_se``, ``bg_sampler`` and
``s_transform``; the ``stateEvo/gampSE.m`` capability).

The matched (Bayes-optimal sum-product) form of the reference's recursion
(``gampSE.m:44-67``), as in the JAX package:

    taup_t = beta * taux_t
    svar̄_t = E_(p,y)[ (1 - zvar(p,y)/taup_t) / taup_t ]   (output average)
    taur_t = 1 / svar̄_t
    taux_{t+1}, mse_{t+1} = input average at taur_t          (EstimInAvg)

with A i.i.d. of unit-norm columns and beta = n/m.  An SE describes one
ensemble, so its scalars are 0-d tensors; the Monte-Carlo samples lie on
the device of the draws.  Where the JAX package takes a key, the samplers
here take a ``torch.Generator`` and draw on its device: the numbers differ
from JAX's, what they average does not, and ``EstimInAvg`` takes JAX's
own draws where a test needs them.  ``lax.scan`` becomes a Python loop.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class EstimInAvg:
    """Monte-Carlo input averaging (``stateEvo/EstimInAvg.m``): given samples
    x ~ p(x) and fixed unit noise w, returns E|x − g(x+√rvar·w; rvar)|² and
    E[xvar]."""

    prior: object
    x: torch.Tensor
    w: torch.Tensor

    def avg(self, rvar):
        rvar = torch.as_tensor(rvar, dtype=torch.float32, device=self.x.device)
        rhat = self.x + torch.sqrt(rvar) * self.w
        xhat, xvar = self.prior.estim(rhat, rvar * torch.ones_like(self.x.real))
        return ((self.x - xhat).abs() ** 2).mean(), torch.as_tensor(xvar).mean()


def estim_in_avg(prior, gen: torch.Generator, n_samp: int = 4096, sampler=None, cplx: bool = False) -> EstimInAvg:
    """An :class:`EstimInAvg` with x drawn by ``sampler(gen, n_samp)`` (the
    prior's ``sample`` method by default) and unit Gaussian noise w (circular
    complex when x is complex or ``cplx``), both from ``gen``."""
    x = (prior.sample if sampler is None else sampler)(gen, n_samp)
    if x.is_complex() or cplx:
        w = torch.randn(n_samp, generator=gen, device=gen.device, dtype=torch.complex64)
    else:
        w = torch.randn(n_samp, generator=gen, device=gen.device)
    return EstimInAvg(prior=prior, x=x, w=w)


@dataclasses.dataclass(frozen=True)
class AwgnOutAvg:
    """Closed-form output average for y = z + N(0, wvar)
    (``stateEvo/AwgnEstimOutAvg.m``): svar̄ = 1/(taup + wvar)."""

    wvar: float

    def svar_avg(self, taup, varz):
        return 1.0 / (taup + self.wvar)


@dataclasses.dataclass(frozen=True)
class MCOutAvg:
    """Monte-Carlo output average for any likelihood (the vectorized
    ``IntEstimOutAvg.m``): ``like_factory(y)`` returns an estimator with
    ``estim(phat, pvar)``; ``channel(gen, z)`` draws y ~ p(y|z).  ``key`` is
    a ``torch.Generator`` whose state every call restores first, so that each
    call draws the same samples, as the JAX class's fixed key does."""

    like_factory: object
    channel: object
    key: torch.Generator
    n_samp: int = 8192
    cplx: bool = False

    def svar_avg(self, taup, varz):
        g = torch.Generator(device=self.key.device)
        g.set_state(self.key.get_state())
        taup = torch.as_tensor(taup, dtype=torch.float32, device=g.device)
        vp = torch.clamp(torch.as_tensor(varz, dtype=torch.float32, device=g.device) - taup, min=1e-12)
        dt = torch.complex64 if self.cplx else torch.float32
        p = torch.sqrt(vp) * torch.randn(self.n_samp, generator=g, device=g.device, dtype=dt)
        d = torch.sqrt(taup) * torch.randn(self.n_samp, generator=g, device=g.device, dtype=dt)
        y = self.channel(g, p + d)
        _, zvar = self.like_factory(y).estim(p, taup * torch.ones(self.n_samp, device=g.device))
        return ((1.0 - zvar / taup) / taup).mean()


def gamp_se(in_avg: EstimInAvg, out_avg, beta: float, nit: int = 30, rvar_min: float = 1e-12) -> dict:
    """The matched SE recursion (``gampSE.m:44-67``): a dict of trajectories,
    mse and taux of length nit + 1 (entry 0 the prior's variance), taup and
    taur of length nit."""
    varz = beta * (in_avg.x.abs() ** 2).mean()
    mse0, _ = in_avg.avg(1e6)  # ≈ the prior's variance
    mse, taux = [mse0], [mse0]
    taup, taur = [], []
    for _ in range(nit):
        tp = beta * torch.clamp(taux[-1], min=rvar_min)
        svar = out_avg.svar_avg(tp, varz)
        tr = torch.clamp(1.0 / torch.clamp(torch.as_tensor(svar), min=1e-30), min=rvar_min)
        m, t = in_avg.avg(tr)
        mse.append(m)
        taux.append(t)
        taup.append(tp)
        taur.append(tr)
    return dict(mse=torch.stack(mse), taux=torch.stack(taux), taup=torch.stack(taup), taur=torch.stack(taur))


def bg_sampler(p1: float, var0: float = 1.0, cplx: bool = False) -> Callable:
    """A sampler ``(gen, n) -> x`` of Bernoulli–Gaussian
    x ~ p1·N(0, var0) + (1−p1)·δ0 (circular complex where ``cplx``)."""

    def sample(gen: torch.Generator, n: int) -> torch.Tensor:
        act = torch.rand(n, generator=gen, device=gen.device) < p1
        dt = torch.complex64 if cplx else torch.float32
        g = torch.randn(n, generator=gen, device=gen.device, dtype=dt) * var0**0.5
        return torch.where(act, g, torch.zeros((), dtype=dt, device=gen.device))

    return sample


def s_transform(y, eigs, N: int, nit: int = 60) -> torch.Tensor:
    """S-transform of an N×N Hermitian PSD matrix with eigenvalues ``eigs``
    (``main/s_transform.m``, bisection branch): for y ∈ [−R/N, 0],

        S(y) = −(y+1)/y · η⁻¹(1+y),   η(γ) = mean(1/(1+λ·γ))

    over the zero-padded spectrum (R = rank).  ``eigs`` is (R₀,) shared, or
    (…, R₀) with one spectrum per realization, lining up with y's leading
    axes (y (B, 1) against eigs (B, R₀)).  A fixed-count bisection of ``nit``
    halvings, elementwise.  S(0) = 1, S(−R/N) = inf; outside [−R/N, 0] it is
    NaN (the reference raises)."""
    return s_transform_of(eigs, N, nit)(y)


def s_transform_of(eigs, N: int, nit: int = 60) -> Callable:
    """:func:`s_transform` of one spectrum as a function of y, with the
    spectrum's statistics computed once (S-AMP evaluates it 55 times an
    iteration)."""
    lam = torch.as_tensor(eigs, dtype=torch.float32)
    lam = torch.nn.functional.pad(lam, (0, N - lam.shape[-1]))
    keep = lam.dim() > 1  # one spectrum per realization: statistics (…, 1)
    pos = lam > 0
    R = pos.sum(-1, keepdim=keep).to(torch.float32)
    lam_mean = lam.mean(-1, keepdim=keep)
    inv_mean = torch.where(pos, 1.0 / torch.where(pos, lam, 1.0), 0.0).sum(-1, keepdim=keep) / R
    lam_e = lam.unsqueeze(-2) if keep else lam  # against γ[..., None]
    rn = R / N
    one = torch.ones(1, device=lam.device)

    def S(y) -> torch.Tensor:
        y = torch.as_tensor(y, dtype=torch.float32, device=lam.device)
        interior = (y > -rn) & (y < 0)
        ys = torch.where(interior, y, -0.5 * rn)  # a safe stand-in in the masked lanes
        lo = (1.0 / (1.0 + ys) - 1.0) / lam_mean
        hi = inv_mean / (ys + rn)
        target = 1.0 + ys
        gam, eta = torch.empty_like(lo), torch.empty_like(lo)
        too_big = torch.empty(lo.shape, dtype=torch.bool, device=lo.device)
        terms = torch.empty(lo.shape + (N,), device=lo.device)
        for _ in range(nit):  # seven launches a step, into buffers made once
            torch.lerp(lo, hi, 0.5, out=gam)
            torch.mean(torch.addcmul(one, lam_e, gam[..., None], out=terms).reciprocal_(), -1, out=eta)
            torch.lt(eta, target, out=too_big)
            torch.where(too_big, lo, gam, out=lo)
            torch.where(too_big, gam, hi, out=hi)
        s = -(ys + 1.0) / ys * torch.lerp(lo, hi, 0.5)
        out = torch.where(interior, s, torch.nan)
        out = torch.where(y == 0, 1.0, out)
        return torch.where(y == -rn, torch.inf, out)

    return S
