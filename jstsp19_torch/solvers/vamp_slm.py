"""VAMP for the standard linear model and its state evolution, batched
(counterpart of ``jstsp19_tpu/solvers/vamp_slm.py``: ``vamp_slm``,
``vamp_slm_se`` and ``amp_se``; ``VAMP/VampSlmEst.m``, ``VAMP/VampSlmSE.m``
and ``stateEvo/gampSE.m``).

``vamp_slm`` runs one problem per realization: y carries the batch as its
leading dimensions, the operator is shared or one per realization, and every
scalar of the recursion (γ1, α, the keep-best step) is one per realization,
shaped like y's batch followed by ones over the operator's input axes
((B, 1, 1) on a ``KronDictOp``).  The state evolutions describe one
ensemble, so their scalars are 0-d tensors; their Monte-Carlo draws come
from a ``torch.Generator`` seeded with ``seed`` on the device where they run,
or are given (``draws``) so that two runs can share them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from jstsp19_torch.core import prng
from jstsp19_torch.core.config import resolve_device

GAM_MIN = 1e-11
GAM_MAX = 1e11
MSG_CAP = 1e6  # the divergence guard's message cap


class VampSlmResult(NamedTuple):
    x: torch.Tensor
    gam1: torch.Tensor
    mse_track: torch.Tensor  # (..., nit): E[xvar1] per realization and iteration
    r1: torch.Tensor  # the final denoiser-input message (for EM wrappers)


def vamp_slm(prior, y, op, gamw, nit: int = 50, damp: float = 0.9) -> VampSlmResult:
    """VAMP-SLM for y = op·x + CN(0, 1/gamw) with the LMMSE stage in the
    operator's input-Gram eigenbasis.

    ``op`` provides ``gram_in_eig``/``to_eigbasis``/``from_eigbasis`` and
    ``rmv`` (``KronDictOp``: its one ``rmv``, of y, goes through the
    ``dict_correlation`` kernel on the card); ``gamw`` is the noise precision,
    a number or one per realization.  Keep-best tracking as in the JAX
    package: the mean iteration can destabilize after settling, so the
    iterate with the smallest relative step is returned unless one more
    denoise of the last message is at least as settled.
    """
    Va, Vb, d = op.gram_in_eig()
    Ahy = op.rmv(y)
    Ahy_t = op.to_eigbasis(Va, Vb, Ahy)
    k = len(op.in_shape)
    dims = tuple(range(-k, 0))
    col = Ahy.shape[:-k] + (1,) * k
    dev, rdt = y.device, y.real.dtype
    tiny = torch.finfo(rdt).tiny

    def mean(v):
        return torch.as_tensor(v, device=dev).expand(Ahy.shape).mean(dims, keepdim=True)

    def rel_step(x, x_prev):
        return ((x - x_prev).abs() ** 2).sum(dims, keepdim=True) / torch.clamp(
            (x.abs() ** 2).sum(dims, keepdim=True), min=tiny)

    r1 = torch.zeros(Ahy.shape, dtype=y.dtype, device=dev)
    gam1 = torch.full(col, GAM_MIN, dtype=torch.float32, device=dev)
    x_prev = best_x = best_r1 = r1
    best_gam1 = gam1
    best_rc = torch.full(col, torch.inf, dtype=torch.float32, device=dev)
    mse = []
    for i in range(nit):
        x1, xvar1 = prior.estim(r1, 1.0 / gam1)
        mse.append(mean(xvar1))
        eta1 = 1.0 / torch.clamp(mse[-1], min=1e-30)
        gam2 = torch.maximum(eta1 - gam1, 1e-3 * eta1).clamp(max=GAM_MAX)
        r2 = (x1 * eta1 - r1 * gam1) / gam2
        # LMMSE: (gamw·AᴴA + gam2·I)⁻¹(gamw·Aᴴy + gam2·r2)
        rhs_t = gamw * Ahy_t + gam2 * op.to_eigbasis(Va, Vb, r2)
        x2 = op.from_eigbasis(Va, Vb, rhs_t / (gamw * d + gam2))
        alpha = torch.clamp(mean(gam2 / (gamw * d + gam2)), 1e-6, 1.0 - 1e-6)
        r1n = (x2 - alpha * r2) / (1.0 - alpha)
        gam1n = torch.clamp(gam2 * (1.0 - alpha) / alpha, GAM_MIN, GAM_MAX)
        r1n = damp * r1n + (1 - damp) * r1
        gam1n = damp * gam1n + (1 - damp) * gam1
        # divergence guard: rescale runaway messages in float32
        mx = r1n.abs().amax(dims, keepdim=True)
        r1n = r1n * torch.where(mx > MSG_CAP, MSG_CAP / mx, 1.0)
        # i == 0 seeds the best slot (otherwise nit = 1 would return the zero start)
        rc = torch.full(col, torch.inf, dtype=torch.float32, device=dev) if i == 0 else rel_step(x1, x_prev).float()
        better = torch.ones(col, dtype=torch.bool, device=dev) if i == 0 else rc < best_rc
        best_x = torch.where(better, x1, best_x)
        best_r1 = torch.where(better, r1, best_r1)
        best_gam1 = torch.where(better, gam1, best_gam1)
        best_rc = torch.minimum(rc, best_rc)
        r1, gam1, x_prev = r1n, gam1n, x1
    # the final candidate, one more denoise of the last message: it wins
    # unless the tail diverged
    x_f, _ = prior.estim(r1, 1.0 / gam1)
    take_f = rel_step(x_f, x_prev) <= best_rc
    return VampSlmResult(
        x=torch.where(take_f, x_f, best_x),
        gam1=torch.where(take_f, gam1, best_gam1),
        mse_track=torch.stack(mse, -1).reshape(col[:-k] + (nit,)),
        r1=torch.where(take_f, r1, best_r1),
    )


def _se_draws(prior_sampler, n_samples: int, seed: int, device):
    """x⁰ ~ the prior (``prior_sampler(gen, n)``) and unit CN noise, drawn in
    that order from one generator seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x0 = prior_sampler(gen, n_samples)
    return x0, prng.complex_normal(gen, (n_samples,), var=1.0)


def vamp_slm_se(prior_sampler, prior, d_spectrum, gamw, nit: int = 50, n_samples: int = 4096, seed: int = 0,
                draws=None) -> torch.Tensor:
    """State evolution of VAMP-SLM: the predicted denoiser MSE per iteration,
    (nit,), to hold against :func:`vamp_slm`'s ``mse_track`` (the
    ``VampSlmSE.m`` overlay).  ``prior_sampler(gen, n)`` draws x⁰;
    ``d_spectrum`` holds the eigenvalues of AᴴA (zeros included) and sets the
    device; ``draws`` = (x⁰, w) replaces the draws."""
    d = torch.as_tensor(d_spectrum)
    x0, w = draws if draws is not None else _se_draws(prior_sampler, n_samples, seed, d.device)
    gam1 = torch.tensor(GAM_MIN, dtype=torch.float32, device=d.device)
    mses = []
    for _ in range(nit):
        xhat, _ = prior.estim(x0 + w / torch.sqrt(gam1), 1.0 / gam1)
        mse1 = torch.clamp(((xhat - x0).abs() ** 2).mean(), min=1e-30)
        mses.append(mse1)
        eta1 = 1.0 / mse1
        gam2 = torch.clamp(torch.maximum(eta1 - gam1, 1e-3 * eta1), max=GAM_MAX)
        alpha = torch.clamp((gam2 / (gamw * d + gam2)).mean(), 1e-6, 1.0 - 1e-6)
        gam1 = torch.clamp(gam2 * (1.0 - alpha) / alpha, GAM_MIN, GAM_MAX)
    return torch.stack(mses)


def amp_se(prior_sampler, prior, delta: float, wvar, nit: int = 50, n_samples: int = 8192, seed: int = 0,
           device=None, draws=None) -> torch.Tensor:
    """State evolution of AMP for an i.i.d. operator of unit-norm columns and
    an AWGN output (the ``stateEvo/gampSE.m`` capability),

        τ²_{t+1} = wvar + (1/δ)·E|η(X + τ_t·Z) − X|²,

    the predicted denoiser MSE per iteration, (nit,).  Draws on ``device``
    (the card unless named), or takes ``draws`` = (x⁰, w)."""
    x0, w = draws if draws is not None else _se_draws(prior_sampler, n_samples, seed, resolve_device(device))
    tau2 = wvar + (x0.abs() ** 2).mean() / delta
    mses = []
    for _ in range(nit):
        xhat, _ = prior.estim(x0 + w * torch.sqrt(torch.as_tensor(tau2)), tau2)
        mses.append(((xhat - x0).abs() ** 2).mean())
        tau2 = wvar + mses[-1] / delta
    return torch.stack(mses)
