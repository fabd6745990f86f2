"""Generalized AMP, FISTA, AMP, SURE-AMP and the full ``ampEst.m`` loop,
batched (counterpart of ``jstsp19_tpu/solvers/gamp.py``: ``GampResult``,
``gamp``, ``fista``, ``amp``, ``sure_amp`` and ``amp_est``).

The lean fixed-iteration GAMP recursion of ``gampEst.m`` (forward variance →
output posterior → Onsager-corrected residual → backward variance → input
posterior) with constant or adaptive step damping; the estimator modules of
:mod:`jstsp19_torch.solvers.estim` play the EstimIn/EstimOut roles and any
:class:`jstsp19_torch.ops.base.LinOp` with its ``sq_mv``/``sq_rmv`` variance
pair the LinTrans role.  Where the JAX package solves one problem per call,
here the observation carries a leading batch dimension, (B, m), and every
per-problem scalar of the recursion (the step, the cost, the threshold,
the Lipschitz constant, AMP's variances) is one per realization, kept as a
(B, 1) tensor.  ``lax.scan`` and ``fori_loop`` become Python loops with no
host sync.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from jstsp19_torch.solvers.sparse import soft_threshold


class GampResult(NamedTuple):
    x: torch.Tensor
    xvar: torch.Tensor
    rhat: torch.Tensor
    rvar: torch.Tensor


def _is_complex(v) -> bool:
    return v.is_complex() if isinstance(v, torch.Tensor) else isinstance(v, complex)


def _state_dtype(x0, yref) -> torch.dtype:
    """complex64 iff the prior's initial moment or the observation is
    complex; fully real problems keep a float32 state."""
    if _is_complex(x0) or (yref is not None and _is_complex(yref)):
        return torch.complex64
    return torch.float32


def _observation(like):
    """The likelihood's observed data, which carries the batch, the device
    and the dtype: ``y``, or a quantizer's ``lo``, found through the
    wrappers (``base``, ``probit``, a concatenation's first block); None
    for a likelihood with no data (``L1Likelihood``)."""
    for name in ("y", "lo"):
        if isinstance(getattr(like, name, None), torch.Tensor):
            return getattr(like, name)
    for name in ("base", "probit"):
        if getattr(like, name, None) is not None:
            return _observation(getattr(like, name))
    likes = getattr(like, "likes", None)
    return _observation(likes[0]) if likes else None


def _full(v, shape, dtype, device) -> torch.Tensor:
    """A number or a tensor (e.g. (B, 1)) broadcast to ``shape`` as a new
    tensor."""
    return torch.as_tensor(v, device=device).to(dtype).expand(shape).clone()


def _mean(v: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis, one per realization, kept as (..., 1)."""
    return v.mean(-1, keepdim=True)


def _size(shape) -> int:
    out = 1
    for s in shape:
        out *= s
    return out


def gamp(prior, likelihood, op, nit: int = 50, step: float = 0.9, var_floor: float = 1e-12,
         dtype=None, x_init=None, adaptive: bool = False) -> GampResult:
    """Sum-product GAMP for ``y ~ p(y | op.mv(x))``, batched over the
    leading dimensions of the likelihood's observation (``y``, found through
    a wrapper such as ``RobustProbitLikelihood``'s ``probit``).

    Constant step damping on (xhat, shat), or with ``adaptive`` the step
    acceptance of ``gampEst.m`` in scan form: a candidate is accepted only
    if the output residual does not grow; a rejection reverts that
    realization's state and halves its step, an acceptance grows it.
    """
    y = _observation(likelihood)
    batch, dev = tuple(y.shape[:-1]), y.device
    x0, v0 = prior.init_moments()
    xdtype = dtype if dtype is not None else _state_dtype(x0, y)
    n_shape, m_shape = batch + tuple(op.in_shape), batch + tuple(op.out_shape)
    xhat = _full(x0 if x_init is None else x_init, n_shape, xdtype, dev)
    xvar = _full(v0, n_shape, torch.float32, dev)
    shat = torch.zeros(m_shape, dtype=xdtype, device=dev)
    rhat, rvar = xhat, torch.ones_like(xvar)

    def iterate(xhat, xvar, shat, stp):
        # output linear stage
        zvar = torch.clamp(op.sq_mv(xvar), min=var_floor)
        phat = op.mv(xhat) - zvar * shat
        # output nonlinear stage
        z0, zvar0 = likelihood.estim(phat, zvar)
        shat_new = (z0 - phat) / zvar
        svar = torch.clamp((1.0 - zvar0 / zvar) / zvar, min=var_floor)
        shat_new = stp * shat_new + (1 - stp) * shat
        # input linear stage
        rvar = 1.0 / torch.clamp(op.sq_rmv(svar), min=var_floor)
        rhat = xhat + rvar * op.rmv(shat_new)
        # input nonlinear stage
        xhat_new, xvar_new = prior.estim(rhat, rvar)
        xhat_new = stp * xhat_new + (1 - stp) * xhat
        return xhat_new, torch.clamp(xvar_new, min=var_floor), shat_new, rhat, rvar, z0

    if not adaptive:
        for _ in range(nit):
            xhat, xvar, shat, rhat, rvar, _ = iterate(xhat, xvar, shat, step)
        return GampResult(x=xhat, xvar=xvar, rhat=rhat, rvar=rvar)

    STEP_MIN, STEP_MAX, INCR, DECR = 0.05, 1.0, 1.1, 0.5
    stp = torch.full(batch + (1,), step, dtype=torch.float32, device=dev)
    cost_prev = torch.full(batch + (1,), torch.inf, dtype=torch.float32, device=dev)
    state = (xhat, xvar, shat, rhat, rvar)
    for _ in range(nit):
        xh, xv, sh, rh, rv, z0 = iterate(*state[:3], stp)
        # the unnormalized output residual: dividing by zvar would penalize
        # the growing confidence of good iterates and reject them
        cost = _mean((z0 - op.mv(xh)).abs() ** 2)
        accept = cost <= cost_prev
        state = tuple(torch.where(accept, new, old) for new, old in zip((xh, xv, sh, rh, rv), state))
        stp = torch.where(accept, torch.clamp(stp * INCR, max=STEP_MAX), torch.clamp(stp * DECR, min=STEP_MIN))
        cost_prev = torch.where(accept, cost, cost_prev)
    xhat, xvar, shat, rhat, rvar = state
    return GampResult(x=xhat, xvar=xvar, rhat=rhat, rvar=rvar)


def fista(y, op, lam, nit: int = 100, lipschitz=None) -> torch.Tensor:
    """FISTA for ``min ½‖y − op.mv(x)‖² + λ‖x‖₁`` (complex soft threshold),
    the ``fistaEst.m`` capability, batched over y's leading dimensions.
    ``lipschitz`` defaults to a 20-step power-iteration estimate of ‖AᴴA‖,
    one per realization."""
    batch, dev = tuple(y.shape[:-1]), y.device
    n_shape = batch + tuple(op.in_shape)
    if lipschitz is None:
        v = torch.ones(n_shape, dtype=torch.complex64, device=dev)
        for _ in range(20):
            w = op.rmv(op.mv(v))
            v = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1, keepdim=True), min=1e-20)
        w = op.rmv(op.mv(v))
        lipschitz = (v.conj() * w).sum(-1, keepdim=True).real / torch.clamp(
            (v.conj() * v).sum(-1, keepdim=True).real, min=1e-20)
    L = torch.clamp(torch.as_tensor(lipschitz), min=1e-12)
    x = torch.zeros(n_shape, dtype=torch.complex64, device=dev)
    z = x
    t = torch.tensor(1.0, dtype=torch.float32)  # float32, as the JAX carry
    for _ in range(nit):
        grad = op.rmv(op.mv(z) - y)
        x_new = soft_threshold(z - grad / L, lam / L)
        t_new = (1.0 + torch.sqrt(1.0 + 4.0 * t**2)) / 2.0
        z = x_new + ((t - 1.0) / t_new).item() * (x_new - x)
        x, t = x_new, t_new
    return x


def amp(y, op, prior, nit: int = 50) -> torch.Tensor:
    """Plain AMP with the Onsager correction (the ``ampEst.m`` capability)
    for ``y = op.mv(x) + w`` with an i.i.d.-subgaussian operator of
    unit-norm columns; the scalar variance state is one per realization."""
    batch, dev = tuple(y.shape[:-1]), y.device
    delta = _size(op.out_shape) / _size(op.in_shape)
    x = torch.zeros(batch + tuple(op.in_shape), dtype=_state_dtype(prior.init_moments()[0], y), device=dev)
    z = y
    for _ in range(nit):
        tau2 = _mean(z.abs() ** 2)
        r = x + op.rmv(z)
        x, xvar = prior.estim(r, tau2 / delta)
        onsager = _mean(xvar) / (tau2 / delta) / delta
        z = y - op.mv(x) + z * onsager
    return x


def _sure_soft(r, v, tau_grid):
    """SURE of the (complex-aware) soft threshold over a grid of thresholds,
    one grid per realization: Stein's unbiased estimate of E‖η_τ(r) − x‖²
    given r = x + noise of variance v.  r (B, n), v (B, 1), tau_grid (B, G)
    → (B, G).  Complex entries count two real dimensions."""
    m = r.abs()[..., :, None]
    t = tau_grid[..., None, :]
    resid2 = torch.minimum(m, t) ** 2
    alive = (m > t).to(torch.float32)
    if r.is_complex():
        div = alive * (2.0 - t / torch.clamp(m, min=1e-30))
    else:
        div = alive * 2.0
    return resid2.sum(-2) + v * (div.sum(-2) - r.shape[-1])


def sure_amp(y, op, nit: int = 50, n_grid: int = 32) -> torch.Tensor:
    """AMP with a per-iteration SURE-optimal soft threshold (the
    ``SURE_BAMP`` capability): each iteration takes the threshold that
    minimizes Stein's unbiased risk estimate over a quantile grid of |r|,
    one per realization."""
    batch, dev = tuple(y.shape[:-1]), y.device
    delta = _size(op.out_shape) / _size(op.in_shape)
    x = torch.zeros(batch + tuple(op.in_shape), dtype=torch.complex64 if y.is_complex() else torch.float32,
                    device=dev)
    z = y
    qs = torch.linspace(0.0, 1.0, n_grid, device=dev)
    for _ in range(nit):
        tau2 = _mean(z.abs() ** 2)
        v = tau2 / delta
        r = x + op.rmv(z)
        mag = r.abs()
        grid = torch.quantile(mag, qs, dim=-1).movedim(0, -1)
        sure = _sure_soft(r, v, grid)
        tau = torch.gather(grid, -1, sure.argmin(-1, keepdim=True))
        shrunk = torch.clamp(mag - tau, min=0.0)
        x = torch.where(mag > 0, r / torch.clamp(mag, min=1e-30) * shrunk, 0.0)
        # empirical divergence for the Onsager term
        alive = (mag > tau).to(torch.float32)
        if y.is_complex():
            df = _mean(alive * (1.0 - 0.5 * tau / torch.clamp(mag, min=1e-30)))
        else:
            df = _mean(alive)
        z = y - op.mv(x) + z * df / delta
    return x


def _median(v: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, kept as (..., 1): the mean of the two
    middle values of an even count, as ``jnp.median`` (``torch.median``
    takes the lower one)."""
    s, n = v.sort(-1).values, v.shape[-1]
    mid = s[..., n // 2:n // 2 + 1]
    return mid if n % 2 else 0.5 * (s[..., n // 2 - 1:n // 2] + mid)


def amp_est(y, op, prior, nit: int = 50, rvar_method: str = "mean", wvar=None, evals_aah=None,
            rvar_min: float = 1e-12, bisect_iters: int = 50, damp: float = 1.0) -> torch.Tensor:
    """The full ``ampEst.m`` main loop (``ampEst.m:180-290``), both variance
    branches, batched over y's leading dimensions (y (B, m)):

    * **standard AMP**: Onsager gain ``(n/m)·xvar/rvar``; the denoiser-input
      variance by ``rvar_method``, ``'mean'`` (the corrected residual's
      power), ``'median'`` (the robust MAD estimate of ``ampEst.m:236-241``,
      √(2/log4)·median|v̂| for a complex state) or ``'wvar'`` (the oracle
      ``wvar + (n/m)·xvar``, needs ``wvar``);
    * **S-AMP** (``evals_aah``, the spectrum of A·Aᴴ, (R,) shared or (B, R)):
      Onsager gain ``1 − 1/S(−xvar/rvar)`` and rvar the fixed point of
      ``rvar = wvar·S(−xvar/rvar)`` by bisection (``ampEst.m:221-268``), S
      the :func:`~jstsp19_torch.solvers.gamp_se.s_transform` of the
      spectrum.  Needs ``wvar``.

    The first iteration always takes the residual's power
    (``ampEst.m:229-231``).  ``wvar`` is a number or (B, 1); every scalar of
    the recursion is one per realization, (B, 1).  Assumes unit-norm
    columns; ``damp`` (1.0 as the reference) damps the corrected residual.
    Returns the final estimate x (B, n).
    """
    from jstsp19_torch.solvers.gamp_se import s_transform_of

    batch, dev = tuple(y.shape[:-len(op.out_shape)]), y.device
    M, N = _size(op.out_shape), _size(op.in_shape)
    delta = M / N
    x0, xvar0 = prior.init_moments()
    xdtype = _state_dtype(x0, y)
    col = batch + (1,) * len(op.in_shape)
    x = _full(x0, batch + tuple(op.in_shape), xdtype, dev)
    in_dims = tuple(range(-len(op.in_shape), 0))
    out_dims = tuple(range(-len(op.out_shape), 0))

    def power(v):
        return (v.abs() ** 2).mean(out_dims, keepdim=True)

    if evals_aah is not None:
        ev = torch.as_tensor(evals_aah, dtype=torch.float32, device=dev)
        # S's open domain is (−R/N, 0), R = rank(A·Aᴴ), smaller than (−M/N, 0)
        # for a rank-deficient spectrum: clamp to the actual edge
        rn = (ev > 0).sum(-1, keepdim=ev.dim() > 1) / N
        lo_edge = -torch.clamp(torch.clamp(rn, max=delta) - 1e-3, min=1e-6)
        hi_edge = torch.full_like(lo_edge, -1e-9)
        S = s_transform_of(ev, N)

        def S_of(div):
            return S(torch.clamp(div, lo_edge, hi_edge))

        def rvar_bisect(xvar):
            # rvar = wvar·S(−xvar/rvar), monotone in rvar: bisection; the
            # bracket's top grows ×100 up to 4 times until its error is >= 0
            lo = torch.clamp(xvar / delta, min=rvar_min)

            def err(r):
                return r - wvar * S_of(-xvar / r)

            hi = lo * 100.0
            for _ in range(4):
                hi = torch.where(err(hi) < 0, hi * 100.0, hi)
            for _ in range(bisect_iters):
                mid = 0.5 * (lo + hi)
                up = err(mid) > 0
                lo, hi = torch.where(up, lo, mid), torch.where(up, mid, hi)
            return 0.5 * (lo + hi)

    vhat = torch.zeros(batch + tuple(op.out_shape), dtype=xdtype, device=dev)
    rvar = torch.ones(col, dtype=torch.float32, device=dev)
    xvar = _full(torch.as_tensor(xvar0).real.float().mean(), col, torch.float32, dev)
    for it in range(nit):
        div = xvar / rvar
        gain = 1.0 - 1.0 / S_of(-div) if evals_aah is not None else div / delta
        vhat = damp * ((y - op.mv(x)) + gain * vhat) + (1.0 - damp) * vhat
        if it == 0:  # the first iteration always takes the residual's power
            rvar = power(vhat)
        elif evals_aah is not None:
            rvar = rvar_bisect(xvar)
        elif rvar_method == "median":
            med = _median(vhat.abs().flatten(-len(op.out_shape))).reshape(col)
            rvar = (math.sqrt(2.0 / math.log(4.0)) * med) ** 2 if xdtype.is_complex else (med / 0.6745) ** 2
        elif rvar_method == "wvar":
            rvar = wvar + xvar / delta
        else:  # 'mean'
            rvar = power(vhat)
        rvar = torch.clamp(torch.as_tensor(rvar, dtype=torch.float32, device=dev), min=rvar_min)
        x, Xvar = prior.estim(x + op.rmv(vhat), rvar)
        xvar = torch.as_tensor(Xvar, device=dev).real.expand(x.shape).mean(in_dims, keepdim=True)
    return x
