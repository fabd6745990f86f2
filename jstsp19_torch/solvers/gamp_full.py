"""Full-capability GAMP core, batched (counterpart of
``jstsp19_tpu/solvers/gamp_full.py``: ``GampOptions``, ``GampState``,
``GampEstFin``, ``gamp_est`` and its helpers; the ``gampEst.m:386-630`` loop
with the options of ``main/GampOpt.m``).

Capabilities, as in the JAX package: per-element variances (the
``uniform_variance`` option wraps the operator in
:class:`~jstsp19_torch.ops.structured.UnifVarOp`); mean removal
(``remove_mean``: the exact augmented operator of
:func:`~jstsp19_torch.ops.structured.demean_rc` with the NullPrior and
DiracLikelihood blocks of ``LinTransDemeanRC.m:222-240``); the adaptive step with its
acceptance window, in the expected-log-likelihood or the Bethe form; max-sum
mode; pvar/rvar damping, variance normalization, the stepMax backoff after
repeated failures, Barzilai–Borwein steps; per-iteration noise-variance
tuning; tol/stepTol freezing and a custom ``stop_fn``; histories; the
automatic xvar0; and the exact warm start through ``state_in`` (the NaN
anchors of ``gampEst.m:418-426,584-605`` are kept literally, which is what
makes it exact).

Batched: x is (B, n) and y (B, m), and every scalar of the carry (``it``,
``stopped``, ``step``, ``step_max``, ``val``, ``val_in``, ``fail_count``,
``scale_fac``) is one per realization, kept as (B, 1) so that it broadcasts
against the vectors; the acceptance window is (B, step_window + 1).  The
JAX function solves one problem per call: B = 1 runs the same recursion.
The scan is a Python loop that stops early once every realization is
frozen (the frozen carry would not change), unless histories are kept.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

from jstsp19_torch.ops.structured import UnifVarOp, demean_rc
from jstsp19_torch.solvers.estim import ConcatLikelihood, ConcatPrior, DiracLikelihood, NullPrior
from jstsp19_torch.solvers.gamp import _full, _observation, _state_dtype

_EPS = float(torch.finfo(torch.float32).eps)


@dataclasses.dataclass(frozen=True)
class GampOptions:
    """Solver options, field for field ``main/GampOpt.m`` in snake case,
    with the reference's defaults."""

    nit: int = 200
    step: float = 1.0
    step_min: float = 0.0
    step_max: float = 1.0
    step_incr: float = 1.1
    step_decr: float = 0.5
    step_window: int = 20
    step_tol: float = 1e-10
    adapt_step: bool = True
    adapt_step_bethe: bool = False
    bb_step: bool = False
    max_bad_steps: float = float("inf")
    max_step_decr: float = 0.8
    tol: float = 1e-4
    pvar_step: bool = True
    rvar_step: bool = False
    var_norm: bool = False
    pvar_min: float = 1e-12
    rvar_min: float = 1e-12
    zvar_to_pvar_max: float = float("inf")
    remove_mean: bool = False
    uniform_variance: bool = False
    max_sum: bool = False
    tune_wvar: bool = False
    save_hist: bool = False
    # decimated histories: keep iterations hist_intvl, 2·hist_intvl, …
    hist_intvl: int = 1
    # xvar0 from a good point estimate x_init by the estimInvert fixed point
    xvar0auto: bool = False
    # custom stopping criterion (GampOpt.stopFcn/stopFcn2): a callable
    # state -> bool tensor broadcastable to (B, 1); True freezes that
    # realization.  The stopFcn arguments (val, xhat, xhatPrev, Axhat) are
    # the state's val/xhat_final/xhat_prev_final/axhat_final.
    stop_fn: Optional[object] = None


class GampState(NamedTuple):
    """The complete carry: every field the warm start needs
    (``gampEst.m:632-636,701-728``)."""

    it: torch.Tensor
    stopped: torch.Tensor
    # current iterates
    xhat: torch.Tensor
    xvar: torch.Tensor
    shat: torch.Tensor
    svar: torch.Tensor
    rhat: torch.Tensor
    rvar: torch.Tensor
    zhat: torch.Tensor
    zvar: torch.Tensor
    # last output-stage targets (persist across failed steps)
    shat_new: torch.Tensor
    svar_new: torch.Tensor
    # damping anchors from the last passed iteration
    xhat_opt: torch.Tensor
    xhat_damp: torch.Tensor
    xhat_damp_opt: torch.Tensor
    shat_opt: torch.Tensor
    svar_opt: torch.Tensor
    pvar_opt: torch.Tensor
    rvar_opt: torch.Tensor
    a2xvar_opt: torch.Tensor
    # exports from the last passed iteration
    xhat_final: torch.Tensor
    xvar_final: torch.Tensor
    xhat_prev_final: torch.Tensor
    rhat_final: torch.Tensor
    rvar_final: torch.Tensor
    phat_final: torch.Tensor
    pvar_final: torch.Tensor
    zhat_final: torch.Tensor
    zvar_final: torch.Tensor
    shat_final: torch.Tensor
    svar_final: torch.Tensor
    axhat_final: torch.Tensor
    # adaptive-step machinery
    step: torch.Tensor
    step_max: torch.Tensor
    fail_count: torch.Tensor
    val: torch.Tensor
    val_in: torch.Tensor
    val_window: torch.Tensor
    scale_fac: torch.Tensor
    # the likelihood, carried for noise-variance tuning
    likelihood: object


class GampEstFin(NamedTuple):
    """The user-facing results (``estFin`` of ``gampEst.m:701-729``), in
    the original coordinates when mean removal is on; val, step and nit are
    (B,)."""

    xhat: torch.Tensor
    xvar: torch.Tensor
    rhat: torch.Tensor
    rvar: torch.Tensor
    phat: torch.Tensor
    pvar: torch.Tensor
    zhat: torch.Tensor
    zvar: torch.Tensor
    shat: torch.Tensor
    svar: torch.Tensor
    axhat: torch.Tensor
    val: torch.Tensor
    step: torch.Tensor
    nit: torch.Tensor


def _batch_device(likelihood, x_init):
    """(batch, device) of a solve: the observation's leading axes, or
    x_init's where the likelihood holds no data."""
    ref = _observation(likelihood)
    if ref is None:
        if not isinstance(x_init, torch.Tensor):
            raise ValueError("gamp_est takes the batch from the likelihood's observation; this likelihood has "
                             "none, so pass x_init as a (batch, n) tensor")
        ref = x_init
    return tuple(ref.shape[:-1]), ref.device


def augment_problem(prior, likelihood, op, opts: GampOptions, x_init=None):
    """The removeMean and uniformVariance augmentations of
    ``gampEst.m:262-289``: mean removal builds the (m+2)×(n+2) demeaned
    operator, one per realization of the solve's batch, and pads the
    estimators with a NullPrior (inputs) and a zero-observation
    DiracLikelihood (outputs)."""
    if opts.remove_mean:
        (n,), (m,) = op.in_shape, op.out_shape
        batch, dev = _batch_device(likelihood, x_init)
        op = demean_rc(op, batch, dev)
        prior = ConcatPrior(priors=(prior, NullPrior()), sizes=(n, 2))
        likelihood = ConcatLikelihood(
            likes=(likelihood, DiracLikelihood(y=torch.zeros(batch + (2,), device=dev))), sizes=(m, 2))
        if opts.uniform_variance:
            op = UnifVarOp(op, in_avg=n, out_avg=m)
    elif opts.uniform_variance:
        op = UnifVarOp(op)
    return prior, likelihood, op


def _tuned(like):
    """The likelihood whose noise variance ``tune_wvar`` tunes: mean
    removal's first block (its constraint rows have nothing to tune)."""
    return like.likes[0] if isinstance(like, ConcatLikelihood) else like


def _retuned(like, base):
    """``like`` with its tuned likelihood replaced by ``base``."""
    if isinstance(like, ConcatLikelihood):
        return dataclasses.replace(like, likes=(base,) + like.likes[1:])
    return base


def _init_state(prior, likelihood, op, opts, x_init, xvar_init, cplx, batch, dev, rdt=torch.float32) -> GampState:
    (n,), (m,) = op.in_shape, op.out_shape
    x0, v0 = prior.init_moments()
    xdtype = _complex_of(rdt) if cplx else rdt
    xhat = _full(x0 if x_init is None else x_init, batch + (n,), xdtype, dev)
    xvar = _full(v0 if xvar_init is None else xvar_init, batch + (n,), rdt, dev)

    def nan(size, dtype=rdt):
        return torch.full(batch + (size,), torch.nan, dtype=dtype, device=dev)

    def scalar(v, dtype=rdt):
        return torch.full(batch + (1,), v, dtype=dtype, device=dev)

    zeros_m = torch.zeros(batch + (m,), dtype=xdtype, device=dev)
    # +inf fill: an unpopulated slot never wins the min, so the acceptance
    # test val >= min(window) is live as soon as one value is recorded
    window = torch.full(batch + (max(opts.step_window, 0) + 1,), torch.inf, dtype=rdt, device=dev)
    return GampState(
        it=scalar(0, torch.int32), stopped=scalar(False, torch.bool),
        xhat=xhat, xvar=xvar, shat=zeros_m, svar=nan(m), rhat=nan(n, xdtype), rvar=nan(n),
        zhat=nan(m, xdtype), zvar=nan(m), shat_new=zeros_m, svar_new=nan(m),
        xhat_opt=xhat, xhat_damp=nan(n, xdtype), xhat_damp_opt=nan(n, xdtype), shat_opt=zeros_m,
        svar_opt=nan(m), pvar_opt=nan(m), rvar_opt=nan(n), a2xvar_opt=nan(m),
        xhat_final=nan(n, xdtype), xvar_final=nan(n), xhat_prev_final=nan(n, xdtype),
        rhat_final=nan(n, xdtype), rvar_final=nan(n), phat_final=nan(m, xdtype), pvar_final=nan(m),
        zhat_final=nan(m, xdtype), zvar_final=nan(m), shat_final=zeros_m, svar_final=nan(m),
        axhat_final=nan(m, xdtype),
        step=scalar(opts.step), step_max=scalar(opts.step_max), fail_count=scalar(0, torch.int32),
        val=scalar(torch.nan), val_in=scalar(0.0), val_window=window, scale_fac=scalar(1.0),
        likelihood=likelihood,
    )


def _complex_of(rdt):
    return torch.complex128 if rdt == torch.float64 else torch.complex64


def _nanfix(anchor, fresh):
    """``if any(isnan(anchor)), anchor = fresh``, elementwise: the
    reference's lazy first-iteration initialization."""
    return torch.where(torch.isnan(anchor), fresh, anchor)


def _sum(v: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Sum over the last axis as ``dtype``, one per realization, (..., 1)."""
    return v.sum(-1, keepdim=True).to(dtype)


def _gamp_iteration(prior, op, st: GampState, opts: GampOptions, column_norms):
    """One pass of the loop body: the new (frozen where ``stopped``) state and
    this iteration's history entries."""
    adapt, max_sum, rdt = opts.adapt_step, opts.max_sum, st.val.dtype

    def val_out_fn(like, axhat, pvar, phat):
        if not adapt or not hasattr(like, "logscale" if opts.adapt_step_bethe else "loglike"):
            # a likelihood without a cost leaves the valIn-only criterion
            return torch.zeros_like(st.val)
        if opts.adapt_step_bethe:
            return _sum(like.logscale(axhat, pvar, phat), rdt)
        if max_sum:
            # the max-sum utility is the point log-likelihood at Axhat
            return _sum(like.loglike(axhat, torch.zeros_like(pvar)), rdt)
        return _sum(like.loglike(axhat, pvar), rdt)

    def val_in_fn(rhat, rvar, xhat, xvar):
        if not adapt:
            return torch.zeros_like(st.val)
        if max_sum:
            return _sum(prior.val_map(xhat).real, rdt) if hasattr(prior, "val_map") else torch.zeros_like(st.val)
        if hasattr(prior, "val_neg_kl"):
            return _sum(prior.val_neg_kl(rhat, rvar, xhat, xvar).real, rdt)
        return torch.zeros_like(st.val)

    like = st.likelihood
    # ---- output linear stage (gampEst.m:404-433) ----
    a2xvar = op.sq_mv(st.xvar)
    pvar = a2xvar
    axhat = op.mv(st.xhat)
    if opts.pvar_step:
        pvar = (1.0 - st.step) * _nanfix(st.pvar_opt, pvar) + st.step * pvar
        a2xvar = (1.0 - st.step) * _nanfix(st.a2xvar_opt, a2xvar) + st.step * a2xvar
    phat = axhat - (a2xvar / st.scale_fac) * st.shat
    pvar_robust = torch.clamp(pvar, min=opts.pvar_min)

    # ---- utility and pass test (gampEst.m:437-455) ----
    val = val_out_fn(like, axhat, pvar, phat) + st.val_in
    val_min = st.val_window.amin(-1, keepdim=True)
    passed = (st.it == 0) | (st.step <= opts.step_min) | (val >= val_min) | ~torch.isfinite(val_min)
    if not adapt:
        passed = torch.ones_like(passed)

    def sel(new, old):
        return torch.where(passed, new, old)

    # noise-variance tuning on pass (CAwgnEstimOut.m ML tuning); the utility
    # is evaluated again under the tuned likelihood, so the window compares
    # values under one noise level
    if opts.tune_wvar:
        base = _tuned(like)
        m0 = base.y.shape[-1]
        wvar = sel(base.tune_wvar_ml(phat[..., :m0], pvar_robust[..., :m0]), base.wvar)
        like = _retuned(like, dataclasses.replace(base, wvar=wvar))
        val = val_out_fn(like, axhat, pvar, phat) + st.val_in

    a2xvar_opt = sel(a2xvar, st.a2xvar_opt)
    pvar_opt = sel(pvar, st.pvar_opt)
    shat_opt = sel(st.shat, st.shat_opt)
    svar_opt = sel(st.svar, st.svar_opt)
    rvar_opt = sel(st.rvar, st.rvar_opt)
    xhat_damp_opt = sel(st.xhat_damp, st.xhat_damp_opt)
    xhat_opt = sel(st.xhat, st.xhat_opt)
    # a NaN utility (a forced pass) records +inf, which never constrains
    # later acceptances
    rolled = torch.cat([st.val_window[..., 1:], torch.where(torch.isnan(val), torch.inf, val)], dim=-1)
    val_window = sel(rolled, st.val_window)
    xhat_prev_final = sel(st.xhat_final, st.xhat_prev_final)
    xhat_final = sel(st.xhat, st.xhat_final)
    xvar_final = sel(st.xvar, st.xvar_final)
    rhat_final = sel(st.rhat, st.rhat_final)
    rvar_final = sel(st.rvar * st.scale_fac, st.rvar_final)
    phat_final = sel(phat, st.phat_final)
    pvar_final = sel(pvar, st.pvar_final)
    zhat_final = sel(st.zhat, st.zhat_final)
    zvar_final = sel(st.zvar, st.zvar_final)
    shat_final = sel(st.shat / st.scale_fac, st.shat_final)
    svar_final = sel(st.svar / st.scale_fac, st.svar_final)
    axhat_final = sel(axhat, st.axhat_final)

    # convergence (gampEst.m:496-498)
    dx = torch.linalg.vector_norm(xhat_prev_final - xhat_final, dim=-1, keepdim=True)
    nx = torch.linalg.vector_norm(xhat_final, dim=-1, keepdim=True)
    resid = torch.where(nx > 0, dx / nx, torch.inf)
    conv = passed & (st.it > 0) & (resid < opts.tol) if opts.tol > 0 else torch.zeros_like(passed)
    conv = conv & ~torch.isnan(xhat_prev_final).any(-1, keepdim=True)

    # variance normalization (gampEst.m:515-519)
    scale_fac = torch.where(passed, pvar_robust.mean(-1, keepdim=True), st.scale_fac) if opts.var_norm \
        else st.scale_fac

    # ---- output nonlinear stage (gampEst.m:521-524) ----
    zhat_cand, zvar_cand = (like.estim_map if max_sum else like.estim)(phat, pvar_robust)
    shat_cand = (scale_fac / pvar_robust) * (zhat_cand - phat)
    svar_cand = (scale_fac / pvar_robust) * (
        1.0 - torch.clamp(zvar_cand / pvar_robust, max=opts.zvar_to_pvar_max))
    zhat = sel(zhat_cand, st.zhat)
    zvar = sel(zvar_cand, st.zvar)
    shat_new = sel(shat_cand, st.shat_new)
    svar_new = sel(svar_cand, st.svar_new)

    # ---- step update (gampEst.m:526-557) ----
    step_pass = st.step
    if opts.bb_step:
        s_bb = xhat_opt - xhat_damp_opt
        num = ((s_bb * column_norms).abs() ** 2).sum(-1, keepdim=True)
        den = torch.clamp((op.mv(s_bb).abs() ** 2).sum(-1, keepdim=True), min=1e-30)
        step_bb = num / den
        step_pass = torch.where((st.it > 2) & ~torch.isnan(step_bb), step_bb, step_pass)
    fail_count = torch.where(passed, st.fail_count, st.fail_count + 1)
    backoff = ~passed & (fail_count > opts.max_bad_steps)
    fail_count = torch.where(backoff, 0, fail_count)
    step_max = torch.where(backoff, torch.clamp(opts.max_step_decr * st.step_max, min=opts.step_min),
                           st.step_max)
    step = torch.where(
        passed,
        torch.minimum(opts.step_incr * torch.clamp(step_pass, min=opts.step_min), step_max),
        torch.minimum(torch.clamp(opts.step_decr * st.step, min=opts.step_min), step_max),
    )
    if opts.step_tol > 0:
        stopped = conv | (~passed & (step < opts.step_tol))
    else:
        stopped = conv

    # ---- damping (gampEst.m:583-606) ----
    svar_opt_d = _nanfix(svar_opt, svar_new)
    xhat_damp_opt_d = _nanfix(xhat_damp_opt, xhat_opt)
    shat = (1.0 - step) * shat_opt + step * shat_new
    svar = (1.0 - step) * svar_opt_d + step * svar_new
    svar = torch.where(svar.abs() < _EPS, _EPS, svar)
    xhat_damp = (1.0 - step) * xhat_damp_opt_d + step * xhat_opt
    rvar = 1.0 / op.sq_rmv(svar)
    if opts.rvar_step:
        rvar = (1.0 - step) * _nanfix(rvar_opt, rvar) + step * rvar

    # ---- input stages (gampEst.m:608-627) ----
    rhat = xhat_damp + rvar * op.rmv(shat)
    rvar_robust = torch.clamp(rvar, min=opts.rvar_min)
    xhat, xvar = (prior.estim_map if max_sum else prior.estim)(rhat, rvar_robust * scale_fac)
    xvar = xvar.real
    val_in = val_in_fn(rhat, rvar_robust * scale_fac, xhat, xvar)

    new = GampState(
        it=st.it + 1, stopped=st.stopped | stopped,
        xhat=xhat, xvar=xvar, shat=shat, svar=svar, rhat=rhat, rvar=rvar, zhat=zhat, zvar=zvar,
        shat_new=shat_new, svar_new=svar_new, xhat_opt=xhat_opt, xhat_damp=xhat_damp,
        xhat_damp_opt=xhat_damp_opt_d, shat_opt=shat_opt, svar_opt=svar_opt_d, pvar_opt=pvar_opt,
        rvar_opt=rvar_opt, a2xvar_opt=a2xvar_opt, xhat_final=xhat_final, xvar_final=xvar_final,
        xhat_prev_final=xhat_prev_final, rhat_final=rhat_final, rvar_final=rvar_final,
        phat_final=phat_final, pvar_final=pvar_final, zhat_final=zhat_final, zvar_final=zvar_final,
        shat_final=shat_final, svar_final=svar_final, axhat_final=axhat_final,
        step=step, step_max=step_max, fail_count=fail_count, val=val, val_in=val_in,
        val_window=val_window, scale_fac=scale_fac, likelihood=like,
    )
    out = _freeze(st, new)
    hist = dict(val=val, step=out.step, passed=passed & ~st.stopped, resid=resid, stopped=st.stopped,
                xhat=out.xhat_final, xvar=out.xvar_final, rhat=out.rhat_final, rvar=out.rvar_final,
                phat=out.phat_final, pvar=out.pvar_final, zhat=out.zhat_final, zvar=out.zvar_final,
                shat=out.shat_final, svar=out.svar_final)
    return out, hist


def _freeze(st: GampState, new: GampState) -> GampState:
    """Keep ``st`` where it had stopped (the fixed-shape analog of the
    reference's while-loop exit), ``new`` elsewhere."""
    fields = {f: torch.where(st.stopped, getattr(st, f), getattr(new, f))
              for f in GampState._fields if f != "likelihood"}
    like = new.likelihood
    base, old = _tuned(like), _tuned(st.likelihood)
    wvar = getattr(base, "wvar", None)
    if isinstance(wvar, torch.Tensor) and wvar is not old.wvar:
        like = _retuned(like, dataclasses.replace(base, wvar=torch.where(st.stopped, old.wvar, wvar)))
    return GampState(**fields, likelihood=like)


def _gamp_loop(prior, op, state: GampState, opts: GampOptions, column_norms):
    """``opts.nit`` iterations; the histories stacked along a leading axis."""
    hists = []
    for _ in range(opts.nit):
        if opts.stop_fn is not None:
            state = state._replace(stopped=state.stopped | opts.stop_fn(state))
        if not opts.save_hist and bool(state.stopped.all()):
            break
        state, h = _gamp_iteration(prior, op, state, opts, column_norms)
        if opts.save_hist:
            hists.append(h)
    hist: Dict[str, torch.Tensor] = {}
    if hists:
        hist = {k: torch.stack([h[k].squeeze(-1) if h[k].shape[-1:] == (1,) else h[k] for h in hists])
                for k in hists[0]}
    return state, hist


def _estim_invert(mod, target, var, iters: int = 50, stepsize: float = 0.25):
    """``phat`` with ``mod.estim(phat, var)[0] ≈ target`` by a damped
    fixed-point iteration (``main/estimInvert.m:10``, stepsize 0.25)."""
    ph = target
    for _ in range(iters):
        zh, _ = mod.estim(ph, var)
        ph = ph + stepsize * (target - zh)
    zh, zv = mod.estim(ph, var)
    return ph, zh, zv


def _xvar0_auto(prior, likelihood, op, xhat0, opts, iters: int = 20):
    """Automatic xvar0 from a point estimate (``gampEst.m:292-330``): the
    fixed point of GAMP's variance propagation with the means pinned at
    ``xhat0`` through the inverted estimators, one per realization."""
    eps = 1e-20
    ax = op.mv(xhat0)
    xvar0 = torch.clamp((xhat0.abs() ** 2).mean(-1, keepdim=True), min=1e-12).to(xhat0.real.dtype)
    xvar = xvar0.expand(xhat0.shape)
    for _ in range(iters):
        pvar = torch.clamp(op.sq_mv(xvar), min=opts.pvar_min)
        _, _, zvar = _estim_invert(likelihood, ax, pvar)
        svar = (1.0 - zvar / pvar) / pvar
        svar = torch.where(svar.abs() < eps, eps, svar)
        rvar = torch.clamp(1.0 / torch.clamp(op.sq_rmv(svar), min=eps), min=opts.rvar_min)
        _, _, xvar_new = _estim_invert(prior, xhat0, rvar)
        xvar = xvar_new.real.expand(xvar.shape)
    return xvar


def gamp_est(prior, likelihood, op, opts: Optional[GampOptions] = None, state_in: Optional[GampState] = None,
             x_init=None, xvar_init=None):
    """Run the full GAMP loop on a batch of problems; returns
    ``(estfin, state, hist)``.

    The likelihood's observation (``y``) is (B, m), and sets the batch and
    the device (``x_init`` does for a likelihood with none); the prior's
    parameters, ``x_init`` and
    ``xvar_init`` broadcast against (B, n).  ``state_in`` (a previous
    call's ``state``) warm-starts exactly: ``nit=a`` then ``nit=b`` from
    its state equals one ``nit=a+b`` run.  The state is float32 (complex64)
    as JAX's, float64 (complex128) where the observation, or else
    ``x_init``, is.  ``hist`` is empty unless
    ``save_hist``; then it holds one (nit, B, …) tensor per key (val, step,
    passed, resid, stopped and the exported iterates), decimated by
    ``hist_intvl``.  With ``remove_mean``, ``estfin`` is in the original
    coordinates (``gampEst.m:663-684``) while ``state`` and ``hist`` stay in
    the augmented ones, so that the state can be fed back.
    """
    opts = opts or GampOptions()
    cplx = _state_dtype(prior.init_moments()[0], _observation(likelihood)) == torch.complex64 or (
        isinstance(x_init, torch.Tensor) and x_init.is_complex())
    batch, dev = _batch_device(likelihood, x_init)
    wide = [v for v in (_observation(likelihood), x_init) if isinstance(v, torch.Tensor)]
    rdt = torch.float64 if wide and wide[0].dtype in (torch.float64, torch.complex128) else torch.float32
    xdtype = _complex_of(rdt) if cplx else rdt
    if opts.xvar0auto and state_in is None and x_init is not None and xvar_init is None:
        x0 = _full(x_init, batch + tuple(op.in_shape), xdtype, dev)
        xvar_init = _xvar0_auto(prior, likelihood, op, x0, opts)
    prior_a, like_a, op_a = augment_problem(prior, likelihood, op, opts, x_init)
    if state_in is not None:
        state = state_in
    elif opts.remove_mean:
        # the two augmented entries start at the exact expansion of the
        # (user's or the prior's) initial state (gampEst.m:271-272), not at
        # the NullPrior's placeholder moments
        state = _init_state(prior_a, like_a, op_a, opts, None, None, cplx, batch, dev, rdt)
        dm = op_a.base if opts.uniform_variance else op_a
        n = op.in_shape[0]
        x_base = state.xhat[..., :n] if x_init is None else _full(x_init, batch + (n,), xdtype, dev)
        v_base = state.xvar[..., :n] if xvar_init is None else _full(xvar_init, batch + (n,), rdt, dev)
        x_exp = dm.expand_xhat(x_base).to(xdtype)
        state = state._replace(xhat=x_exp, xhat_opt=x_exp, xvar=dm.expand_xvar(v_base))
    else:
        state = _init_state(prior_a, like_a, op_a, opts, x_init, xvar_init, cplx, batch, dev, rdt)
    if opts.bb_step:
        column_norms = torch.sqrt(op_a.sq_rmv(torch.ones(batch + tuple(op_a.out_shape), device=dev)))
    else:
        column_norms = None
    state, hist = _gamp_loop(prior_a, op_a, state, opts, column_norms)

    def contract(v):
        return v[..., :-2] if opts.remove_mean else v

    estfin = GampEstFin(
        *(contract(getattr(state, f + "_final")) for f in GampEstFin._fields[:11]),
        val=state.val.squeeze(-1), step=state.step.squeeze(-1), nit=state.it.squeeze(-1),
    )
    if opts.hist_intvl > 1:
        k = opts.hist_intvl
        hist = {key: v[k - 1::k] for key, v in hist.items()}
    return estfin, state, hist
