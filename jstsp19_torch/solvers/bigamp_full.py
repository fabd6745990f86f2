"""Full BiG-AMP: per-element variances, adaptive step, X2 variant, Lite
(counterpart of ``jstsp19_tpu/solvers/bigamp_full.py``).

* :func:`bigamp_pev` — the Parker–Schniter recursion of
  ``BiGAMP/BiGAMP.m:370-830`` with per-element variances, masked
  observations, arbitrary elementwise likelihoods, the adaptive step with the
  moving-window acceptance test, pvar damping, gain modes, and the optional
  known linear branch ``Z = A·X + A2·X2`` of ``BiGAMP/BiGAMP_X2.m``.
* :func:`bigamp_lite` — ``BiGAMP/BiGAMP_Lite.m:110-520``: AWGN output and
  i.i.d. zero-mean Gaussian priors with scalar variances, every input stage a
  closed-form gain.

Batched as the rest of the port: Y (B, L, M) = A (B, L, R) · X (B, R, M)
plus noise, a mask of Y's shape or one (L, M) mask for all.  Every quantity
JAX reduces over its one problem is reduced per realization here (shaped
(B, 1, 1) beside the matrices, (B,) for the cost and the pass test), and
the adaptive step is decided per realization: one realization's rejected
step leaves the others' steps alone.  The JAX ``lax.scan`` is a Python
loop with the same carry.  The real dtype is the input's (complex128 runs
in float64 throughout).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from jstsp19_torch.core import prng


@dataclasses.dataclass(frozen=True)
class BigAmpOptions:
    """Static options — ``BiGAMP/BiGAMPOpt.m`` defaults."""

    nit: int = 250
    step: float = 0.05
    step_min: float = 0.05
    step_max: float = 0.5
    step_incr: float = 1.1
    step_decr: float = 0.5
    step_window: int = 1
    step_filter: float = 0.0
    adapt_step: bool = True
    pvar_step: bool = True
    pvar_min: float = 1e-13
    xvar_min: float = 0.0
    avar_min: float = 0.0
    zvar_to_pvar_max: float = 0.99
    var_thresh: float = 1e6
    gain_mode: int = 1
    var_norm: bool = False


class BigAmpFullResult(NamedTuple):
    A: torch.Tensor
    X: torch.Tensor
    Z: torch.Tensor
    Avar: torch.Tensor
    Xvar: torch.Tensor
    X2: Optional[torch.Tensor] = None
    # EM quantities (BiGAMP.m saveEM exports)
    Rx: torch.Tensor = None
    rvar_x: torch.Tensor = None
    Qa: torch.Tensor = None
    qvar_a: torch.Tensor = None


def _per_realization(v, batch: int, k: int, dtype, device) -> torch.Tensor:
    """A number, a 0-d tensor or one value a realization (B elements in any
    shape) as a (B, 1, …) tensor with ``k`` ones in ``dtype`` (the real part
    where ``dtype`` is real)."""
    t = torch.as_tensor(v, device=device)
    t = (t.real if t.is_complex() and not dtype.is_complex else t).to(dtype)
    if t.numel() == batch and batch != 1 or t.dim() and t.shape[0] == batch:
        return t.reshape((batch,) + (1,) * k)
    return t.reshape(()).expand((batch,) + (1,) * k).clone()


def _rand_init(key, shape, m0, v0, dtype, device):
    """m0 + √(E|x|²)·noise, E|x|² = |m0|² + v0, complex circular where
    ``dtype`` is; ``shape`` leads with the batch, m0 and v0 broadcast against
    it (one value or one a realization)."""
    rdt = torch.empty((), dtype=dtype).real.dtype
    m0 = torch.as_tensor(m0, device=device)
    ex2 = m0.abs() ** 2 + torch.as_tensor(v0, device=device).real
    ex2 = ex2.to(rdt)
    if dtype.is_complex:
        w = torch.complex(prng.normal(key, shape, rdt, device),
                          prng.normal(prng.fold_in(key, 1), shape, rdt, device)) * torch.sqrt(ex2 / 2)
    else:
        w = prng.normal(key, shape, rdt, device) * torch.sqrt(ex2)
    return m0.to(dtype) + w.to(dtype)


def _sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over each realization's matrix: (B, …) -> (B,)."""
    return v.sum(tuple(range(1, v.dim())))


def bigamp_pev(
    Y,
    mask,
    rank,
    prior_a,
    prior_x,
    noise_var,
    key,
    opts: Optional[BigAmpOptions] = None,
    likelihood=None,
    A2=None,
    prior_x2=None,
    init_A=None,
    init_X=None,
) -> BigAmpFullResult:
    """Per-element-variance BiG-AMP (``BiGAMP.m`` with
    ``uniformVariance=false``), optionally with the known linear branch
    Z = A·X + A2·X2 of ``BiGAMP_X2.m`` (A2 (B, L, N2) or one (L, N2) for
    all).  Returns posterior factor moments plus the (Rx, rvar)/(Qa, qvar)
    pseudo-data the EM wrappers consume.  ``key`` is a ``torch.Generator``
    (or None with ``init_A`` and ``init_X``); ``noise_var`` a number or one
    a realization."""
    opts = opts or BigAmpOptions()
    has_x2 = A2 is not None
    B, L, M = Y.shape
    R = rank
    cdt = Y.dtype
    rdt = Y.real.dtype
    dev = Y.device
    m = torch.broadcast_to(torch.as_tensor(mask, device=dev).to(rdt), Y.shape)
    nv = _per_realization(noise_var, B, 2, rdt, dev)

    kA, kX, _kX2 = prng.split(key, 3)
    ma, va = prior_a.init_moments()
    mx, vx = prior_x.init_moments()
    Ahat = init_A if init_A is not None else _rand_init(kA, (B, L, R), ma, va, cdt, dev)
    Xhat = init_X if init_X is not None else _rand_init(kX, (B, R, M), mx, vx, cdt, dev)
    Avar = torch.broadcast_to(torch.as_tensor(va, device=dev).real.to(rdt), (B, L, R)).clone()
    Xvar = torch.broadcast_to(torch.as_tensor(vx, device=dev).real.to(rdt), (B, R, M)).clone()

    if has_x2:
        N2 = A2.shape[-1]
        mx2, vx2 = prior_x2.init_moments()
        X2hat = torch.broadcast_to(torch.as_tensor(mx2, device=dev).to(cdt), (B, N2, M)).clone()  # prior mean
        X2var = torch.broadcast_to(torch.as_tensor(vx2, device=dev).real.to(rdt), (B, N2, M)).clone()
        A2sq = A2.abs() ** 2
    else:
        X2hat = torch.zeros((B, 1, M), dtype=cdt, device=dev)
        X2var = torch.zeros((B, 1, M), dtype=rdt, device=dev)

    def out_estim(phat, pvar):
        if likelihood is not None:
            return likelihood.estim(phat, pvar)
        gain = pvar / (pvar + nv)
        return phat + gain * (Y - phat), gain * nv

    # the hooks decide the pass test: a likelihood's own loglike where it has
    # one, the AWGN cost otherwise (the port's estimators carry exactly their
    # JAX classes' hooks, so ``val`` is the same function of the same state)
    def out_loglike(zhat, pvar):
        if likelihood is not None and hasattr(likelihood, "loglike"):
            return likelihood.loglike(zhat, pvar)
        return -((Y - zhat).abs() ** 2 + pvar) / torch.clamp(nv, min=1e-20)

    Shat = torch.zeros((B, L, M), dtype=cdt, device=dev)
    Svar = torch.zeros((B, L, M), dtype=rdt, device=dev)
    AhatBar, XhatBar = Ahat, Xhat
    ShatOpt, SvarOpt, ShatNewOpt, SvarNewOpt = Shat, Svar, Shat, Svar
    AhatBarOpt, XhatBarOpt, AhatOpt, XhatOpt = Ahat, Xhat, Ahat, Xhat
    pvarOpt = torch.zeros((B, L, M), dtype=rdt, device=dev)
    zvarOpt = torch.zeros((B, L, M), dtype=rdt, device=dev)
    # the carried step starts at the configured opts.step; the window is
    # +inf-filled so that unpopulated slots never win the min.  One step,
    # one window and one val_in a realization: the adaptive step is decided
    # per realization (val_window (B, W + 1), the roll acting on its last axis)
    step = torch.full((B, 1, 1), opts.step, dtype=rdt, device=dev)
    val_window = torch.full((B, max(opts.step_window, 0) + 1), torch.inf, dtype=rdt, device=dev)
    val_in = torch.zeros((B,), dtype=rdt, device=dev)
    Rx, rvar_x = Xhat, torch.ones((B, R, M), dtype=rdt, device=dev)
    Qa, qvar_a = Ahat, torch.ones((B, L, R), dtype=rdt, device=dev)

    for it in range(opts.nit):
        first = it == 0
        # ---- output linear stage (BiGAMP.m:370-420); .mT/.mH, never .T,
        # which would move the batch axis into the product ----
        Ahat2 = Ahat.abs() ** 2
        Xhat2 = Xhat.abs() ** 2
        zvar = Avar @ Xhat2 + Ahat2 @ Xvar
        pvar = zvar + Avar @ Xvar
        if has_x2:
            pvar = pvar + A2sq @ X2var
        zhat = Ahat @ Xhat
        if has_x2:
            zhat = zhat + A2 @ X2hat
        if opts.pvar_step and not first:
            pvar = step * pvar + (1 - step) * pvarOpt
            zvar = step * zvar + (1 - step) * zvarOpt
        phat = zhat - Shat * zvar  # note: zvar, not pvar (BiGAMP.m:417)
        pvar_b = torch.clamp(pvar, min=opts.pvar_min)

        # ---- cost and pass test (BiGAMP.m:423-456), per realization ----
        val = (_sum(m * out_loglike(zhat, pvar)) + val_in).to(rdt)
        val_min = val_window.min(-1).values
        passed = (val > val_min) | ~torch.isfinite(val_min) | (step.reshape(B) <= opts.step_min)
        if first or not opts.adapt_step:
            passed = torch.ones_like(passed)
        p3 = passed[:, None, None]

        def sel(new, old):
            return torch.where(p3, new, old)

        ShatOpt = sel(Shat, ShatOpt)
        SvarOpt = sel(Svar, SvarOpt)
        XhatBarOpt = sel(XhatBar, XhatBarOpt)
        XhatOpt = sel(Xhat, XhatOpt)
        AhatBarOpt = sel(AhatBar, AhatBarOpt)
        AhatOpt = sel(Ahat, AhatOpt)
        pvarOpt = sel(pvar, pvarOpt)
        zvarOpt = sel(zvar, zvarOpt)
        rolled = torch.cat([val_window[:, 1:], torch.where(torch.isnan(val), torch.inf, val)[:, None]], -1)
        val_window = torch.where(passed[:, None], rolled, val_window)

        # ---- output nonlinear stage, on pass (BiGAMP.m:494-530) ----
        zhat0, zvar0 = out_estim(phat, pvar_b)
        pvar_inv = m / pvar_b
        ShatNew = sel(pvar_inv * (zhat0 - phat), ShatNewOpt)
        SvarNew = sel(pvar_inv * (1.0 - torch.clamp(zvar0 / pvar_b, max=opts.zvar_to_pvar_max)), SvarNewOpt)
        ShatNewOpt, SvarNewOpt = ShatNew, SvarNew

        step = torch.where(p3, torch.clamp(torch.clamp(opts.step_incr * step, min=opts.step_min), max=opts.step_max),
                           torch.clamp(opts.step_decr * step, min=opts.step_min))

        # ---- damping (BiGAMP.m:668-676): step1 = step with stepFilter ----
        if first:
            # first-iteration anchors (BiGAMP.m equivalent of the NaN-init)
            Shat, Svar, XhatBar, AhatBar = ShatNew, SvarNew, XhatOpt, AhatOpt
        else:
            it_f = it + 1.0
            step1 = step * (it_f / (it_f + opts.step_filter) if opts.step_filter >= 1.0 else 1.0)
            Shat = (1 - step1) * ShatOpt + step1 * ShatNew
            Svar = (1 - step1) * SvarOpt + step1 * SvarNew
            XhatBar = (1 - step1) * XhatBarOpt + step1 * XhatOpt
            AhatBar = (1 - step1) * AhatBarOpt + step1 * AhatOpt

        # ---- input linear for X (BiGAMP.m:687-750) ----
        AhatBar2 = AhatBar.abs() ** 2
        rvar = torch.clamp(1.0 / torch.clamp(AhatBar2.mT @ Svar, min=1e-30), max=opts.var_thresh)
        if opts.gain_mode == 1:
            rgain = 1.0 - rvar * (Avar.mT @ Svar)
        elif opts.gain_mode == 2:
            rgain = 1.0 - rvar * (Avar.mT @ Shat.abs() ** 2)
        else:
            rgain = torch.ones_like(rvar)
        rgain = torch.clamp(rgain, 0.0, 1.0)
        Rx = XhatBar * rgain + rvar * (AhatBar.mH @ Shat)
        rvar = torch.clamp(rvar, min=opts.xvar_min)

        # ---- input linear for A (BiGAMP.m:753-817) ----
        XhatBar2 = XhatBar.abs() ** 2
        qvar = torch.clamp(1.0 / torch.clamp(Svar @ XhatBar2.mT, min=1e-30), max=opts.var_thresh)
        if opts.gain_mode == 1:
            qgain = 1.0 - qvar * (Svar @ Xvar.mT)
        elif opts.gain_mode == 2:
            qgain = 1.0 - qvar * (Shat.abs() ** 2 @ Xvar.mT)
        else:
            qgain = torch.ones_like(qvar)
        qgain = torch.clamp(qgain, 0.0, 1.0)
        Qa = AhatBar * qgain + qvar * (Shat @ XhatBar.mH)
        qvar = torch.clamp(qvar, min=opts.avar_min)

        # ---- input nonlinear (BiGAMP.m:819-830) ----
        Xn, Xvar_n = prior_x.estim(Rx, rvar)
        An, Avar_n = prior_a.estim(Qa, qvar)
        val_in = torch.zeros((B,), dtype=rdt, device=dev)
        if hasattr(prior_x, "val_neg_kl") and opts.adapt_step:
            val_in = val_in + _sum(prior_x.val_neg_kl(Rx, rvar, Xn, Xvar_n).real).to(rdt)
        if hasattr(prior_a, "val_neg_kl") and opts.adapt_step:
            val_in = val_in + _sum(prior_a.val_neg_kl(Qa, qvar, An, Avar_n).real).to(rdt)

        # ---- X2 branch: plain GAMP through the known A2 (BiGAMP_X2.m) ----
        if has_x2:
            r2var = torch.clamp(1.0 / torch.clamp(A2sq.mT @ Svar, min=1e-30), max=opts.var_thresh)
            R2 = X2hat + r2var * (A2.mH @ Shat)
            X2hat, X2var_n = prior_x2.estim(R2, r2var)
            X2var = torch.clamp(X2var_n.real, min=1e-30)

        Ahat, Xhat = An, Xn
        Avar = torch.clamp(Avar_n.real, min=1e-30)
        Xvar = torch.clamp(Xvar_n.real, min=1e-30)
        rvar_x, qvar_a = rvar, qvar

    # Final iterates, as JAX exports them: the last unaccepted Ahat/Xhat.
    # A fault of the reference, mirrored so that the port stays held to it:
    # BiGAMP.m exports the accepted AhatOpt/XhatOpt (as bigamp_lite does),
    # and these can pair a rejected step's factors with its variances
    # (ROADMAP Queue 3).
    Z = Ahat @ Xhat
    if has_x2:
        Z = Z + A2 @ X2hat
    return BigAmpFullResult(
        A=Ahat, X=Xhat, Z=Z, Avar=Avar, Xvar=Xvar, X2=X2hat if has_x2 else None,
        Rx=Rx, rvar_x=rvar_x, Qa=Qa, qvar_a=qvar_a,
    )


class BigAmpLiteResult(NamedTuple):
    A: torch.Tensor
    X: torch.Tensor
    Z: torch.Tensor
    Avar: torch.Tensor
    Xvar: torch.Tensor


def bigamp_lite(
    Y,
    mask,
    rank,
    nux,
    nua,
    nuw,
    key,
    nit: int = 250,
    step: float = 0.5,
    adapt_step: bool = True,
    init_A=None,
    init_X=None,
):
    """BiG-AMP Lite (``BiGAMP_Lite.m:110-520``): AWGN output, i.i.d.
    zero-mean Gaussian priors on both factors, scalar variances — every
    input nonlinear stage collapses to a closed-form gain, so one
    iteration is three dense products (Z = A·X, AᴴV, V·Xᴴ) plus
    elementwise work.  ``nux``, ``nua`` and ``nuw`` are numbers or one a
    realization.  Returns (``BigAmpLiteResult``, ``hist``), ``hist`` holding
    ``val``, ``step`` and ``passed``, each (B, nit); ``Avar`` and ``Xvar``
    are (B, 1, 1)."""
    B, L, M = Y.shape
    R = rank
    cdt = Y.dtype
    rdt = Y.real.dtype
    dev = Y.device
    m = torch.broadcast_to(torch.as_tensor(mask, device=dev).to(rdt), Y.shape)
    nux, nua, nuw = (_per_realization(v, B, 2, rdt, dev) for v in (nux, nua, nuw))
    # the sampling rate and the Frobenius sums below are per realization
    p1 = torch.clamp(m.mean((1, 2), keepdim=True), min=1e-6)
    Y = Y * m

    kA, kX = prng.split(key, 2)
    Ahat = init_A if init_A is not None else _rand_init(kA, (B, L, R), 0.0, nua, cdt, dev)
    Xhat = init_X if init_X is not None else _rand_init(kX, (B, R, M), 0.0, nux, cdt, dev)

    def frob(v):
        return (v.abs() ** 2).sum((1, 2), keepdim=True)

    Avar, Xvar = nua, nux
    Vhat = torch.zeros((B, L, M), dtype=cdt, device=dev)
    xBar, ABar = Xhat, Ahat
    pvarOpt = torch.full((B, 1, 1), 1e-13, dtype=rdt, device=dev)
    holderOpt = torch.zeros((B, L, M), dtype=cdt, device=dev)
    VhatOpt = holderOpt
    xBarOpt, ABarOpt, xhatOpt, AhatOpt = Xhat, Ahat, Xhat, Ahat
    Vgain = torch.zeros((B, 1, 1), dtype=rdt, device=dev)
    stp = torch.clamp(torch.full((B, 1, 1), step, dtype=rdt, device=dev), max=0.5)
    val_prev = torch.full((B,), -torch.inf, dtype=rdt, device=dev)
    val_in = torch.zeros((B,), dtype=rdt, device=dev)
    hist = dict(val=[], step=[], passed=[])

    for it in range(nit):
        first = it == 0
        # step1 tracks the adaptive step from the end of the previous
        # iteration (BiGAMP_Lite.m:386-391); 1 on the first iteration
        step1 = 1.0 if first else stp
        # output stage (BiGAMP_Lite.m:212-247)
        zhat = m * (Ahat @ Xhat)
        holder = Y - zhat
        Xf2 = frob(Xhat)
        Af2 = frob(Ahat)
        pvar = step1 * (Avar * Xf2 / M + Xvar * Af2 / L + R * Avar * Xvar) + (1 - step1) * pvarOpt
        pvar = torch.clamp(pvar, min=1e-13)
        pvarOpt0 = pvar if first else pvarOpt
        # cost (BiGAMP_Lite.m:237-256), one a realization
        val = -0.5 * _sum(m * (holder.abs() ** 2 + pvar)) / torch.clamp(nuw, min=1e-20).reshape(B) + val_in
        # forced pass at stepMin (BiGAMP_Lite.m:268-270)
        passed = (val > val_prev) | (stp.reshape(B) <= 0.05)
        if first or not adapt_step:
            passed = torch.ones_like(passed)
        p3 = passed[:, None, None]

        def sel(new, old):
            return torch.where(p3, new, old)

        pvarOpt = sel(pvar, pvarOpt0)
        # Vgain uses the freshly-accepted pvarOpt like every other gain in
        # this iteration (BiGAMP_Lite.m)
        Vgain = sel((Avar * Xf2 / M + Xvar * Af2 / L) / (pvarOpt + nuw), Vgain)
        holderOpt = sel(holder, holderOpt)
        xhatOpt = sel(Xhat, xhatOpt)
        AhatOpt = sel(Ahat, AhatOpt)
        xBarOpt0 = sel(xBar, xBarOpt)
        ABarOpt0 = sel(ABar, ABarOpt)
        VhatOpt0 = sel(Vhat, VhatOpt)
        val_prev = torch.where(passed, val, val_prev)
        stp = torch.where(p3, torch.clamp(torch.clamp(1.1 * stp, min=0.05), max=0.5), torch.clamp(0.5 * stp, min=0.05))
        # bars (BiGAMP_Lite.m:393-403) use the freshly-updated step
        step1b = 1.0 if first else stp
        xBar = step1b * xhatOpt + (1 - step1b) * xBarOpt0
        ABar = step1b * AhatOpt + (1 - step1b) * ABarOpt0
        Vhat = step1b * holderOpt + (1 + step1b * Vgain - step1b) * VhatOpt0
        xBarOpt, ABarOpt, VhatOpt = (xBar, ABar, Vhat) if first else (xBarOpt0, ABarOpt0, VhatOpt0)
        # gains (BiGAMP_Lite.m:405-469, gainMode 1)
        Xbarf2 = torch.clamp(frob(xBar), min=1e-30)
        Abarf2 = torch.clamp(frob(ABar), min=1e-30)
        Xgain = nux / (nux + R * (nuw + pvarOpt) / Abarf2 / p1)
        Again = nua / (nua + R * (nuw + pvarOpt) / Xbarf2 / p1)
        Vf2 = frob(Vhat)
        rGain = torch.clamp(1.0 - Avar * Vf2 * R / Abarf2 / (nuw + pvarOpt) / p1 / M, 0.0, 1.0)
        qGain = torch.clamp(1.0 - Xvar * Vf2 * R / Xbarf2 / (nuw + pvarOpt) / p1 / L, 0.0, 1.0)
        Xn = Xgain * (xBar * rGain + R / p1 / Abarf2 * (ABar.mH @ Vhat))
        An = Again * (ABar * qGain + R / p1 / Xbarf2 * (Vhat @ xBar.mH))
        Xvar_n = nux - nux * Xgain
        Avar_n = nua - nua * Again
        # input utility (BiGAMP_Lite.m:480-486); the element counts are one
        # realization's, R·M and L·R
        valX = (0.5 * (torch.log(Xvar_n / nux) + (1 - Xvar_n / nux)) * (R * M)).reshape(B) \
            - 0.5 * _sum(Xn.abs() ** 2) / nux.reshape(B)
        valA = (0.5 * (torch.log(Avar_n / nua) + (1 - Avar_n / nua)) * (L * R)).reshape(B) \
            - 0.5 * _sum(An.abs() ** 2) / nua.reshape(B)
        Ahat, Xhat, Avar, Xvar = An, Xn, Avar_n, Xvar_n
        val_in = (valX + valA).to(rdt)
        hist["val"].append(val)
        hist["step"].append(stp.reshape(B))
        hist["passed"].append(passed)

    hist = {k: torch.stack(v, -1) if v else torch.zeros((B, 0), device=dev) for k, v in hist.items()}
    return BigAmpLiteResult(A=AhatOpt, X=xhatOpt, Z=AhatOpt @ xhatOpt, Avar=Avar, Xvar=Xvar), hist
