"""Turbo message passing with a Markov-chain support prior, batched
(counterpart of ``jstsp19_tpu/solvers/turbo.py``: ``_channel_llr``,
``_markov_extrinsic``, ``_gauss_markov_extrinsic``, ``TurboResult``,
``turbo_markov_vamp``, ``turbo_gauss_markov_vamp`` and ``turbo_mrf_vamp``;
the reference's turboGAMP, ``EMturboGAMP.m`` with a ``SupportStruct``
Markov chain).

The sparse solver (VAMP-SLM) exchanges extrinsic activity log-likelihood
ratios with a binary Markov-chain smoother running along one axis of the
coefficient matrix (beamspace supports are correlated along the angle axis),
BCJR-style forward–backward in the log domain.

Where the JAX package solves one problem, y here carries a batch of
realizations as its leading dimensions, so the coefficients are (B, Gr, K)
on a ``KronDictOp`` or (B, n) on a vector operator.  The chain runs along
the first input axis, dim ``-len(op.in_shape)``, never along dim 0, which
is the batch; everything JAX reduces over its one problem (the keep-best
data residual) is reduced per realization, (B, 1, …).  Each ``lax.scan``
over rounds is a Python loop, each ``lax.scan`` along a chain a loop over
that axis.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from jstsp19_torch.solvers.estim import CAwgnPrior, SparsePrior
from jstsp19_torch.solvers.vamp_slm import vamp_slm

_LLR_CAP = 30.0
_LOG_PI = math.log(math.pi)


def _batch(y, op):
    """The leading (batch) dimensions of y."""
    return tuple(y.shape[: y.dim() - len(op.out_shape)])


def _col(batch, op):
    """The shape of one number per realization against the coefficients."""
    return batch + (1,) * len(op.in_shape)


def _in_dims(op):
    return tuple(range(-len(op.in_shape), 0))


def _channel_llr(base, r1, rvar):
    """Per-element activity evidence log p(r|on) − log p(r|off)."""
    loglike1 = base.loglikey(r1, rvar)
    loglike0 = -(_LOG_PI + torch.log(rvar) + r1.abs() ** 2 / rvar)
    return torch.clamp(loglike1 - loglike0, -_LLR_CAP, _LLR_CAP)


def _fill(v, like: torch.Tensor) -> torch.Tensor:
    """A number or a per-realization tensor broadcast against ``like``,
    float32."""
    return torch.zeros_like(like, dtype=torch.float32) + v


def _chain_slices(v: torch.Tensor, dim: int):
    """The elements of v along ``dim``, each kept as a slice of length 1 so
    that per-realization parameters (B, 1, …) broadcast against it."""
    return list(torch.split(v, 1, dim))


def _markov_extrinsic(llr_in: torch.Tensor, p01: float, p10: float, dim: int = 0) -> torch.Tensor:
    """Forward–backward along ``dim`` of a binary Markov chain.

    llr_in: channel LLRs per chain element.  Returns the extrinsic prior LLR
    of each element (excluding its own observation), log domain.
    Transitions: p01 = P(off→on), p10 = P(on→off).  JAX runs the chain along
    axis 0 of its one problem; here the caller names the chain axis, which
    on a batch is an input axis (``dim`` 0 would smooth across
    realizations).
    """
    dev = llr_in.device
    log_T = torch.log(torch.tensor([[1 - p01, p01], [p10, 1 - p10]], dtype=torch.float32, device=dev)
                      + 1e-30)  # [from, to]
    pi_on = p01 / (p01 + p10)
    log_prior0 = torch.log(torch.tensor([1 - pi_on, pi_on], dtype=torch.float32, device=dev) + 1e-30)

    # per-element observation log-potentials (…, 2)
    obs = [torch.stack([torch.zeros_like(o), o], -1) for o in _chain_slices(llr_in, dim)]

    alphas = []  # log messages INTO each node (before its observation)
    alpha = log_prior0.expand(obs[0].shape)
    for o in obs:
        alphas.append(alpha)
        nxt = torch.logsumexp((alpha + o)[..., :, None] + log_T, -2)
        alpha = nxt - torch.logsumexp(nxt, -1, keepdim=True)

    betas = [None] * len(obs)
    beta = torch.zeros(obs[0].shape, dtype=torch.float32, device=dev)
    for t in range(len(obs) - 1, -1, -1):
        betas[t] = beta
        prv = torch.logsumexp((beta + obs[t])[..., None, :] + log_T, -1)
        beta = prv - torch.logsumexp(prv, -1, keepdim=True)

    ext = torch.cat([a + b for a, b in zip(alphas, betas)], dim if dim >= 0 else dim - 1)
    return torch.clamp(ext[..., 1] - ext[..., 0], -_LLR_CAP, _LLR_CAP)


class TurboResult(NamedTuple):
    x: torch.Tensor
    p1: torch.Tensor  # per-element activity prior


def _keep_best(y, op, x, best_res):
    """The per-realization data residual ‖y − op·x‖² (B, 1, …) and whether
    it beats ``best_res``: each realization keeps its own best round."""
    r = y - op.mv(x)
    resid = (r.abs() ** 2).sum(tuple(range(-len(op.out_shape), 0)))
    resid = resid.reshape(best_res.shape)
    return resid, resid < best_res


def _spike_slab_base(slab_var, dev):
    """JAX's ``CAwgnPrior(0j, float32(slab_var))``: a number or a
    per-realization tensor."""
    return CAwgnPrior(0.0, torch.as_tensor(slab_var, dtype=torch.float32, device=dev))


def _damped_refresh(llr_ext, p1):
    """Damped, clamped prior refresh: per-element activity priors can
    destabilize the scalar-variance VAMP, so updates stay conservative."""
    return 0.5 * torch.clamp(torch.sigmoid(llr_ext), 5e-2, 1 - 5e-2) + 0.5 * p1


def _support_turbo(y, op, slab_var, gamw, p1, extrinsic, n_turbo, nit, keep_best_p1):
    """The turbo loop the support-structured solvers share: VAMP with the
    current per-element activity prior, the channel LLRs clamped at ±8,
    the structure's extrinsic LLRs (``extrinsic(llr_obs)``), the damped
    refresh, and per realization the round with the smallest data residual.
    Returns (best x, best round's p1 or the last p1)."""
    batch, dev = _batch(y, op), y.device
    col = _col(batch, op)
    base = _spike_slab_base(slab_var, dev)
    best_x = torch.zeros(batch + tuple(op.in_shape), dtype=y.dtype, device=dev)
    best_p1 = p1
    best_res = torch.full(col, torch.inf, dtype=torch.float32, device=dev)
    for _ in range(n_turbo):
        res = vamp_slm(SparsePrior(base, p1), y, op, gamw=gamw, nit=nit)
        rvar = (1.0 / res.gam1).expand(res.r1.shape)
        llr_obs = torch.clamp(_channel_llr(base, res.r1, rvar), -8.0, 8.0)
        p1_new = _damped_refresh(extrinsic(llr_obs), p1)
        # keep the best iterate by data residual (turbo rounds can degrade
        # on ill-posed instances; the residual is an observable criterion)
        resid, better = _keep_best(y, op, res.x, best_res)
        best_x = torch.where(better, res.x, best_x)
        best_p1 = torch.where(better, p1, best_p1)
        best_res = torch.where(better, resid, best_res)
        p1 = p1_new
    return best_x, (best_p1 if keep_best_p1 else p1)


def turbo_markov_vamp(y, op, slab_var, gamw, p01: float = 0.05, p10: float = 0.3, n_turbo: int = 5,
                      nit: int = 30) -> TurboResult:
    """Structured-sparsity recovery: VAMP inner solver + Markov support
    smoother along the first input axis of the coefficients (JAX's axis 0;
    the angle axis Gr on a ``KronDictOp``).  ``slab_var`` and ``gamw`` are
    numbers or one per realization (B, 1, …).  Returns the best round's x
    and the p1 that round ran with (JAX's ``best_p1``)."""
    pi_on = p01 / (p01 + p10)
    p1 = torch.full(_batch(y, op) + tuple(op.in_shape), pi_on, dtype=torch.float32, device=y.device)
    chain = -len(op.in_shape)
    x, p1 = _support_turbo(y, op, slab_var, gamw, p1, lambda llr: _markov_extrinsic(llr, p01, p10, chain),
                           n_turbo, nit, keep_best_p1=True)
    return TurboResult(x=x, p1=p1)


def _gauss_markov_extrinsic(robs, obs_prec, alpha, sigma2, dim: int = 0):
    """Extrinsic Gaussian messages of a stationary AR(1) (Gauss–Markov)
    chain along ``dim`` — the ``AmplitudeStruct`` Gauss–Markov capability of
    turboGAMP (``turboGAMP/ClassDefs/GaussMarkov.m``).

    Chain model: theta_t = (1-alpha)·theta_{t-1} + w_t with stationary
    variance sigma2 (so var(w) = (1-(1-alpha)²)·sigma2).  ``robs`` are
    per-element pseudo-observations of theta with precision ``obs_prec``
    (zero precision = uninformative).  Returns (eta, kappa): the mean and
    variance of each element's extrinsic Gaussian prior — the product of the
    forward and backward chain messages, excluding the element's own
    observation.  ``alpha`` and ``sigma2`` are numbers or one per
    realization (B, 1, …); JAX's chain runs along axis 0 of its one problem,
    here along ``dim``, an input axis of the batch.
    """
    a = 1.0 - alpha
    q = torch.clamp(torch.as_tensor((1.0 - a * a) * sigma2, dtype=torch.float32, device=robs.device), min=1e-12)
    r_s, p_s = _chain_slices(robs, dim), _chain_slices(obs_prec, dim)
    P0 = _fill(sigma2, r_s[0])

    def directional(order):
        # carry init (0, sigma2): the predict step then hands the first node
        # the stationary prior (a²·sigma2 + q = sigma2); each step emits the
        # predict-from-previous, the message INTO node t
        m_f, P_f = torch.zeros_like(r_s[0]), P0
        out = [None] * len(r_s)
        for t in order:
            m_pred = a * m_f
            P_pred = a * a * P_f + q
            out[t] = (m_pred, P_pred)
            # combine the prediction with the observation at node t: filtered
            P_f = 1.0 / (1.0 / P_pred + p_s[t])
            m_f = P_f * (m_pred / P_pred + p_s[t] * r_s[t])
        return out

    n = len(r_s)
    fwd, bwd = directional(range(n)), directional(range(n - 1, -1, -1))
    mf, Pf = (torch.cat([f[i] for f in fwd], dim) for i in (0, 1))
    mb, Pb = (torch.cat([b[i] for b in bwd], dim) for i in (0, 1))
    # product of the two incoming Gaussian messages (precisions add)
    prec = 1.0 / Pf + 1.0 / Pb - 1.0 / sigma2  # stationary prior counted twice
    prec = torch.maximum(prec, torch.as_tensor(1.0 / (10.0 * sigma2), dtype=torch.float32, device=robs.device))
    kappa = 1.0 / prec
    eta = kappa * (mf / Pf + mb / Pb)
    return eta, kappa


def turbo_gauss_markov_vamp(y, op, sigma2, gamw, alpha: float = 0.1, p1: float = 1.0, n_turbo: int = 6,
                            nit: int = 30) -> TurboResult:
    """Turbo VAMP with a Gauss–Markov *amplitude* structure — the
    ``AmplitudeStruct`` capability of turboGAMP: coefficient amplitudes are
    correlated along the first input axis (theta_t = (1-alpha)·theta_{t-1}
    + noise), and the chain smoother exchanges extrinsic per-element
    Gaussian priors CN(eta, kappa) with the spike-slab inner solver.
    ``sigma2`` and ``gamw`` are numbers or one per realization."""
    batch, dev = _batch(y, op), y.device
    shape = batch + tuple(op.in_shape)
    chain = -len(op.in_shape)
    sigma2 = torch.as_tensor(sigma2, dtype=torch.float32, device=dev)
    p1_arr = torch.full(shape, p1, dtype=torch.float32, device=dev)
    eta = torch.zeros(shape, dtype=y.dtype, device=dev)
    kappa = sigma2.expand(shape).clone()
    x = torch.zeros(shape, dtype=y.dtype, device=dev)
    for _ in range(n_turbo):
        base = CAwgnPrior(eta, kappa)
        res = vamp_slm(SparsePrior(base, p1_arr), y, op, gamw=gamw, nit=nit)
        rvar = (1.0 / res.gam1).expand(res.r1.shape)
        # the activity posterior weights the chain observations
        llr = _channel_llr(base, res.r1, rvar)
        py1 = torch.sigmoid(torch.clamp(llr + torch.log(p1_arr) - torch.log1p(-p1_arr + 1e-12), -30, 30))
        eta, kappa = _gauss_markov_extrinsic(res.r1, py1 / rvar, alpha, sigma2, chain)
        kappa = kappa.float()
        # the extrinsic prior tightens monotonically — keep the last round
        # (a data-residual criterion would keep the overfitted first round)
        x = res.x
    return TurboResult(x=x, p1=p1_arr)


def turbo_mrf_vamp(y, op, slab_var, gamw, p01: float = 0.05, p10: float = 0.3, n_turbo: int = 5,
                   nit: int = 30) -> TurboResult:
    """Structured-sparsity recovery with a 2-D Markov-random-field support
    prior — the ``SupportStruct`` MRF capability of turboGAMP
    (``turboGAMP/ClassDefs/MarkovField.m``): clustered supports on a 2-D
    grid, approximated turbo-style as the product of a row-chain and a
    column-chain BCJR smoother (their extrinsic LLRs add).  The
    coefficients are matrices, (B, Gr, K)."""
    pi_on = p01 / (p01 + p10)
    p1 = torch.full(_batch(y, op) + tuple(op.in_shape), pi_on, dtype=torch.float32, device=y.device)

    def extrinsic(llr_obs):
        rows = _markov_extrinsic(llr_obs, p01, p10, -2)  # JAX's axis 0
        # JAX's column chain, ``_markov_extrinsic(llr_obs.T).T``: its .T is
        # transpose(-2, -1) on a batch, so the chain runs along dim -1
        cols = _markov_extrinsic(llr_obs, p01, p10, -1)
        return torch.clamp(rows + cols, -_LLR_CAP, _LLR_CAP)

    x, p1 = _support_turbo(y, op, slab_var, gamw, p1, extrinsic, n_turbo, nit, keep_best_p1=True)
    return TurboResult(x=x, p1=p1)
