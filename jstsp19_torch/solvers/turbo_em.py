"""EM-turboGAMP: EM hyperparameter learning around the turbo solvers, plus
3-D and arbitrary-neighborhood MRF supports, batched (counterpart of
``jstsp19_tpu/solvers/turbo_em.py``: ``markov_fb``, ``EmTurboResult``,
``em_turbo_markov_vamp``, ``EmGaussMarkovResult``,
``em_turbo_gauss_markov_vamp``, ``TurboResult3D``, ``turbo_mrf3d_vamp`` and
``turbo_mrf_arb_vamp``; the reference's ``turboGAMP/Functions/
EMturboGAMP.m``, ``ClassDefs/MarkovChain1.m:436-570``,
``ClassDefs/GaussMarkov.m``, ``ClassDefs/@MarkovField3D`` and
``ClassDefs/@MarkovFieldArb``).

The chain smoothers run in the probability domain as a loop along the chain
axis, vectorized over every other axis; the EM updates are closed-form
posterior-moment expressions, so one EM round is one inner solve plus
elementwise work.  The arbitrary-neighborhood MRF runs damped loopy BP with
the adjacency as a dense matrix.

As in :mod:`jstsp19_torch.solvers.turbo`, y carries a batch of realizations
as its leading dimensions: the chains run along the first input axis of the
coefficients (dim ``-len(op.in_shape)``), never the batch axis, and every
statistic JAX takes over its one problem (the p01/λ sufficient statistics,
the Yule–Walker sums, the keep-best residual) is taken per realization, so
the learned ``p01``, ``lam``, ``alpha`` and ``sigma2`` are (B, 1, …).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from jstsp19_torch.ops.base import _matvec
from jstsp19_torch.solvers.estim import CAwgnPrior, SparsePrior, _clamp
from jstsp19_torch.solvers.turbo import (_LLR_CAP, _batch, _chain_slices, _channel_llr, _col, _fill,
                                         _gauss_markov_extrinsic, _in_dims, _markov_extrinsic, _spike_slab_base,
                                         _support_turbo)
from jstsp19_torch.solvers.vamp_slm import vamp_slm


def markov_fb(pi_out, lam, p01, dim: int = 0):
    """Forward/backward activity messages along ``dim`` in the probability
    domain — a vectorized transcription of the recursion in
    ``MarkovChain1.m:460-516``.

    pi_out: extrinsic channel activity probabilities; lam: stationary
    activity rate; p01 = P(on→off) — NOT turbo.py's p01 = P(off→on).  p10 is
    tied to keep the chain stationary at lam (``MarkovChain1.m:455-457``).
    lam and p01 are numbers or one per realization (B, 1, …).  JAX runs the
    chain along axis 0 of its one problem; on a batch ``dim`` is an input
    axis.

    Returns (pi_in, s_post, s_corr) where pi_in is the extrinsic prior
    activity, s_post = E[s_n | everything], and s_corr = E[s_n·s_{n+1}]
    (one shorter along ``dim``) — the sufficient statistics of the EM p01
    update.
    """
    p10 = p01 * lam / _clamp(1.0 - lam, 1e-12)
    eps = 1e-12
    pis = _chain_slices(pi_out, dim)
    n = len(pis)

    # lf[n] = forward message INTO node n
    lf = [_fill(lam, pis[0])]
    for pi_prev in pis[:-1]:
        f = lf[-1]
        num = p10 * (1 - pi_prev) * (1 - f) + (1 - p01) * pi_prev * f
        den = (1 - pi_prev) * (1 - f) + pi_prev * f
        lf.append(num / torch.clamp(den, min=eps))

    # lb[n] = backward message INTO node n, from lb[N-1] = 1/2
    lb = [None] * n
    lb[-1] = _fill(0.5, pis[0])
    for t in range(n - 2, -1, -1):
        b, pi_next = lb[t + 1], pis[t + 1]
        num = p01 * (1 - pi_next) * (1 - b) + (1 - p01) * pi_next * b
        den = (1 - p10 + p01) * (1 - pi_next) * (1 - b) + (1 - p01 + p10) * pi_next * b
        lb[t] = num / torch.clamp(den, min=eps)
    lf, lb = torch.cat(lf, dim), torch.cat(lb, dim)

    pi_in = lf * lb / torch.clamp((1 - lf) * (1 - lb) + lf * lb, min=eps)
    s_post = pi_out * lf * lb / torch.clamp((1 - pi_out) * (1 - lf) * (1 - lb) + pi_out * lf * lb, min=eps)
    # pairwise posteriors (MarkovChain1.m:528-552): JAX's [:-1] and [1:]
    # slice the chain axis, here ``dim``
    lfh, pih = lf.narrow(dim, 0, n - 1), pi_out.narrow(dim, 0, n - 1)
    lbt, pit = lb.narrow(dim, 1, n - 1), pi_out.narrow(dim, 1, n - 1)
    off_h = (1 - lfh) * (1 - pih)
    on_h = lfh * pih
    off_t = (1 - lbt) * (1 - pit)
    on_t = lbt * pit
    ps00 = (1 - p10) * off_h * off_t
    ps10 = p10 * off_h * on_t
    ps01 = p01 * on_h * off_t
    ps11 = (1 - p01) * on_h * on_t
    s_corr = ps11 / torch.clamp(ps00 + ps10 + ps01 + ps11, min=eps)
    return pi_in, s_post, s_corr


class EmTurboResult(NamedTuple):
    x: torch.Tensor
    p1: torch.Tensor
    p01: torch.Tensor
    lam: torch.Tensor


def em_turbo_markov_vamp(y, op, slab_var, gamw, p01_init: float = 0.2, lam_init: float = 0.2, n_em: int = 8,
                         nit: int = 30) -> EmTurboResult:
    """EM-turboGAMP with a Markov-chain support: each EM round runs the
    inner VAMP, converts its pseudo-data to activity evidence, smooths it
    along the chain (the first input axis), and re-estimates p01 and the
    sparsity rate in closed form from the chain's posterior sufficient
    statistics (``MarkovChain1.m:554-567``: p01 ← Σ(μ_s − s_corr)/Σ μ_s;
    ``MarkovChain1.m:295-323``: λ ← mean(s_post)), each per realization."""
    batch, dev = _batch(y, op), y.device
    col, shape, dims = _col(batch, op), batch + tuple(op.in_shape), _in_dims(op)
    chain = -len(op.in_shape)
    base = _spike_slab_base(slab_var, dev)
    p01 = torch.full(col, p01_init, dtype=torch.float32, device=dev)
    lam = torch.full(col, lam_init, dtype=torch.float32, device=dev)
    p1 = torch.full(shape, lam_init, dtype=torch.float32, device=dev)
    x = torch.zeros(shape, dtype=y.dtype, device=dev)
    for _ in range(n_em):
        res = vamp_slm(SparsePrior(base, p1), y, op, gamw=gamw, nit=nit)
        rvar = (1.0 / res.gam1).expand(res.r1.shape)
        llr_obs = torch.clamp(_channel_llr(base, res.r1, rvar), -8.0, 8.0)
        pi_in, s_post, s_corr = markov_fb(torch.sigmoid(llr_obs), lam, p01, chain)
        # EM updates, the sums over each realization's chain elements
        mu_head = s_post.narrow(chain, 0, s_post.shape[chain] - 1)
        p01 = torch.clamp((mu_head - s_corr).sum(dims, keepdim=True)
                          / torch.clamp(mu_head.sum(dims, keepdim=True), min=1e-12), 1e-4, 1.0 - 1e-4)
        lam = torch.clamp(s_post.mean(dims, keepdim=True), 1e-4, 1.0 - 1e-4)
        p1 = torch.clamp(pi_in, 5e-3, 1 - 5e-3)
        x = res.x
    return EmTurboResult(x=x, p1=p1, p01=p01, lam=lam)


class EmGaussMarkovResult(NamedTuple):
    x: torch.Tensor
    alpha: torch.Tensor
    sigma2: torch.Tensor


def em_turbo_gauss_markov_vamp(y, op, gamw, alpha_init: float = 0.5, sigma2_init: float = 1.0, n_em: int = 10,
                               nit: int = 30) -> EmGaussMarkovResult:
    """EM learning of the Gauss–Markov amplitude hyperparameters
    (``GaussMarkov.m`` EM updates, posterior-moment form), per realization:
    the AR(1) coefficient a = 1−alpha from the posterior lag-1 correlation
    (Yule–Walker on posterior moments) and the stationary variance sigma2
    from the posterior second moment."""
    batch, dev = _batch(y, op), y.device
    col, shape, dims = _col(batch, op), batch + tuple(op.in_shape), _in_dims(op)
    chain = -len(op.in_shape)
    n = shape[chain]
    alpha = torch.full(col, alpha_init, dtype=torch.float32, device=dev)
    sigma2 = torch.full(col, sigma2_init, dtype=torch.float32, device=dev)
    eta = torch.zeros(shape, dtype=y.dtype, device=dev)
    kappa = torch.full(shape, sigma2_init, dtype=torch.float32, device=dev)
    x = torch.zeros(shape, dtype=y.dtype, device=dev)
    for _ in range(n_em):
        res = vamp_slm(CAwgnPrior(eta, kappa), y, op, gamw=gamw, nit=nit)
        obs_prec = 1.0 / (1.0 / res.gam1).expand(res.r1.shape)
        eta, kappa = _gauss_markov_extrinsic(res.r1, obs_prec, alpha, sigma2, chain)
        # full posterior of theta (extrinsic × own observation)
        v_post = 1.0 / (1.0 / kappa + obs_prec)
        m_post = v_post * (eta / kappa + obs_prec * res.r1)
        # EM: Yule–Walker on posterior MEANS, as the JAX package writes it —
        # a mean-field approximation of the exact EM lag-1 statistic, which
        # would add the smoother's posterior cross-covariance
        # E[θ_t θ_{t-1}*] − m_t m_{t-1}* to the numerator (GaussMarkov.m's
        # Kalman-smoother EM).  Kept as the reference has it: it
        # under-estimates the correlation at low SNR.  JAX's [1:] and [:-1]
        # slice the chain axis.
        m_t, m_h = m_post.narrow(chain, 1, n - 1), m_post.narrow(chain, 0, n - 1)
        num = (m_t * m_h.conj()).real.sum(dims, keepdim=True)
        den = (m_h.abs() ** 2 + v_post.narrow(chain, 0, n - 1)).sum(dims, keepdim=True)
        alpha = 1.0 - torch.clamp(num / torch.clamp(den, min=1e-12), 0.01, 0.999)
        sigma2 = torch.clamp((m_post.abs() ** 2 + v_post).mean(dims, keepdim=True), min=1e-9)
        kappa = kappa.float()
        x = res.x
    return EmGaussMarkovResult(x=x, alpha=alpha, sigma2=sigma2)


class TurboResult3D(NamedTuple):
    x: torch.Tensor
    p1: torch.Tensor


def turbo_mrf3d_vamp(y, op, slab_var, gamw, shape3d, p01: float = 0.05, p10: float = 0.3, n_turbo: int = 5,
                     nit: int = 30) -> TurboResult3D:
    """3-D Markov-random-field support (``@MarkovField3D``): each
    realization's coefficient vector reshapes to ``shape3d`` and three
    chain smoothers (one per lattice axis) contribute additive extrinsic
    LLRs — the product-of-chains decomposition of the 2-D variant.  p01 is
    P(off→on), turbo.py's convention, NOT ``markov_fb``'s.  Returns the best
    round's x and the last p1, as JAX does."""
    batch = _batch(y, op)
    pi_on = p01 / (p01 + p10)
    p1 = torch.full(batch + tuple(op.in_shape), pi_on, dtype=torch.float32, device=y.device)

    def extrinsic(llr_obs):
        # JAX reshapes its one vector to (d0, d1, d2) and moves each lattice
        # axis to the front; here the cube is (B, d0, d1, d2) and each chain
        # runs along its own lattice axis, -3, -2 and -1
        cube = llr_obs.reshape(batch + tuple(shape3d))
        ext = sum(_markov_extrinsic(cube, p01, p10, d) for d in (-3, -2, -1))
        return torch.clamp(ext, -_LLR_CAP, _LLR_CAP).reshape(llr_obs.shape)

    x, p1 = _support_turbo(y, op, slab_var, gamw, p1, extrinsic, n_turbo, nit, keep_best_p1=False)
    return TurboResult3D(x=x, p1=p1)


def turbo_mrf_arb_vamp(y, op, slab_var, gamw, adjacency, coupling: float = 0.8, field: float = -1.0,
                       n_turbo: int = 5, nit: int = 30, n_bp: int = 8) -> TurboResult3D:
    """Arbitrary-neighborhood MRF support (``@MarkovFieldArb``): an Ising
    prior on the support with a user-supplied adjacency (n, n), shared or
    one per realization (B, n, n).  Extrinsic activity LLRs come from damped
    loopy BP, one matrix-vector product per sweep.  Returns the best round's
    x and the last p1, as JAX does."""
    (n,) = op.in_shape
    adj = adjacency.to(device=y.device, dtype=torch.float32)
    p1 = torch.sigmoid(torch.full(_batch(y, op) + (n,), field, dtype=torch.float32, device=y.device))
    tanh_j = float(torch.tanh(torch.tensor(coupling, dtype=torch.float32)))

    def extrinsic(llr_obs):
        # node beliefs b_i; messages approximated at belief level (flooding
        # schedule): m_i = 2·atanh(tanh(J)·tanh(b_i/2))
        b = field + llr_obs
        for _ in range(n_bp):
            msg = 2.0 * torch.atanh(torch.clamp(tanh_j * torch.tanh(b / 2.0), -0.999999, 0.999999))
            # JAX's adj @ msg on its one vector: each realization's row of
            # msg times adjᵀ, not msg's transpose (the adjacency need not
            # be symmetric)
            b = 0.5 * (field + llr_obs + _matvec(adj, msg)) + 0.5 * b
        # extrinsic: belief minus own observation
        return torch.clamp(b - llr_obs, -_LLR_CAP, _LLR_CAP)

    x, p1 = _support_turbo(y, op, slab_var, gamw, p1, extrinsic, n_turbo, nit, keep_best_p1=False)
    return TurboResult3D(x=x, p1=p1)
