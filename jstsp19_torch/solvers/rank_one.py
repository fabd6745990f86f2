"""Rank-one matrix factorization by AMP-style alternating estimation + SE
(counterpart of ``jstsp19_tpu/solvers/rank_one.py``).

The reference's ``matrixFactor/`` family: ``rankOneFit.m:1`` (the iterative
fit with Onsager-corrected power steps, scalar second-order tracking, and
the 'linear' / MMSE estimator branches), ``rankOneSE.m:1`` (the scalar state
evolution of the squared correlations), and the ``rankOneTest.m``
methodology (fit vs SE at fixed SNR).

Given A = u0·v0ᵀ + sqrt(m·wvar)·W the fit alternates

    p = (1/m)·A·v + μu·u     →  û = E[u | p]      (Onsager term μu)
    q = (1/m)·Aᵀ·û + μv·v    →  v̂ = E[v | q]

with the pseudo-data rescaled by the tracked second-order statistics
(au1/au0/av1/av0 — ``rankOneFit.m:100-215``).  Batched: A (B, m, n), u
(B, m), v (B, n); every tracked scalar, norm and mean is one a realization,
(B, 1) beside the vectors.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from jstsp19_torch.core import prng
from jstsp19_torch.solvers.bigamp_full import _per_realization


def prior_moments(prior):
    """(mean0, var0) of a prior module — the ``estimInit()`` analog
    (``rankOneFit.m:46-48``).  Supports the scalar priors used by the
    matrixFactor family (Awgn/CAwgn, spike-slab, discrete), told apart by
    the fields ``atoms`` and ``base`` as in JAX."""
    if hasattr(prior, "atoms"):  # DiscretePrior
        w = prior.weights / prior.weights.sum(-1, keepdim=True)
        m0 = (w * prior.atoms).sum(-1)
        v0 = (w * (prior.atoms - m0[..., None]).abs() ** 2).sum(-1)
        return m0, v0
    if hasattr(prior, "base"):  # SparsePrior
        mb, vb = prior_moments(prior.base)
        m0 = prior.p1 * mb
        v0 = prior.p1 * (vb + abs(mb) ** 2) - abs(m0) ** 2
        return m0, v0
    return prior.mean0, prior.var0


class RankOneResult(NamedTuple):
    u: torch.Tensor  # (B, m) estimate of u0
    v: torch.Tensor  # (B, n) estimate of v0
    corru: torch.Tensor  # (B, nit) predicted squared correlation of u
    corrv: torch.Tensor  # (B, nit) predicted squared correlation of v


def rank_one_fit(
    A: torch.Tensor,
    estimu,
    estimv,
    wvar,
    key=None,
    nit: int = 10,
    lin_est: bool = False,
    norm_uv: bool = True,
    vvar_init: Optional[float] = None,
    min_au: float = 0.01,
    min_av: float = 0.01,
) -> RankOneResult:
    """Fit A ≈ u·vᵀ (``rankOneFit.m``), A (B, m, n).

    ``estimu``/``estimv``: prior modules with ``estim(rhat, rvar)``;
    ``wvar`` a number or one a realization; ``key`` a ``torch.Generator``
    (None: the generator seeded with 0 on A's device, as JAX's
    ``prng.experiment_key(0)``).  ``lin_est=True`` selects the normalized
    linear (power-iteration) branch (``rankOneFit.m:107-116``); otherwise
    the MMSE branch with the reference's variance floors
    (``minau``/``minav``) and theoretical renormalization.
    """
    B, m, n = A.shape
    beta = n / m
    rdt, dev = A.real.dtype, A.device
    wvar = _per_realization(wvar, B, 1, rdt, dev)
    (umean0, uvar0), (vmean0, vvar0) = (
        (_per_realization(m0, B, 1, A.dtype, dev), _per_realization(v0, B, 1, rdt, dev))
        for m0, v0 in (prior_moments(estimu), prior_moments(estimv)))
    usq0 = umean0.abs() ** 2 + uvar0
    vsq0 = vmean0.abs() ** 2 + vvar0

    if key is None:
        key = torch.Generator(device=dev)
        key.manual_seed(0)
    v_init = vmean0.expand(B, n).clone()
    # rankOneFit.m seeds vhat randomly: a deterministic zero-mean init is an
    # exact fixed point of the alternating MMSE recursion (u = v = 0
    # forever).  vvar_init=None seeds at the prior's own variance; 0.0
    # forces the deterministic mean init.
    seed_var = vvar0 if vvar_init is None else (vvar_init if vvar_init > 0 else None)
    if seed_var is not None:
        v_init = v_init + torch.sqrt(torch.as_tensor(seed_var, dtype=rdt, device=dev)) \
            * prng.normal(key, (B, n), rdt, dev).to(A.dtype)

    eps = torch.finfo(rdt).tiny

    def norm(v):
        return torch.linalg.vector_norm(v, dim=-1, keepdim=True)

    def mean(v):
        return torch.as_tensor(v).expand(B, -1).mean(-1, keepdim=True)

    u = torch.zeros((B, m), dtype=A.dtype, device=dev)
    v = v_init
    muu = torch.zeros((B, 1), dtype=rdt, device=dev)
    av0 = torch.clamp(vmean0.abs() ** 2, min=1e-12).to(rdt)
    av1 = av0
    corrv = (vmean0.abs() ** 2 / torch.clamp(vsq0, min=eps)).to(rdt)
    corru_t, corrv_t = [], []
    for _ in range(nit):
        # ---- U half-step (rankOneFit.m:100-146) -------------------------
        p = (A @ v[..., None]).squeeze(-1) / m + muu * u
        if lin_est:
            scale = m**0.5 / torch.clamp(norm(p), min=eps)
            u = scale * p
            muv = -wvar * scale
            corru = beta * usq0 * vsq0 * corrv / (beta * usq0 * vsq0 * corrv + wvar)
            au0 = torch.ones((B, 1), dtype=rdt, device=dev)
            au1 = torch.sqrt(corru * usq0)
        else:
            pvar = beta * wvar * av0
            pscale = beta * av1
            y = p / pscale
            yvar1 = pvar / torch.clamp(pscale**2, min=eps)
            u, uvart = estimu.estim(y, yvar1)
            uvart = torch.clamp(mean(uvart), min=min_au * uvar0)
            uvart = torch.minimum(uvar0 * yvar1 / (uvar0 + yvar1), uvart)
            au1 = torch.maximum(usq0 - uvart, min_au * usq0)
            au0 = au1
            muv = -wvar * uvart / torch.clamp(yvar1, min=eps) / pscale
            corru = au1**2 / au0 / usq0
            if norm_uv:
                u = u * torch.sqrt(m * au0) / torch.clamp(norm(u), min=eps)

        # ---- V half-step (:160-215); .mH on the batched A ----------------
        q = (A.mH @ u[..., None]).squeeze(-1) / m + muv * v
        if lin_est:
            v = q
            muu = (-beta * wvar).expand(B, 1)
            corrv = usq0 * vsq0 * corru / (usq0 * vsq0 * corru + wvar)
            av0 = (q.abs() ** 2).sum(-1, keepdim=True) / n
            av1 = torch.sqrt(av0 * corrv * vsq0)
        else:
            qscale = au1
            qvar = wvar * au0
            y = q / qscale
            yvar1 = qvar / torch.clamp(qscale**2, min=eps)
            v, vvart = estimv.estim(y, yvar1)
            vvart = torch.clamp(mean(vvart), min=min_av * vvar0)
            av1 = torch.maximum(vsq0 - vvart, min_av * vsq0)
            av0 = av1
            corrv = av1**2 / av0 / vsq0
            muu = (-beta * wvar * vvart / torch.clamp(yvar1, min=eps) / qscale).to(rdt)
            if norm_uv:
                v = v * torch.sqrt(n * av0) / torch.clamp(norm(v), min=eps)
        corru_t.append(corru.reshape(B))
        corrv_t.append(corrv.reshape(B))

    return RankOneResult(u=u, v=v, corru=torch.stack(corru_t, -1), corrv=torch.stack(corrv_t, -1))


def mc_prior_mse(prior_sampler, prior, n_samples: int = 8192, seed: int = 0, device=None):
    """Monte-Carlo average denoiser MSE ``rvar ↦ E|x̂ − x⁰|²`` — the
    ``stateEvo`` ``MCEstimInAvg.avgMSE`` analog used by the SE recursion
    (``rankOneSE.m:75-80``).  ``prior_sampler(generator, n)`` draws the
    n signal samples; the generator is seeded with ``seed`` on ``device``
    (the card where there is one, else the CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    key = torch.Generator(device=device)
    key.manual_seed(seed)
    x0 = prior_sampler(key, n_samples)
    kw = prng.fold_in(key, 1)
    rdt = x0.real.dtype
    if x0.is_complex():
        w = torch.complex(prng.normal(kw, x0.shape, rdt, x0.device),
                          prng.normal(prng.fold_in(kw, 1), x0.shape, rdt, x0.device)) * 0.5**0.5
    else:
        w = prng.normal(kw, x0.shape, rdt, x0.device)

    def avg_mse(rvar):
        r = x0 + w * rvar**0.5
        xhat, _ = prior.estim(r, rvar)
        return ((xhat - x0).abs() ** 2).mean(-1)

    return avg_mse


def rank_one_se(
    mse_u: Callable,
    mse_v: Callable,
    beta: float,
    umean0,
    uvar0,
    vmean0,
    vvar0,
    wvar,
    nit: int = 10,
):
    """Scalar state evolution of the rank-one fit (``rankOneSE.m:96-109``):

        snru_t = β·vsq0/wvar·corrv_t;   corru_t = 1 − mse_u(1/snru)/usq0
        snrv_t = usq0/wvar·corru_t;     corrv_{t+1} = 1 − mse_v(1/snrv)/vsq0

    Returns (corru (nit,), corrv (nit+1,)) squared-correlation trajectories,
    float32 tensors as JAX's.
    """
    f32 = torch.float32

    def t(v):
        return torch.as_tensor(v).to(f32).cpu()

    umean0, uvar0, vmean0, vvar0, wvar = (t(v) for v in (umean0, uvar0, vmean0, vvar0, wvar))
    usq0 = umean0.abs() ** 2 + uvar0
    vsq0 = vmean0.abs() ** 2 + vvar0
    corrv0 = vmean0.abs() ** 2 / vsq0
    corrv, corru_t, corrv_t = corrv0, [], []
    for _ in range(nit):
        snru = beta * vsq0 / wvar * corrv
        corru = 1.0 - t(mse_u(1.0 / torch.clamp(snru, min=1e-30))) / usq0
        snrv = usq0 / wvar * corru
        corrv = 1.0 - t(mse_v(1.0 / torch.clamp(snrv, min=1e-30))) / vsq0
        corru_t.append(corru)
        corrv_t.append(corrv)
    return torch.stack(corru_t), torch.stack([corrv0] + corrv_t)
