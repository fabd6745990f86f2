"""Parametric bilinear GAMP (P-BiG-AMP) (counterpart of
``jstsp19_tpu/solvers/pbigamp.py``).

The reference's ``MPbased_solvers/PBiGAMP/`` (Parker & Schniter,
"Parametric bilinear generalized approximate message passing"): estimate two
parameter vectors b (Nb,) and c (Nc,) observed through

    z_m = b^T · A[m] · c,       y ~ p(y | z),   m = 1..M,

with a known (M, Nb, Nc) measurement tensor A, by the scalar-variance
simplification of the paper's Table I.

Batched: y (B, M), b (B, Nb), c (B, Nc); A is (B, M, Nb, Nc), one tensor a
realization, or (M, Nb, Nc) shared by all.  ‖A[m]‖²_F, the scalar
variances, the noise variance and every EM statistic are per realization,
(B, 1) beside the vectors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from jstsp19_torch.core import prng
from jstsp19_torch.solvers.bigamp_full import _per_realization
from jstsp19_torch.solvers.em import _bernoulli_gauss_em_update
from jstsp19_torch.solvers.estim import CAwgnPrior, SparsePrior


class PBigAmpResult(NamedTuple):
    b: torch.Tensor
    c: torch.Tensor
    z: torch.Tensor
    # final input-stage pseudo-data (Rb ≈ b + CN(0, rvar_b) etc.) — the
    # sufficient statistics the EM wrapper (EMPBiGAMP.m) consumes
    Rb: torch.Tensor = None
    rvar_b: torch.Tensor = None
    Rc: torch.Tensor = None
    rvar_c: torch.Tensor = None
    zvar: torch.Tensor = None


def _rand(key, shape, m0, v0, dtype, device):
    """mean + √var·noise from the prior's first two moments (keeps an
    informative mean — unity calibration gains — as the starting point)."""
    rdt = torch.empty((), dtype=dtype).real.dtype
    v0 = torch.as_tensor(v0, device=device).real.to(rdt)
    if dtype.is_complex:
        w = torch.complex(prng.normal(key, shape, rdt, device),
                          prng.normal(prng.fold_in(key, 1), shape, rdt, device)) * torch.sqrt(v0 / 2)
    else:
        w = prng.normal(key, shape, rdt, device) * torch.sqrt(v0)
    return w.to(dtype) + torch.as_tensor(m0, device=device).to(dtype)


def pbigamp(
    y: torch.Tensor,
    A: torch.Tensor,
    prior_b,
    prior_c,
    noise_var,
    key,
    nit: int = 100,
    step: float = 0.5,
    var_floor: float = 1e-9,
    likelihood=None,
    init_b=None,
    init_c=None,
) -> PBigAmpResult:
    """Run P-BiG-AMP on ``y ≈ z + w`` with ``z_m = b^T A[m] c``.

    y: (B, M); A: (B, M, Nb, Nc) or (M, Nb, Nc).  ``prior_b`` /
    ``prior_c`` are estimator modules of :mod:`jstsp19_torch.solvers.estim`;
    ``likelihood`` optionally replaces the default AWGN output stage;
    ``key`` a ``torch.Generator``.  The bilinear scale ambiguity (b, c) ↦
    (αb, c/α) is resolved only up to the priors' second moments — evaluate
    recovered z (ambiguity-free) or align factors before comparing.
    """
    Bt, M = y.shape
    A4 = A if A.dim() == 4 else A[None]
    _, _, Nb, Nc = A4.shape
    cdt = torch.result_type(y, A)
    rdt = torch.empty((), dtype=cdt).real.dtype
    dev = y.device

    A2 = A4.abs() ** 2
    A2_sum = A2.sum((2, 3))  # (B or 1, M) ‖A[m]‖²_F
    A2_b = A2.sum(3)  # (B or 1, M, Nb) Σ_j |A_mij|²
    A2_c = A2.sum(2)  # (B or 1, M, Nc) Σ_i |A_mij|²

    def mv(T, v):
        """(…, M, P, Q) against one (B, Q) vector a realization: (B, M, P)."""
        return (T @ v[:, None, :, None]).squeeze(-1)

    def mvt(T, v):
        """(…, M, P, Q) against one (B, P) vector a realization: (B, M, Q)."""
        return (v[:, None, None, :] @ T).squeeze(-2)

    def sq(T, v):
        """(…, M, P) · (B, P) -> (B, M)."""
        return (T @ v[..., None]).squeeze(-1)

    kb, kc = prng.split(key, 2)
    mb, vb0 = prior_b.init_moments()
    mc, vc0 = prior_c.init_moments()
    bhat = init_b if init_b is not None else _rand(kb, (Bt, Nb), mb, vb0, cdt, dev)
    chat = init_c if init_c is not None else _rand(kc, (Bt, Nc), mc, vc0, cdt, dev)
    bhat, chat = bhat.to(cdt), chat.to(cdt)
    vb = _per_realization(vb0, Bt, 1, rdt, dev)
    vc = _per_realization(vc0, Bt, 1, rdt, dev)
    shat = torch.zeros((Bt, M), dtype=cdt, device=dev)
    nv = _per_realization(noise_var, Bt, 1, rdt, dev)
    A4 = A4.to(cdt)

    Rb, rvar_b = bhat, torch.ones((Bt, Nb), dtype=rdt, device=dev)
    Rc, rvar_c = chat, torch.ones((Bt, Nc), dtype=rdt, device=dev)
    vz = torch.zeros((Bt, M), dtype=rdt, device=dev)
    for _ in range(nit):
        # forward derivatives of z_m in b and c
        za = mv(A4, chat)  # ∂z_m/∂b_i, (B, M, Nb)
        zc = mvt(A4, bhat)  # ∂z_m/∂c_j, (B, M, Nc)
        zhat = (za * bhat[:, None, :]).sum(-1)
        b2 = bhat.abs() ** 2
        c2 = chat.abs() ** 2

        # output linear stage: |A|²-weighted magnitudes (the GAMP sq_mv
        # form) from the precomputed |A|² marginals
        vp_bar = vb * sq(A2_c, c2) + vc * sq(A2_b, b2)
        vp = torch.clamp(vp_bar + vb * vc * A2_sum, min=var_floor)
        phat = zhat - shat * vp_bar

        # output nonlinear stage
        if likelihood is not None:
            z0, vz = likelihood.estim(phat, vp)
        else:
            gain = vp / (vp + nv)
            z0 = phat + gain * (y - phat)
            vz = gain * nv
        shat_new = (z0 - phat) / vp
        vs = torch.clamp((1.0 - vz / vp) / vp, min=var_floor)
        shat_new = step * shat_new + (1 - step) * shat

        # input linear stage, b side: the denominator includes the (c² + vc)
        # uncertainty, so the Onsager multiplier 1 − on/den stays in (0, 1]
        den_b = torch.clamp((vs[..., None] * mv(A2, c2 + vc)).sum(1), min=var_floor)
        rvar_b = 1.0 / den_b
        on_b = vc * (vs[..., None] * A2_b).sum(1)
        Rb = bhat * (1.0 - on_b / den_b) + rvar_b * (shat_new[..., None] * za.conj()).sum(1)
        # input linear stage, c side
        den_c = torch.clamp((vs[..., None] * mvt(A2, b2 + vb)).sum(1), min=var_floor)
        rvar_c = 1.0 / den_c
        on_c = vb * (vs[..., None] * A2_c).sum(1)
        Rc = chat * (1.0 - on_c / den_c) + rvar_c * (shat_new[..., None] * zc.conj()).sum(1)

        # input nonlinear stage (means and scalar variances both damped)
        bn, vbn = prior_b.estim(Rb, rvar_b)
        cn, vcn = prior_c.estim(Rc, rvar_c)
        bhat = step * bn + (1 - step) * bhat
        chat = step * cn + (1 - step) * chat
        vb = step * torch.clamp(vbn.mean(-1, keepdim=True), min=var_floor) + (1 - step) * vb
        vc = step * torch.clamp(vcn.mean(-1, keepdim=True), min=var_floor) + (1 - step) * vc
        shat = shat_new

    z = (mv(A4, chat) * bhat[:, None, :]).sum(-1)
    return PBigAmpResult(b=bhat, c=chat, z=z, Rb=Rb, rvar_b=rvar_b, Rc=Rc, rvar_c=rvar_c,
                         zvar=torch.broadcast_to(vz, (Bt, M)))


class EmPBigAmpResult(NamedTuple):
    b: torch.Tensor
    c: torch.Tensor
    z: torch.Tensor
    noise_var: torch.Tensor  # (B, 1)
    prior_c: object  # SparsePrior(CAwgnPrior), p1 and the slab variance (B, 1)


def em_pbigamp(
    y,
    A,
    key,
    n_em: int = 8,
    nit: int = 100,
    step: float = 0.5,
    prior_b=None,
    b_mean: complex = 1.0,
    b_var: float = 0.1,
) -> EmPBigAmpResult:
    """EM-P-BiG-AMP (``PBiGAMP/EMPBiGAMP.m``): learns the AWGN noise
    variance, the sparse-c prior's activity/slab variance, and the b
    prior's variance around the P-BiG-AMP inner solver, each per
    realization.

    Defaults match the reference's calibration setup: b ~ CN(b_mean, b_var)
    (e.g. unity-gain sensors) and c Bernoulli-Gaussian with EM-learned
    hyperparameters; the initial noise variance follows the 100:1 SNR rule
    of ``EMPBiGAMP.m:119-126``.
    """
    M = y.shape[-1]
    nv = (y.abs() ** 2).sum(-1, keepdim=True) / (M * 101.0)
    if prior_b is None:
        prior_b = CAwgnPrior(b_mean, b_var)
    rho0 = 0.1
    prior_c = SparsePrior(CAwgnPrior(0j, (y.abs() ** 2).mean(-1, keepdim=True)), rho0)
    res = None
    for i in range(n_em):
        res = pbigamp(y, A, prior_b, prior_c, nv, prng.fold_in(key, i), nit=nit, step=step,
                      init_b=None if res is None else res.b, init_c=None if res is None else res.c)
        # EM noise update (EMPBiGAMP noise_var learning): residual + zvar
        nv = torch.clamp(((y - res.z).abs() ** 2).mean(-1, keepdim=True) + res.zvar.mean(-1, keepdim=True),
                         min=1e-12)
        # EM of the sparse-c prior from the final pseudo-data
        prior_c = _bernoulli_gauss_em_update(prior_c, res.Rc, res.rvar_c, (-1,))
        # EM of the b prior's variance: posterior second moment of
        # (b − mean) from the final pseudo-data, per realization
        bhat, bvar = prior_b.estim(res.Rb, res.rvar_b)
        var_new = torch.clamp(((bhat - prior_b.mean0).abs() ** 2 + bvar).mean(-1, keepdim=True), min=1e-8)
        prior_b = CAwgnPrior(prior_b.mean0, var_new)
    return EmPBigAmpResult(b=res.b, c=res.c, z=res.z, noise_var=nv, prior_c=prior_c)
