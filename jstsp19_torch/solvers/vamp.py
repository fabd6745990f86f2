"""VAMP for the generalized linear model, natively complex, matrix form,
batched (counterpart of ``jstsp19_tpu/solvers/vamp.py``: ``vamp_glm`` and
``vamp_mmwave``).

As in the JAX package (whose module note gives the reasons): no real
2×-embedding; the unknown stays a (Gr, K) matrix; the LMMSE stage runs in the
factorized eigenbasis of the implicit Kronecker operator
(``KronDictOp.gram_out_eig``); a fixed number of iterations; damping on the
extrinsic messages; and the float32 guards the reference needs — the
keep-best argmin, the relative γ floor and the 1e6 message cap.  Where the
JAX package vmaps one realization, here every matrix has the Monte-Carlo
batch as its leading dimension and every scalar of the carry (γ1x, γ1z, α,
the best step, the cap's scale) is one per realization, kept as a
(batch, 1, 1) tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from jstsp19_torch.ops.kron import KronDictOp
from jstsp19_torch.solvers.estim import CAwgnLikelihood, CAwgnPrior, SparsePrior

GAM_MIN = 1e-8  # VampGlmOpt.m:7
GAM_MAX = 1e14  # VampGlmOpt.m:8
MSG_CAP = 1e6  # the divergence guard's message cap


class VampResult(NamedTuple):
    x: torch.Tensor  # (..., Gr, K) posterior estimate (denoiser output x1)
    z: torch.Tensor  # (..., N, M) transform-domain estimate z1
    gam1x: torch.Tensor  # (..., 1, 1)
    gam1z: torch.Tensor  # (..., 1, 1)


def _mean2(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last two axes, kept as (..., 1, 1); a variance that is
    already one per matrix passes as it is."""
    return x if x.shape[-2:] == (1, 1) else x.mean(dim=(-2, -1), keepdim=True)


def vamp_glm(prior, likelihood, op: KronDictOp, nit: int = 100, damp: float = 0.85) -> VampResult:
    """Run VAMP-GLM for ``y ~ p(y | op.mv(x))``, batched over the leading
    dimensions of ``op``'s factors and ``likelihood.y``.

    ``prior``/``likelihood`` are modules of :mod:`jstsp19_torch.solvers.estim`;
    ``op`` exposes ``mv``/``rmv`` and the Gram eigenbases
    (``VampGlmEst.m:350-521`` in operator form).
    """
    y = likelihood.y
    batch = torch.broadcast_shapes(op.A.shape[:-2], op.B.shape[:-2], y.shape[:-2])
    in_shape, out_shape = op.in_shape, op.out_shape
    N = in_shape[0] * in_shape[1]
    M = out_shape[0] * out_shape[1]
    delta = M / N
    out_branch = M <= N  # which Gram gets diagonalized (VampGlmEst.m:55-66)
    Ua, Ub, d = op.gram_out_eig() if out_branch else op.gram_in_eig()

    def U(Z):
        return op.from_eigbasis(Ua, Ub, Z)

    def Uh(Z):
        return op.to_eigbasis(Ua, Ub, Z)

    # complex64 unless y is wider, as the JAX function takes its dtype from y
    dt, dev = torch.promote_types(y.dtype, torch.complex64), y.device
    rdt = dt.to_real()
    tiny = torch.finfo(rdt).tiny
    col = batch + (1, 1)
    r1 = torch.full(batch + in_shape, 1e-7j, dtype=dt, device=dev)  # r1init = eps*1i (vamp.m:44)
    p1 = torch.zeros(batch + out_shape, dtype=dt, device=dev)
    gam1x = torch.full(col, GAM_MIN, dtype=rdt, device=dev)
    gam1z = torch.full(col, GAM_MIN, dtype=rdt, device=dev)
    x1_prev = torch.zeros(batch + in_shape, dtype=dt, device=dev)
    best_x1, best_z1 = x1_prev, p1
    best_gam1x, best_gam1z = gam1x, gam1z
    best_rc = torch.full(col, torch.inf, dtype=rdt, device=dev)

    for i in range(nit):
        first = i == 0
        # ---- denoising stage (VampGlmEst.m:364-379) -----------------------
        x1, xvar1 = prior.estim(r1, 1.0 / gam1x)
        eta1x = 1.0 / torch.clamp(_mean2(xvar1), min=1e-30)
        # relative floor: a near-zero extrinsic precision divides into r2
        gam2x = torch.maximum(eta1x - gam1x, 1e-3 * eta1x).clamp(max=GAM_MAX)
        r2 = (x1 * eta1x - r1 * gam1x) / gam2x

        # ---- likelihood stage (:381-393) ----------------------------------
        z1, zvar1 = likelihood.estim(p1, 1.0 / gam1z)
        eta1z = 1.0 / torch.clamp(_mean2(zvar1), min=1e-30)
        gam2z = torch.maximum(eta1z - gam1z, 1e-3 * eta1z).clamp(max=GAM_MAX)
        p2 = (z1 * eta1z - p1 * gam1z) / gam2z

        # ---- LMMSE stage in the factorized eigenbasis (:398-411) ----------
        inv_d = 1.0 / (d + gam2x / gam2z)
        alf = torch.sum(d * inv_d, dim=(-2, -1), keepdim=True) / N
        alf = torch.clamp(alf, 1e-6, min(1.0, delta) * (1.0 - 1e-6))
        if out_branch:
            Ar2 = op.mv(r2)
            Up = Uh(p2 - Ar2) * inv_d
            x2 = r2 + op.rmv(U(Up))
            z2 = Ar2 + U(d * Up)
        else:  # M > N: solve (K2ᴴK2 + ratio·I) x2 = K2ᴴ p2 + ratio·r2
            x2 = U(Uh(r2 * (gam2x / gam2z) + op.rmv(p2)) * inv_d)
            z2 = op.mv(x2)

        # ---- extrapolation back (:467-495), difference form, damped -------
        r1n = x2 + ((1 - alf) / alf) * (x2 - r2)
        p1n = z2 + (alf / (delta - alf)) * (z2 - p2)
        gam1xn = torch.clamp(gam2x * alf / (1 - alf), GAM_MIN, GAM_MAX)
        gam1zn = torch.clamp(gam2z * (delta - alf) / alf, GAM_MIN, GAM_MAX)
        if not first:
            r1n = damp * r1n + (1 - damp) * r1
            p1n = damp * p1n + (1 - damp) * p1
            gam1xn = damp * gam1xn + (1 - damp) * gam1x
            gam1zn = damp * gam1zn + (1 - damp) * gam1z

        # divergence guard: rescale runaway messages (the estimate is
        # already garbage there, its reported NMSE at the clamp)
        for_msg = torch.maximum(r1n.abs().amax(dim=(-2, -1), keepdim=True),
                                p1n.abs().amax(dim=(-2, -1), keepdim=True))
        scale = torch.where(for_msg > MSG_CAP, MSG_CAP / for_msg, 1.0)
        r1n = r1n * scale
        p1n = p1n * scale

        # keep-best: the iterate with the smallest relative step
        if first:
            rc = torch.full(col, torch.inf, dtype=rdt, device=dev)
            better = torch.ones(col, dtype=torch.bool, device=dev)
        else:
            rc = torch.sum((x1 - x1_prev).abs() ** 2, dim=(-2, -1), keepdim=True) / torch.clamp(
                torch.sum(x1.abs() ** 2, dim=(-2, -1), keepdim=True), min=tiny)
            better = rc < best_rc
        best_x1 = torch.where(better, x1, best_x1)
        best_z1 = torch.where(better, z1, best_z1)
        best_gam1x = torch.where(better, gam1x, best_gam1x)
        best_gam1z = torch.where(better, gam1z, best_gam1z)
        best_rc = torch.minimum(rc, best_rc)
        r1, p1, gam1x, gam1z, x1_prev = r1n, p1n, gam1xn, gam1zn, x1

    return VampResult(x=best_x1, z=best_z1, gam1x=best_gam1x, gam1z=best_gam1z)


def vamp_mmwave(
    Y_hbf: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    noise_var,
    num_nonzero: int,
    nit: int = 100,
    damp: float = 0.85,
) -> torch.Tensor:
    """The jstsp19 VAMP baseline in matrix form, batched: ``Y ≈ A·X·B`` with a
    Bernoulli-CN spike-slab prior of activity ``numOfnz / (2·N_complex)``
    (``vamp.m:23-25``) and a CN(y, noise_var) likelihood; ``noise_var`` is a
    number or one per realization.  Each factor is scaled to unit spectral
    norm and the observation and noise with them, as the JAX package does
    for float32."""
    sa = torch.sqrt(torch.linalg.eigvalsh(A.mH @ A)[..., -1])[..., None, None]
    sb = torch.sqrt(torch.linalg.eigvalsh(B @ B.mH)[..., -1])[..., None, None]
    s = sa * sb
    op = KronDictOp((A / sa).contiguous(), (B / sb).contiguous())
    Gr, K = op.in_shape
    beta = num_nonzero / (2 * Gr * K)
    prior = SparsePrior(CAwgnPrior(0.0, 1.0 / beta), beta)  # xvar1 = xvar0/beta, vamp.m:24
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=Y_hbf.device)
    nv = nv[..., None, None] if nv.dim() else nv
    likelihood = CAwgnLikelihood(Y_hbf / s, nv / s**2)
    return vamp_glm(prior, likelihood, op, nit=nit, damp=damp).x
