"""VAMP for the generalized linear model, natively complex, matrix form,
batched (counterpart of ``jstsp19_tpu/solvers/vamp.py``: ``vamp_glm``,
``vamp_glm_se``, ``cawgn_likelihood_mse``, ``mc_likelihood_mse`` and
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
(batch, 1, 1) tensor.  The state evolution describes one ensemble: its
scalars are 0-d tensors, its draws come from a ``torch.Generator`` seeded
with ``seed`` on the spectrum's device, or are given (``draws``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from jstsp19_torch.core import prng
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
    # E|x1 − x0|² per realization and iteration, (..., nit), where a ground
    # truth is given (the reference's fxnErr hook, VampGlmEst.m:280-290)
    mse_track: Optional[torch.Tensor] = None


def _mean2(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last two axes, kept as (..., 1, 1); a variance that is
    already one per matrix passes as it is."""
    return x if x.shape[-2:] == (1, 1) else x.mean(dim=(-2, -1), keepdim=True)


def _x_dtype(likelihood, r1_init):
    """The state's dtype and a tensor that carries the batch: from y (promoted
    to complex64), else from ``r1_init`` (the same), else from the
    likelihood's tensors as they are (the quantized few-bit channel is a real
    model), as the JAX function decides."""
    y = getattr(likelihood, "y", None)
    if y is not None:
        return torch.promote_types(y.dtype, torch.complex64), y
    if r1_init is not None:
        return torch.promote_types(r1_init.dtype, torch.complex64), r1_init
    leaves = [v for v in (getattr(likelihood, f.name) for f in dataclasses.fields(likelihood))
              if isinstance(v, torch.Tensor)]
    dt = leaves[0].dtype
    for v in leaves[1:]:
        dt = torch.promote_types(dt, v.dtype)
    return dt, max(leaves, key=lambda v: v.dim())


def vamp_glm(prior, likelihood, op: KronDictOp, nit: int = 100, damp: float = 0.85,
             r1_init: Optional[torch.Tensor] = None, track_x0: Optional[torch.Tensor] = None) -> VampResult:
    """Run VAMP-GLM for ``y ~ p(y | op.mv(x))``, batched over the leading
    dimensions of ``op``'s factors and the likelihood's observation.

    ``prior``/``likelihood`` are modules of :mod:`jstsp19_torch.solvers.estim`;
    ``op`` exposes ``mv``/``rmv`` and the Gram eigenbases
    (``VampGlmEst.m:350-521`` in operator form).  ``r1_init`` replaces the
    start r1 = 1e-7j; with ``track_x0`` (the truth, (..., Gr, K)) the result
    carries E|x1 − x0|² per iteration.
    """
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

    dt, ref = _x_dtype(likelihood, r1_init)
    batch = torch.broadcast_shapes(op.A.shape[:-2], op.B.shape[:-2], ref.shape[:-2])
    dev = ref.device
    rdt = dt.to_real()
    tiny = torch.finfo(rdt).tiny
    col = batch + (1, 1)
    if r1_init is not None:
        r1 = torch.as_tensor(r1_init, dtype=dt, device=dev).expand(batch + in_shape)
    else:  # r1init = eps*1i (vamp.m:44); a real state starts at 0
        r1 = torch.full(batch + in_shape, 1e-7j if dt.is_complex else 0.0, dtype=dt, device=dev)
    p1 = torch.zeros(batch + out_shape, dtype=dt, device=dev)
    gam1x = torch.full(col, GAM_MIN, dtype=rdt, device=dev)
    gam1z = torch.full(col, GAM_MIN, dtype=rdt, device=dev)
    x1_prev = torch.zeros(batch + in_shape, dtype=dt, device=dev)
    best_x1, best_z1 = x1_prev, p1
    best_gam1x, best_gam1z = gam1x, gam1z
    best_rc = torch.full(col, torch.inf, dtype=rdt, device=dev)
    mse_track = []

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

        if track_x0 is not None:
            mse_track.append(((x1 - track_x0).abs() ** 2).mean((-2, -1)))
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

    return VampResult(x=best_x1, z=best_z1, gam1x=best_gam1x, gam1z=best_gam1z,
                      mse_track=torch.stack(mse_track, -1) if track_x0 is not None else None)


def vamp_glm_se(prior_sampler, prior, likelihood_mse, d_spectrum, N: int, delta: float, nit: int = 50,
                n_samples: int = 4096, seed: int = 0, draws=None) -> torch.Tensor:
    """State evolution of VAMP-GLM (``VAMP/VampGlmSE.m:1-35``): the predicted
    denoiser MSE ``1/eta1x`` per iteration, (nit,), to hold against
    :func:`vamp_glm`'s ``mse_track``.

    ``prior_sampler(gen, n)`` draws x⁰ (the ``EstimInAvg`` analog);
    ``likelihood_mse(pvar)`` returns (mse1z, zvar), the output stage's
    average (:func:`cawgn_likelihood_mse`, :func:`mc_likelihood_mse`);
    ``d_spectrum`` holds the min(M, N) nonzero eigenvalues of the operator's
    Gram (``VampGlmSE.m:27``) and sets the device; N is the input dimension
    and delta M/N; ``draws`` = (x⁰, noise) replaces the draws.
    """
    d = torch.as_tensor(d_spectrum).to(torch.float32)
    if draws is None:
        gen = torch.Generator(device=d.device).manual_seed(seed)
        x0 = prior_sampler(gen, n_samples)
        noise = prng.complex_normal(gen, x0.shape, var=1.0)
    else:
        x0, noise = draws
    gam1x = torch.tensor(GAM_MIN, dtype=torch.float32, device=d.device)
    gam1z = gam1x
    mses = []
    for _ in range(nit):
        # the nonlinear stage (VampGlmSE.m:19-24)
        xhat, _ = prior.estim(x0 + noise / torch.sqrt(gam1x), 1.0 / gam1x)
        mse1x = torch.clamp(((xhat - x0).abs() ** 2).mean(), min=1e-30)
        mses.append(mse1x)
        eta1x = 1.0 / mse1x
        gam2x = torch.clamp(torch.maximum(eta1x - gam1x, 1e-3 * eta1x), max=GAM_MAX)
        _, zvar = likelihood_mse(1.0 / gam1z)
        eta1z = 1.0 / torch.clamp(torch.as_tensor(zvar), min=1e-30)
        gam2z = torch.clamp(torch.maximum(eta1z - gam1z, 1e-3 * eta1z), max=GAM_MAX)
        # the linear stage (:27-31)
        alf = torch.clamp((d / (d + gam2x / gam2z)).sum() / N, 1e-6, min(1.0, delta) * (1.0 - 1e-6))
        gam1x = torch.clamp(gam2x * alf / (1.0 - alf), GAM_MIN, GAM_MAX)
        gam1z = torch.clamp(gam2z * (delta - alf) / alf, GAM_MIN, GAM_MAX)
    return torch.stack(mses)


def cawgn_likelihood_mse(wvar):
    """The AWGN output stage's average in closed form
    (``demoVampGlm.m:203``): mse1z = zvar = 1/(1/wvar + 1/pvar)."""

    def mse(pvar):
        v = 1.0 / (1.0 / wvar + 1.0 / pvar)
        return v, v

    return mse


def mc_likelihood_mse(likelihood_from_y, channel_sampler, phat, seed: int = 0, draws=None):
    """Monte-Carlo output-stage average for a non-Gaussian channel (the
    ``stateEvo/EstimOutAvg.m`` analog): draws z = phat + √pvar·e, e ~ CN(0, 1)
    once, y ~ p(y|z) by ``channel_sampler(gen, z)`` with the generator in the
    same state every call, and reports (E|ẑ−z|², E[zvar]) of
    ``likelihood_from_y(y).estim(phat, pvar)``.  Draws on phat's device from
    a generator of its own (not the one ``vamp_glm_se`` seeds with the same
    ``seed``), or takes ``draws`` = e."""
    gen = torch.Generator(device=phat.device).manual_seed(prng.role_seed(seed, 7919, 0))
    e = draws if draws is not None else prng.complex_normal(gen, phat.shape, var=1.0)
    state = gen.get_state()

    def mse(pvar):
        z = phat + torch.sqrt(torch.as_tensor(pvar)) * e
        gen.set_state(state)
        zhat, zvar = likelihood_from_y(channel_sampler(gen, z)).estim(phat, pvar)
        return ((zhat - z).abs() ** 2).mean(), torch.as_tensor(zvar).mean()

    return mse


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
