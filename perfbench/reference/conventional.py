"""The conventional-HBF baselines of ``plot_errorVSsnr.m``, written out plainly.

The conventional receiver (``plot_errorVSsnr.m:73-121``) combines all Nr
antenna outputs with the first Nr columns of the analog combiner, and for a
fair training budget listens for only T_hbf = round(T / (Nr/Mr))·Nt of the
proposed receiver's T·Nt instants: its observation is the first T_hbf columns
of the same received frame, Y_c = W_cᴴ·R, under A_c = W_cᴴ·Dr and the blocks
B_c of Dtᴴ·Psi over those columns.  On that problem:

- LS (``:83``): pinv(A_c)·Y_c·pinv(B_c);
- MMV-OMP (``:116-121``): sparse-plex's joint OMP on V = Y_c·pinv(B_c) with
  min(numOfnz, Gr) atoms: each step takes the atom whose correlation row
  with the residual has the largest l2 norm, then refits every column by
  least squares on the support.  At numOfnz ≥ Gr every atom enters and the
  answer is the one least-squares fit on all of them;
- VAMP (``VampGlmEst.m`` with ``vamp.m``'s settings, ``:79-100``): y =
  vec(Y_c·B_cᴴ) = Φ·vec(S) + w with Φ = kron((B_c·B_cᴴ)ᵀ, A_c), the
  Bernoulli-CN prior of activity numOfnz / (2·Gr·K) and slab variance one
  over that (``vamp.m:23-25``), the noise variance 1 that the script passes
  (``:100``), the damping and the number of iterations of the point.

Its departures from ``VampGlmEst.m``, each a float32 guard without which
single precision diverges where MATLAB's double does not:

- both factors of Φ are scaled to unit spectral norm, and y and the noise
  variance with them (the model is the same; the floors below then act on
  numbers near one);
- the precision floor: an extrinsic precision η − γ is kept at least 1e-3·η,
  and every precision in [1e-8, 1e14] (``VampGlmOpt.m:7-8``);
- the message cap: where r1 or p1 holds an entry above 1e6 in magnitude, both
  are scaled down so that the largest is 1e6;
- keep-best: the answer is the denoiser's output x1 at the iteration whose
  relative step ‖x1 − x1_prev‖² / ‖x1‖² is the smallest (the first iteration's
  output where none is smaller than infinity).

The LMMSE stage runs in the SVD bases of the two factors, since the SVD of a
Kronecker product is the product of theirs: with A = Ua·Σa·Vaᴴ and
F = B_c·B_cᴴ = Uf·Σf·Vfᴴ, Φ acts on X̃ = Vaᴴ·X·Uf as Uaᴴ·(A·X·F)·Vf = σa σfᵀ ⊙ X̃,
entry by entry, so no Gr·K × Nr·K matrix is formed.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

from perfbench.reference.frontend import Products

GAM_MIN, GAM_MAX = 1e-8, 1e14  # VampGlmOpt.m:7-8
MSG_CAP = 1e6
FLOOR = 1e-3  # an extrinsic precision keeps at least this share of the posterior's


def t_hbf(point: Mapping) -> int:
    """The conventional receiver's training length round(T / (Nr/Mr))·Nt,
    MATLAB's round: halves away from zero (``plot_errorVSsnr.m:73``)."""
    return int(math.floor(point["T"] / (point["Nr"] / point["Mr"]) + 0.5)) * point["Nt"]


def problem(point: Mapping, rx: Mapping[str, torch.Tensor], W: torch.Tensor, mm: Products) -> Dict[str, torch.Tensor]:
    """Y_c (B, Nr, T_hbf), A_c (B, Nr, Gr), B_c (B, L·Gt, T_hbf) and Zbar from
    :func:`frontend.received`'s ``rx`` and the (Nr, Nr) combiner ``W``."""
    L, Nr, Gt = point["L"], point["Nr"], point["Gt"]
    th = t_hbf(point)
    R, Psi, Zbar = rx["R"], rx["Psi"], rx["Zbar"]
    batch = R.shape[0]
    W_c = W[:, :Nr]
    Y_c = mm(W_c.mH, R[..., :th])
    A_c = mm(W_c.mH, rx["Dr"]).expand(batch, Nr, rx["Dr"].shape[-1]).contiguous()
    B_c = mm(rx["Dt"].mH, Psi[..., :th]).reshape(batch, L * Gt, th)
    return dict(Y_c=Y_c, A_c=A_c, B_c=B_c, Zbar=Zbar)


def pinv(X: torch.Tensor, mm: Products) -> torch.Tensor:
    """The pseudo-inverse through the SVD: singular values at or below
    10·max(m, n)·eps(float32) times the largest are rounding and are dropped."""
    U, s, Vh = torch.linalg.svd(X, full_matrices=False)
    cut = 10.0 * max(X.shape[-2:]) * torch.finfo(torch.float32).eps * s[..., :1]
    inv = torch.where(s > cut, 1.0 / torch.where(s > cut, s, torch.ones_like(s)), torch.zeros_like(s))
    return mm(Vh.mH * inv[..., None, :].to(X.dtype), U.mH)


def ls(prob: Mapping[str, torch.Tensor], mm: Products) -> torch.Tensor:
    """pinv(A_c)·Y_c·pinv(B_c), (B, Gr, K)."""
    return mm(mm(pinv(prob["A_c"], mm), prob["Y_c"]), pinv(prob["B_c"], mm))


def omp_mmv(prob: Mapping[str, torch.Tensor], atoms: int, mm: Products) -> torch.Tensor:
    """Joint OMP of V = Y_c·pinv(B_c) on the dictionary A_c with ``atoms``
    atoms, (B, Gr, K).  The least-squares fit on a support is pinv of the
    dictionary with the other columns zeroed, whose rows there are zero."""
    A = prob["A_c"]
    V = mm(prob["Y_c"], pinv(prob["B_c"], mm))
    Gr = A.shape[-1]
    if atoms >= Gr:
        return mm(pinv(A, mm), V)
    chosen = torch.zeros(A.shape[0], Gr, dtype=torch.bool, device=A.device)
    X = torch.zeros(A.shape[0], Gr, V.shape[-1], dtype=V.dtype, device=V.device)
    for _ in range(atoms):
        corr = mm(A.mH, V - mm(A, X))
        score = torch.where(chosen, -torch.inf, corr.abs().pow(2).sum(dim=-1))
        chosen = chosen | torch.nn.functional.one_hot(score.argmax(dim=-1), Gr).bool()
        X = mm(pinv(A * chosen[:, None, :], mm), V)
    return X


class Kron:
    """Φ = kron(Fᵀ, A), X ↦ A·X·F with A (B, n, Gr) and F (B, K, K), in the
    SVD bases of its factors, each scaled to unit spectral norm: ``scale``
    (B, 1, 1) is the product of the two norms taken out."""

    def __init__(self, A: torch.Tensor, F: torch.Tensor, mm: Products):
        self.mm = mm
        self.Ua, sa, self.Vah = torch.linalg.svd(A)
        self.Uf, sf, self.Vfh = torch.linalg.svd(F)
        self.scale = (sa[:, :1] * sf[:, :1])[..., None]
        self.n_out, self.Gr, self.K = A.shape[-2], A.shape[-1], F.shape[-1]
        self.r = min(self.n_out, self.Gr)  # the rows of X̃ = Vaᴴ·X·Uf and of Z̃ = Uaᴴ·Z·Vf that Φ couples
        self.sig = (sa[:, :self.r] / sa[:, :1])[..., None] * (sf / sf[:, :1])[:, None, :]  # (B, r, K)

    def lmmse(self, r2: torch.Tensor, p2: torch.Tensor, ratio: torch.Tensor):
        """(x2, z2, alpha): x2 = argmin |p2 − Φ·x|² + ratio·|x − r2|² of the
        scaled Φ, z2 = Φ·x2, and alpha = tr(ΦᴴΦ·(ΦᴴΦ + ratio)⁻¹) / (Gr·K)."""
        mm, r, sig = self.mm, self.r, self.sig
        xt = mm(mm(self.Vah, r2), self.Uf)
        pt = mm(mm(self.Ua.mH, p2), self.Vfh.mH)
        xt_r = (sig * pt[:, :r] + ratio * xt[:, :r]) / (sig ** 2 + ratio)
        xt = torch.cat([xt_r, xt[:, r:]], dim=1)
        zt = torch.cat([sig * xt_r, torch.zeros_like(pt[:, r:])], dim=1)
        x2 = mm(mm(self.Vah.mH, xt), self.Uf.mH)
        z2 = mm(mm(self.Ua, zt), self.Vfh)
        alpha = (sig ** 2 / (sig ** 2 + ratio)).sum(dim=(-2, -1), keepdim=True) / (self.Gr * self.K)
        return x2, z2, alpha


def vamp(prob: Mapping[str, torch.Tensor], point: Mapping, mm: Products) -> torch.Tensor:
    """VAMP's estimate of S, (B, Gr, K), on the normal-equation form of the
    conventional problem, with the noise variance 1 that the script passes
    (``plot_errorVSsnr.m:100``)."""
    Y_c, B_c = prob["Y_c"], prob["B_c"]
    phi = Kron(prob["A_c"], mm(B_c, B_c.mH), mm)
    y = mm(Y_c, B_c.mH) / phi.scale  # (B, Nr, K)
    wvar = 1.0 / phi.scale ** 2
    batch, Gr, K = y.shape[0], phi.Gr, phi.K
    delta = phi.n_out / Gr

    beta = point["num_nonzero"] / (2 * Gr * K)
    var0 = 1.0 / beta
    log_odds = math.log((1.0 - beta) / beta)
    eps = torch.finfo(torch.float32).eps
    damp = point["vamp_damp"]

    def denoise(r1, gam):
        """The Bernoulli-CN posterior mean and mean variance at r1 = x + CN(0, 1/gam)."""
        rvar = torch.clamp(1.0 / gam, min=eps)
        gain = var0 / (var0 + rvar)
        # log P(x = 0 | r1) / P(x ≠ 0 | r1)
        arg = torch.log1p(var0 / rvar) - r1.abs() ** 2 * (gain / rvar) + log_odds
        active = torch.sigmoid(-torch.clamp(arg, -500.0, 500.0))
        slab = gain * r1
        var = active * (1.0 - active) * slab.abs() ** 2 + active * gain * rvar
        return active * slab, var.mean(dim=(-2, -1), keepdim=True)

    def extrinsic(eta, gam):
        return torch.clamp(torch.maximum(eta - gam, FLOOR * eta), max=GAM_MAX)

    col = (batch, 1, 1)
    real = dict(dtype=y.real.dtype, device=y.device)
    r1 = torch.full((batch, Gr, K), 1e-7j, dtype=y.dtype, device=y.device)
    p1 = torch.zeros_like(y)
    gam1x = torch.full(col, GAM_MIN, **real)
    gam1z = torch.full(col, GAM_MIN, **real)
    x_prev = best = torch.zeros_like(r1)
    best_step = torch.full(col, torch.inf, **real)
    for i in range(point["vamp_nit"]):
        # denoiser
        x1, xvar = denoise(r1, gam1x)
        eta1x = 1.0 / torch.clamp(xvar, min=1e-30)
        gam2x = extrinsic(eta1x, gam1x)
        r2 = (eta1x * x1 - gam1x * r1) / gam2x
        # likelihood: z1 the posterior mean of z under y = z + CN(0, wvar)
        pvar = 1.0 / gam1z
        z1 = p1 + pvar / (pvar + wvar) * (y - p1)
        eta1z = 1.0 / torch.clamp(wvar * pvar / (pvar + wvar), min=1e-30)
        gam2z = extrinsic(eta1z, gam1z)
        p2 = (eta1z * z1 - gam1z * p1) / gam2z
        # LMMSE
        x2, z2, alf = phi.lmmse(r2, p2, gam2x / gam2z)
        alf = torch.clamp(alf, 1e-6, min(1.0, delta) * (1.0 - 1e-6))
        # back to the denoiser and the likelihood, damped after the first iteration
        r1n = x2 + (1.0 - alf) / alf * (x2 - r2)
        p1n = z2 + alf / (delta - alf) * (z2 - p2)
        gam1xn = torch.clamp(gam2x * alf / (1.0 - alf), GAM_MIN, GAM_MAX)
        gam1zn = torch.clamp(gam2z * (delta - alf) / alf, GAM_MIN, GAM_MAX)
        if i:
            r1n = damp * r1n + (1.0 - damp) * r1
            p1n = damp * p1n + (1.0 - damp) * p1
            gam1xn = damp * gam1xn + (1.0 - damp) * gam1x
            gam1zn = damp * gam1zn + (1.0 - damp) * gam1z
        # the message cap
        big = torch.maximum(r1n.abs().amax(dim=(-2, -1), keepdim=True), p1n.abs().amax(dim=(-2, -1), keepdim=True))
        shrink = torch.where(big > MSG_CAP, MSG_CAP / big, torch.ones_like(big))
        r1, p1, gam1x, gam1z = r1n * shrink, p1n * shrink, gam1xn, gam1zn
        # keep-best
        if i:
            step = (x1 - x_prev).abs().pow(2).sum(dim=(-2, -1), keepdim=True) / torch.clamp(
                x1.abs().pow(2).sum(dim=(-2, -1), keepdim=True), min=torch.finfo(torch.float32).tiny)
            better = step < best_step
            best_step = torch.minimum(step, best_step)
        else:
            better = torch.ones(col, dtype=torch.bool, device=y.device)
        best = torch.where(better, x1, best)
        x_prev = x1
    return best


def solve(prob: Mapping[str, torch.Tensor], point: Mapping, method: str, mm: Products) -> torch.Tensor:
    """The (B, Gr, K) estimate of the baseline ``method`` on ``prob``."""
    if method == "ls":
        return ls(prob, mm)
    if method == "omp_mmv":
        return omp_mmv(prob, min(point["num_nonzero"], point["Gr"]), mm)
    if method == "vamp":
        return vamp(prob, point, mm)
    raise ValueError(f"the reference has no baseline {method!r}")
