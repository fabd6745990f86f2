"""The proposed-ADMM step over (dp, sp, tp) shards on ``torch.distributed``
(counterpart of ``jstsp19_tpu/parallel/sharded_admm.py``, whose
``shard_map`` program each rank runs here on its own blocks).

Sharding over a ``parallel/mesh.py`` mesh:

  dp — the Monte-Carlo realization batch (embarrassingly parallel)
  sp — the training-frame axis T of the observation and state matrices:
       SVT's Gram X·Xᴴ and the correlation K·Bᴴ are local partial products
       summed over sp
  tp — the beamspace grid axis Gr: the sparse code S / v lives row-sharded;
       A·S is a local slab product summed over tp, and Aᴴ·(·) lands on the
       local rows with no collective

Per ADMM iteration the only traffic is the all-reduce over sp of an (N, N)
Gram and an (N, K) correlation, and over tp of two (N, K) products, two
scalars a realization and, at the end, the error terms — the JAX program's
``psum`` points.  The soft threshold goes through
``kernels/softthresh.py::fused_soft_threshold_routed`` (the CUDA kernel for
complex64 CUDA tensors, the plain soft threshold at the operand's dtype for
any other).  Under gloo with the ranks on a card, each all-reduce goes through
a host copy (``parallel/distributed.py``'s backend rule).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from jstsp19_torch.kernels.softthresh import fused_soft_threshold_routed


def local_blocks(mesh, subY, Omega, A, B, tau_Y, tau_S, rho, Zbar):
    """This rank's blocks of the whole problem, as the JAX program's
    ``in_specs`` cut it: subY, Omega (Bmc, N, T) by (dp, ·, sp); A (N, Gr)
    by (·, tp); B (K, T) by (·, sp); tau_Y, tau_S, rho (Bmc,) by dp; Zbar
    (Bmc, Gr, K) by (dp, tp, ·).  Raises unless each axis divides evenly."""
    (d, s, t), (dp, sp, tp) = mesh.get_coordinate(), mesh.mesh.shape
    n_b, T, Gr = subY.shape[0], subY.shape[-1], A.shape[-1]
    if n_b % dp or T % sp or Gr % tp:
        raise ValueError(f"batch {n_b}, T {T} and Gr {Gr} must divide by the mesh (dp, sp, tp) = {(dp, sp, tp)}")
    b, Tl, Gl = n_b // dp, T // sp, Gr // tp
    rows, cols, grid = slice(d * b, (d + 1) * b), slice(s * Tl, (s + 1) * Tl), slice(t * Gl, (t + 1) * Gl)
    return (subY[rows, :, cols].contiguous(), Omega[rows, :, cols].contiguous(), A[:, grid].contiguous(),
            B[:, cols].contiguous(), tau_Y[rows], tau_S[rows], rho[rows], Zbar[rows, grid].contiguous())


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over ``group`` (a complex tensor through its real view);
    through a host copy where the group's backend is gloo and x is on a card."""
    via_host = x.is_cuda and dist.get_backend(group) != "nccl"
    y = (x.cpu() if via_host else x).contiguous()
    dist.all_reduce(torch.view_as_real(y) if y.is_complex() else y, group=group)
    return y.to(x.device) if via_host else y


def sharded_admm_step(mesh, Imax: int = 5):
    """The sharded proposed-ADMM estimation step over ``mesh``.

    Returns ``step(subY, Omega, A, B, tau_Y, tau_S, rho, Zbar) -> (S, nmse)``
    on this rank's blocks (:func:`local_blocks`): subY, Omega (b, N, Tl), A
    (N, Grl), B (K, Tl), tau_Y, tau_S, rho (b,), Zbar (b, Grl, K); S is this
    rank's (b, Grl, K) block and nmse the (b,) errors of its realizations.
    Every rank of the mesh must call it (collective).
    """
    sp, tp = mesh.get_group("sp"), mesh.get_group("tp")

    def step(subY, Omega, A, B, tau_Y, tau_S, rho, Zbar):
        b, N, Tl = subY.shape
        Grl, K = A.shape[-1], B.shape[0]
        rh = rho[:, None, None]
        denom = Omega + 2.0 * rh
        Ah = A.mH
        BBh = _summed(B @ B.mH, sp)  # (K, K), the same on every rank

        def AS(S_loc):  # (b, Grl, K) -> (b, N, K), the same over tp
            return _summed(A @ S_loc, tp)

        def svt_sp(Xl, tau):  # SVT over the sp-sharded frame axis, Gram over sp
            sig2, U = torch.linalg.eigh(_summed(Xl @ Xl.mH, sp))
            sig = torch.sqrt(torch.clamp(sig2, min=0.0))
            pos = sig > 0
            f = torch.where(pos, torch.clamp(sig - tau[:, None], min=0.0) / torch.where(pos, sig, 1.0), 0.0)
            return (U * f[:, None, :].to(U.dtype)) @ (U.mH @ Xl)

        zeros = torch.zeros(b, N, Tl, dtype=subY.dtype, device=subY.device)
        X, V1, V2, C = zeros, zeros, zeros, zeros
        S = v = torch.zeros(b, Grl, K, dtype=subY.dtype, device=subY.device)
        for _ in range(Imax):
            Y = svt_sp(X - V1 / rh, tau_Y / rho)
            X = (V1 + rh * Y + subY + V2 + rh * C + rh * (AS(S) @ B)) / denom
            Kmat = X - V2 / rh - C
            M1 = _summed(Kmat @ B.mH, sp)  # (b, N, K)
            res = Ah @ M1 - (Ah @ AS(v)) @ BBh  # (b, Grl, K)
            Rres = (Ah @ AS(res)) @ BBh
            num = _summed(torch.sum(res.abs() ** 2, dim=(-2, -1)), tp)
            den = _summed(torch.sum(res.conj() * Rres, dim=(-2, -1)).real, tp)
            pos = den > 0
            alpha = torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)), 0.0)
            v = v + alpha[:, None, None] * res
            S = fused_soft_threshold_routed(v, (tau_S / rho)[:, None, None].contiguous())
            Xs = AS(S) @ B
            C = rh / (rh + 1.0) * (X - Xs - V2 / rh)
            V1 = V1 + rh * (Y - X)
            V2 = V2 + rh * (C - X + Xs)
        err_num = _summed(torch.sum((S - Zbar).abs() ** 2, dim=(-2, -1)), tp)
        err_den = _summed(torch.sum(Zbar.abs() ** 2, dim=(-2, -1)), tp)
        return S, err_num / err_den

    return step


def gather_blocks(mesh, S_loc: torch.Tensor) -> torch.Tensor:
    """The whole (Bmc, Gr, K) S on every rank, from each rank's (b, Grl, K)
    block (the blocks along sp are copies; any one of them serves)."""
    dp, sp, tp = mesh.mesh.shape
    dev = S_loc.device
    via_host = S_loc.is_cuda and dist.get_backend() != "nccl"
    mine = (S_loc.cpu() if via_host else S_loc).contiguous()
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    grid = torch.arange(dp * sp * tp).reshape(dp, sp, tp)
    whole = torch.cat([torch.cat([parts[int(grid[d, 0, t])] for t in range(tp)], dim=1) for d in range(dp)], dim=0)
    return whole.to(dev)


def reference_admm_batch(subY, Omega, A, B, Imax, tau_Y, tau_S, rho) -> torch.Tensor:
    """The unsharded reference for the checks: the port's ``proposed_admm``
    (eigh SVT) over the batch, with one hyper-parameter set a realization."""
    from jstsp19_torch.solvers.admm import proposed_admm

    return proposed_admm(subY, Omega, A, B, Imax, tau_Y, tau_S, rho).S
