"""The proposed joint low-rank + beamspace-sparse ADMM estimator.

Counterpart of ``jstsp19_tpu/solvers/admm.py`` (``proposed_algorithm.m`` and
``proposed_algorithm_angles.m``): the mask normal matrix is diagonal, so the
X-update is an elementwise division by ``Ω + 2ρ``; the dictionary kron is
never formed (``K2·s ≡ vec(A·S·B)``, ``K2ᴴ·k ≡ vec(Aᴴ·K·Bᴴ)``); the exact mode
solves least squares through factorized pseudo-inverses.  A batch of
realizations is a leading dimension of every matrix, with ``tau_Y``,
``tau_S`` and ``rho`` of the batch shape; the ``lax.scan`` is a Python loop.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from jstsp19_torch.kernels.dictionary import dict_correlation_plain, dict_correlation_routed
from jstsp19_torch.kernels.softthresh import fused_soft_threshold_plain, fused_soft_threshold_routed
from jstsp19_torch.ops.jacobi import jacobi_svt_fn
from jstsp19_torch.ops.tracked import make_tracked_svt
from jstsp19_torch.solvers import admm_transposed
from jstsp19_torch.solvers.lowrank import _col, svt


class AdmmState(NamedTuple):
    """Full ADMM iterate, for warm restarts."""

    X: torch.Tensor
    V1: torch.Tensor
    V2: torch.Tensor
    C: torch.Tensor
    Y: torch.Tensor
    S: torch.Tensor  # thresholded sparse code (used in the X-update)
    v: torch.Tensor  # pre-threshold code (steepest-descent iterate)
    # tracked-SVT carry: the warm eigenbasis and the global iteration count
    # (rotation-schedule phase), so a chunked resume is exact
    U: Optional[torch.Tensor] = None
    it: Optional[int] = None


class AdmmResult(NamedTuple):
    S: torch.Tensor  # (..., Gr, K) beamspace estimate (post soft-threshold)
    Y: torch.Tensor  # (..., N, M) completed low-rank observation estimate
    convergence: Optional[torch.Tensor]  # (..., Imax, 3) residual log, or None
    state: Optional[AdmmState] = None


def _sq_spectral(X: torch.Tensor) -> torch.Tensor:
    n, m = X.shape[-2], X.shape[-1]
    G = X @ X.mH if n <= m else X.mH @ X
    return torch.clamp(torch.linalg.eigvalsh(G)[..., -1], min=0.0)


def admm_hyperparams(Y_obs: torch.Tensor, Zbar_ref: torch.Tensor, top_k: int = 6):
    """The hyper-parameter recipe of ``plot_errorVSsnr.m:127-130``:
    τ_Y = 1/‖Y‖²_F, τ_S = 1/(2‖Z̄‖²_F), ρ = sqrt(λ_k·τ_Y) with λ_k the
    top_k-th largest eigenvalue of the thin-side Gram (MATLAB ``eigs``'
    six largest; top_k clamps to the Gram size).  Batched."""
    tau_Y, tau_S, G = admm_gram(Y_obs, Zbar_ref)
    return tau_Y, tau_S, admm_rho(G, tau_Y, top_k)


def admm_gram(Y_obs: torch.Tensor, Zbar_ref: torch.Tensor):
    """τ_Y, τ_S and the thin-side Gram of Y: the part of
    :func:`admm_hyperparams` before the eigenvalues, none of whose launches
    waits on the device."""
    tau_Y = 1.0 / torch.sum(Y_obs.abs() ** 2, dim=(-2, -1))
    tau_S = 1.0 / (2.0 * torch.sum(Zbar_ref.abs() ** 2, dim=(-2, -1)))
    n, m = Y_obs.shape[-2], Y_obs.shape[-1]
    G = Y_obs @ Y_obs.mH if n <= m else Y_obs.mH @ Y_obs
    return tau_Y, tau_S, G


def admm_rho(G: torch.Tensor, tau_Y: torch.Tensor, top_k: int = 6) -> torch.Tensor:
    """ρ of :func:`admm_hyperparams` from the Gram and τ_Y of
    :func:`admm_gram`; ``eigvalsh`` reads its error flag back, so on the
    card the host waits here for the device."""
    ev = torch.linalg.eigvalsh(G)  # ascending
    return torch.sqrt(torch.clamp(ev[..., -min(top_k, G.shape[-1])], min=0.0) * tau_Y)


def proposed_admm(
    subY: torch.Tensor,
    Omega: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    Imax: int,
    tau_Y,
    tau_S,
    rho,
    mode: str = "approximate",
    support_rank: Optional[torch.Tensor] = None,
    support_base: int = 10,
    support_step: int = 5,
    track_convergence: bool = False,
    conv_norm: str = "spectral",
    init_state: Optional[AdmmState] = None,
    svt_method: str = "eigh",
    track_rounds: int = 1,
    track_precision: str = "highest",
    *,
    use_kernels: bool = True,
) -> AdmmResult:
    """Joint matrix-completion + beamspace-sparse ADMM, batched.

    Args:
      subY: (..., N, M) masked observation ``Ω ∘ (W_eᴴ R)``.
      Omega: (..., N, M) binary sampling mask.
      A: (..., N, Gr) receive-side dictionary; B: (..., K, M) transmit /
         training dictionary.
      mode: 'approximate' (one exact-step steepest-descent step on the
         normal equations per iteration, ``proposed_algorithm.m:43-54``) or
         'exact' (least squares via factorized pinv).
      support_rank: optional (..., Gr, K) rank of each entry in the oracle
         support order — the Algorithm-3 schedule keeps the
         ``min(base + step·(i+1), Gr·K)`` strongest entries at iteration i.
      track_convergence: log (ε1, ε2, ε3) per iteration.
      init_state: :class:`AdmmState` to resume from.
      svt_method: 'eigh' (eigendecomposition oracle), 'jacobi' (the
         eigh-free Jacobi eigensolver at the solvers' shared sweep count,
         ``ops/jacobi.py::jacobi_svt_fn``) or 'tracked' (the warm-started
         rotation chain of ``ops/tracked.py``).
      track_precision: the precision of the tracked chain's two products on
         the card ('highest' and 'high' full float32, 'tensorfloat32' one
         TF32 pass, 'default' as ``ops/tracked.py::PRODUCTS`` decides;
         float32 on the CPU); every
         other product runs in full float32.
      use_kernels: the correlation Aᴴ·K·Bᴴ and the soft threshold go
         through their kernels' routes (``kernels/dictionary.py``,
         ``kernels/softthresh.py``: the CUDA kernels for complex64 CUDA
         operands they take, the plain versions at the operands' dtype for
         any other); False runs their plain PyTorch versions.

    On the card an N > M tracked solve that
    :func:`solvers.admm_transposed.takes` runs as one launch of the fused
    kernel on the transposed problem (``solvers/admm_transposed.py``; the
    same float32 work in another summation order); its answer carries no
    convergence log and no state.  Every other call runs eagerly
    (:func:`_proposed_admm`).
    """
    inputs = dict(subY=subY, Omega=Omega, A=A, B=B, tau_Y=tau_Y, tau_S=tau_S, rho=rho, support_rank=support_rank)
    options = dict(Imax=Imax, mode=mode, support_base=support_base, support_step=support_step,
                   track_convergence=track_convergence, conv_norm=conv_norm, init_state=init_state,
                   svt_method=svt_method, track_rounds=track_rounds, track_precision=track_precision,
                   use_kernels=use_kernels)
    if admm_transposed.takes(inputs, options):
        return admm_transposed.solve(inputs, options)
    return _proposed_admm(**inputs, **options)


def _proposed_admm(
    subY: torch.Tensor,
    Omega: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    Imax: int,
    tau_Y,
    tau_S,
    rho,
    mode: str = "approximate",
    support_rank: Optional[torch.Tensor] = None,
    support_base: int = 10,
    support_step: int = 5,
    track_convergence: bool = False,
    conv_norm: str = "spectral",
    init_state: Optional[AdmmState] = None,
    svt_method: str = "eigh",
    track_rounds: int = 1,
    track_precision: str = "highest",
    *,
    use_kernels: bool = True,
) -> AdmmResult:
    """:func:`proposed_admm`, eagerly: one launch at a time."""
    N, M = subY.shape[-2:]
    Gr = A.shape[-1]
    K = B.shape[-2]
    rdt = subY.real.dtype
    rho_c = _col(rho, subY)
    thr_Y = torch.as_tensor(tau_Y, dtype=rdt, device=subY.device) / torch.as_tensor(
        rho, dtype=rdt, device=subY.device
    )
    thr_S = _col(tau_S, subY) / rho_c
    denom = (Omega + 2.0 * rho_c).to(rdt)

    if mode == "approximate":
        AhA = A.mH @ A
        BBh = B @ B.mH
    elif mode == "exact":
        pinvA = torch.linalg.pinv(A)
        pinvB = torch.linalg.pinv(B)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    if svt_method not in ("eigh", "jacobi", "tracked"):
        raise ValueError(f"unknown svt_method {svt_method!r}")
    svt_fn = jacobi_svt_fn if svt_method == "jacobi" else svt
    tracked = svt_method == "tracked"

    total = Gr * K
    correlate = dict_correlation_routed if use_kernels else dict_correlation_plain
    shrink = fused_soft_threshold_routed if use_kernels else fused_soft_threshold_plain

    def sqn(X):
        if conv_norm == "fro":
            return torch.sum(X.abs() ** 2, dim=(-2, -1))
        return _sq_spectral(X)

    if init_state is not None:
        st = init_state
    else:
        batch = torch.broadcast_shapes(subY.shape[:-2], A.shape[:-2], B.shape[:-2])
        z_nm = torch.zeros(batch + (N, M), dtype=subY.dtype, device=subY.device)
        z_gk = torch.zeros(batch + (Gr, K), dtype=subY.dtype, device=subY.device)
        st = AdmmState(X=z_nm, V1=z_nm, V2=z_nm, C=z_nm, Y=z_nm, S=z_gk, v=z_gk)
    it0 = int(st.it) if st.it is not None else 0

    U = None
    if tracked:
        U0, tracked_step = make_tracked_svt(
            N, M, subY.dtype, track_rounds, track_precision, device=subY.device
        )
        U = st.U if st.U is not None else U0.expand(st.X.shape[:-2] + U0.shape).clone()

    X, V1, V2, C, Y, S, v = st.X, st.V1, st.V2, st.C, st.Y, st.S, st.v
    tiny = torch.finfo(rdt).tiny
    conv = []
    for i in range(it0, it0 + Imax):
        # -- sub 1: nuclear-norm prox ----------------------------------------
        W = X - V1 / rho_c
        if tracked:
            Y, U = tracked_step(W, thr_Y, U, i)
        else:
            Y = svt_fn(W, thr_Y)

        # -- sub 2: masked LS (diagonal solve) -------------------------------
        X = (V1 + rho_c * Y + subY + V2 + rho_c * C + rho_c * (A @ S @ B)) / denom

        # -- sub 3: sparse code ----------------------------------------------
        Kmat = X - V2 / rho_c - C
        v_prev = v
        if mode == "approximate":
            res = correlate(A, Kmat, B) - AhA @ v @ BBh
            Rres = AhA @ res @ BBh
            num = torch.sum(res.abs() ** 2, dim=(-2, -1))
            den = torch.sum(res.conj() * Rres, dim=(-2, -1)).real
            pos = den > 0
            alpha = torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)), 0.0)
            v = v + alpha[..., None, None] * res
            conv3 = torch.sum((v - v_prev).abs() ** 2, dim=(-2, -1)) / torch.clamp(
                torch.sum(v_prev.abs() ** 2, dim=(-2, -1)), min=tiny
            )
        else:
            v = pinvA @ Kmat @ pinvB
            conv3 = torch.zeros(v.shape[:-2], dtype=rdt, device=v.device)

        S = shrink(v, thr_S)
        if support_rank is not None:
            nnz_i = min(support_base + support_step * (i + 1), total)
            S = torch.where(support_rank < nnz_i, S, torch.zeros_like(S))
        Xs = A @ S @ B

        # -- sub 4 + duals ---------------------------------------------------
        V2_prev = V2
        C = rho_c / (rho_c + 1.0) * (X - Xs - V2_prev / rho_c)
        V1 = V1 + rho_c * (Y - X)
        V2 = V2_prev + rho_c * (C - X + Xs)

        if track_convergence:
            nx = torch.clamp(sqn(X), min=tiny)
            conv.append(torch.stack([sqn(V1) / nx, sqn(V2) / nx, conv3], dim=-1))

    final = AdmmState(X, V1, V2, C, Y, S, v, U=U if tracked else None, it=it0 + Imax)
    return AdmmResult(
        S=S,
        Y=Y,
        convergence=torch.stack(conv, dim=-2) if track_convergence else None,
        state=final,
    )


def support_rank_from_order(indx_S: torch.Tensor, total: int) -> torch.Tensor:
    """Rank (0 = strongest) of each flat S entry given the descending oracle
    order ``indx_S`` (``plot_errorVSsnr.m:143``); batched over leading dims.
    The single source of the Algorithm-3 schedule for both the plain path
    and the fused kernel."""
    ar = torch.arange(total, dtype=torch.int32, device=indx_S.device).expand(indx_S.shape)
    return torch.zeros(indx_S.shape[:-1] + (total,), dtype=torch.int32, device=indx_S.device).scatter(
        -1, indx_S.long(), ar
    )


def proposed_admm_angles(
    subY, Omega, indx_S, A, B, Imax, tau_Y, tau_S, rho, mode="approximate", **kw
) -> AdmmResult:
    """Algorithm 3: the proposed ADMM with oracle angle (support) information;
    ``indx_S`` holds the flat entry indices of S sorted by decreasing
    oracle magnitude (``proposed_algorithm_angles.m:36``)."""
    Gr, K = A.shape[-1], B.shape[-2]
    rank = support_rank_from_order(indx_S, Gr * K).reshape(*indx_S.shape[:-1], Gr, K)
    return proposed_admm(
        subY, Omega, A, B, Imax, tau_Y, tau_S, rho, mode=mode, support_rank=rank, **kw
    )
