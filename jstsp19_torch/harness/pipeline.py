"""Batched simulation pipeline of the proposed estimator.

Counterpart of ``jstsp19_tpu/harness/pipeline.py``: params → channel →
training + noise → combiner → random spatial sampling → dictionaries and
hyper-parameters → proposed ADMM → clamped NMSE (``plot_errorVSsnr.m:48-167``).
Where the JAX package vmaps one realization, every function here takes
``gens`` (one ``torch.Generator`` per role, :func:`core.prng.realization_generators`)
and a ``batch`` count and works on the whole batch on the generators' device.
The conventional-HBF baselines (LS, VAMP, MMV-OMP, TD-OMP) run on the same
realizations under the T_hbf training budget (``plot_errorVSsnr.m:73-121``);
the completion baselines (SVT, TSSR) on the proposed branch's observation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch

from jstsp19_torch.channel import channel_from_taps, wideband_mmwave_channel
from jstsp19_torch.core import prng
from jstsp19_torch.core.config import matlab_round, use_full_fp32
from jstsp19_torch.core.metrics import clamped_nmse, nmse
from jstsp19_torch.core.trace import span
from jstsp19_torch.frontend import awgn, create_beamformer, hbf, proposed_hbf, qam4_training_frames
from jstsp19_torch.harness import frontend_graph
from jstsp19_torch.solvers.admm import (
    admm_gram,
    admm_hyperparams,
    admm_rho,
    proposed_admm,
    proposed_admm_angles,
    support_rank_from_order,
)
from jstsp19_torch.solvers.lowrank import mc_svt
from jstsp19_torch.solvers.lsq import ls_estimate, pinv
from jstsp19_torch.solvers.omp import omp_mmv, omp_td
from jstsp19_torch.solvers.vamp import vamp_mmwave

# the JAX package's default methods, and every method it evaluates
DEFAULT_METHODS = ("ls", "vamp", "omp_mmv", "proposed", "proposed_angles")
PORTED_METHODS = DEFAULT_METHODS + ("omp_td", "svt", "tssr")


@dataclasses.dataclass(frozen=True)
class PointConfig:
    """Static configuration of one sweep point; defaults are the canonical
    ``plot_errorVSsnr.m:8-25`` block, fields and defaults as in the JAX
    package (whose field notes give the reasons).

    ``svt_method`` is 'eigh', 'tracked' or 'fused'; 'fused' is the JAX
    package's 'pallas' and runs batch-level through
    :func:`fused_point_errors`.  ``track_precision`` sets the two products
    of the 'tracked' chain on the card (``ops/tracked.py::PRODUCTS``); the
    fused kernel runs float32 FMAs whatever its value, as JAX's kernel runs
    HIGHEST, and the CPU runs everything in float32.
    """

    Nt: int = 4
    Nr: int = 32
    Mr_e: int = 32
    Mr: int = 4
    Gr: int = 32
    Gt: int = 4
    L: int = 4
    n_clusters: int = 2
    n_rays: int = 3
    T: int = 35
    Imax: int = 100
    num_nonzero: int = 100
    beamformer: str = "ZC"
    methods: Tuple[str, ...] = DEFAULT_METHODS
    admm_mode: str = "approximate"
    svt_method: str = "eigh"
    track_rounds: int = 1
    track_precision: str = "default"
    vamp_nit: int = 100
    vamp_true_noise: bool = False  # the reference passes sigma=1 (plot_errorVSsnr.m:100)
    vamp_damp: float = 0.85  # vamp.m:12
    vamp_normal_eq: bool = True  # y = vec(Y·Bᴴ), Phi = kron((B·Bᴴ).', A) (plot_errorVSsnr.m:79-80)
    rho_scale: float = 1.0
    channel_quirks: bool = False

    @property
    def T_prop(self) -> int:
        return self.T * self.Nt

    @property
    def T_hbf(self) -> int:
        return matlab_round(self.T / (self.Nr / self.Mr)) * self.Nt


def fastest_point_config(method: str) -> PointConfig:
    """One estimator family at its fastest configuration on the card, for
    ``bench_all`` and the ``time_comparisons`` recipe: 'fused' for
    'proposed' and 'proposed_angles' (the fused kernel's route, which
    ``run_point`` turns into 'tracked' where the kernel cannot take the
    shapes), 'tracked' for the completion baselines 'svt' and 'tssr', 'eigh'
    for the rest.  The JAX package names 'tracked' for the proposed
    methods too; on an H100 the fused route is the faster (PERF.md §5)."""
    if method.startswith("proposed"):
        svt_method = "fused"
    elif method in ("svt", "tssr"):
        svt_method = "tracked"
    else:
        svt_method = "eigh"
    return PointConfig(methods=(method,), svt_method=svt_method)


def _check_methods(pc: PointConfig) -> None:
    for m in pc.methods:
        if m not in PORTED_METHODS:
            raise ValueError(f"unknown method {m!r}")


def _device(gens: Mapping[int, torch.Generator]) -> torch.device:
    return gens[prng.ROLE_CHANNEL].device


def _dictionaries(ch, W_c, Psi):
    """A = W_cᴴ·Dr and the stacked per-tap B blocks ``Dtᴴ·Psi_l``
    (``plot_errorVSsnr.m:74-78``); batched over Psi's leading dims."""
    A = W_c.mH @ ch.Dr
    Bl = torch.einsum("gn,...lnt->...lgt", ch.Dt.conj(), Psi)
    L, Gt, T = Bl.shape[-3:]
    return A, Bl.reshape(*Bl.shape[:-3], L * Gt, T)


def _system_realization(gens, pc: PointConfig, noise_var, batch: int, H_ext=None):
    """Channel + training + noise + analog combiner for ``batch``
    realizations (``plot_errorVSsnr.m:57-73``).  ``H_ext``: (batch, L, Nr, Nt)
    delay taps supplied from outside, used in place of the synthetic channel."""
    if H_ext is not None:
        ch = channel_from_taps(H_ext, pc.Gr, pc.Gt)
    else:
        ch = wideband_mmwave_channel(
            gens[prng.ROLE_CHANNEL], pc.L, pc.Nr, pc.Nt, pc.n_clusters, pc.n_rays,
            pc.Gr, pc.Gt, quirks=pc.channel_quirks, batch=(batch,),
        )
    Psi = qam4_training_frames(gens[prng.ROLE_TRAINING], pc.Nt, pc.T_prop, pc.L, batch=(batch,))
    N = awgn(gens[prng.ROLE_NOISE], pc.Nr, pc.T_prop, noise_var, batch=(batch,))
    W = create_beamformer(
        pc.Nr, pc.beamformer, gen=gens[prng.ROLE_BEAMFORMER], device=_device(gens), batch=(batch,)
    )
    return ch, Psi, N, W


def _per_realization(A: torch.Tensor, batch: int) -> torch.Tensor:
    """A dictionary built from the one shared combiner, as (batch, ...)."""
    return A.expand(batch, *A.shape[-2:]).contiguous() if A.dim() == 2 else A


def point_draws(gens, pc: PointConfig, noise_var, batch: int, H_ext=None, observe=True, rows=None):
    """``(ch, Psi, N, W, obs)``: the system realization and, with
    ``observe``, the proposed receiver's observation (its mask drawn), for
    ``batch`` realizations.  ``rows`` (a slice) then cuts every batched
    draw to those realizations: the draws depend on the batch layout
    (``core/prng.py``), so a slice of the whole batch's draws is how a
    share of the point sees the realizations the whole batch sees."""
    ch, Psi, N, W = _system_realization(gens, pc, noise_var, batch, H_ext)
    obs = proposed_hbf(gens[prng.ROLE_MASK], ch.H, N, Psi, pc.Mr_e, pc.Mr, W) if observe else None
    if rows is None:
        return ch, Psi, N, W, obs
    ch = ch._replace(H=ch.H[rows], Zbar=ch.Zbar[rows], Ar=ch.Ar[rows], At=ch.At[rows])
    W = W[rows] if W.dim() == 3 else W  # a random combiner is drawn per realization
    if obs is not None:
        obs = obs._replace(Y=obs.Y[rows], Omega=obs.Omega[rows], Y_full=obs.Y_full[rows],
                           W_e=obs.W_e[rows] if obs.W_e.dim() == 3 else obs.W_e)
    return ch, Psi[rows], N[rows], W, obs


def _proposed_frontend(gens, pc: PointConfig, noise_var, batch: int, H_ext=None, draws=None, rows=None):
    """System realization → random-spatial-sampling observation →
    dictionaries → hyper-parameters (``plot_errorVSsnr.m:125-130``).
    ``draws``: an already drawn ``(ch, Psi, N, W, obs)``; ``rows`` as in
    :func:`point_draws`."""
    use_full_fp32()
    if draws is None:
        with span("draws"):
            draws = point_draws(gens, pc, noise_var, batch, H_ext, rows=rows)
    ch, Psi, _, _, obs = draws
    with span("dictionaries"):
        A_p, B_p = _dictionaries(ch, obs.W_e, Psi)
        A_p = _per_realization(A_p, ch.H.shape[0])
    with span("hyperparams"):
        tau_Y, tau_S, rho = admm_hyperparams(obs.Y, ch.Zbar)
    return ch, obs, A_p, B_p, tau_Y, tau_S, rho * pc.rho_scale


def _oracle_order(Zbar: torch.Tensor) -> torch.Tensor:
    """Flat indices of Zbar by decreasing magnitude (``plot_errorVSsnr.m:143``);
    stable, as JAX's argsort is."""
    return torch.argsort(-Zbar.abs().flatten(-2), dim=-1, stable=True)


def _conventional(pc: PointConfig, ch, Psi, N, W):
    """The HBF observation Y_c and the dictionaries A_c (one per realization)
    and B_c under the training budget T_hbf (``plot_errorVSsnr.m:73-78``)."""
    Th = pc.T_hbf
    Y_c, W_c = hbf(ch.H, N[..., :Th], Psi[..., :Th], pc.Nr, W)
    A_c, B_c = _dictionaries(ch, W_c, Psi[..., :Th])
    return Y_c, _per_realization(A_c, ch.H.shape[0]), B_c


def conventional_problem(gens, pc: PointConfig, noise_var, batch: int) -> Dict[str, torch.Tensor]:
    """The conventional branch's inputs for ``batch`` realizations: Y_c, A_c,
    B_c and the true beamspace channel Zbar (the keys of
    ``interop.CONVENTIONAL_KEYS``)."""
    ch, Psi, N, W, _ = point_draws(gens, pc, noise_var, batch, observe=False)
    Y_c, A_c, B_c = _conventional(pc, ch, Psi, N, W)
    return dict(Y_c=Y_c, A_c=A_c, B_c=B_c, Zbar=ch.Zbar)


def realization_errors(
    gens, pc: PointConfig, noise_var, batch: int, H_ext=None, *, rows=None, clamp=True, with_zbar=False,
    draws=None,
) -> Dict[str, torch.Tensor]:
    """Evaluate the configured estimators on ``batch`` channel realizations.

    Returns {method: (batch,) clamped spectral NMSE vs Zbar}; ``clamp=False``
    gives the raw NMSE and ``with_zbar`` adds the true beamspace channel.
    ``H_ext``: (batch, L, Nr, Nt) external delay taps (NYU-Wireless
    ingestion) in place of the synthetic channel.  ``rows``: a slice of the
    batch; only those realizations are solved, on the whole batch's draws
    (:func:`point_draws`), and the outputs have their length.  ``draws``: the
    ``(ch, Psi, N, W, obs)`` of :func:`point_draws`, made elsewhere (another
    package's draws carried over), in place of drawing from ``gens``.

    Under ``core.trace.recording()`` the draws are a ``draws`` span, the
    proposed branch's front end a ``frontend`` span, and each proposed
    method a ``solve`` span (its ``method``, the ``route`` and the solver's
    shapes) and then an ``nmse`` span, as on the fused route
    (``core/trace.py``).
    """
    _check_methods(pc)
    if pc.svt_method == "fused":
        raise ValueError(
            "svt_method='fused' runs batch-level; use harness.pipeline.fused_point_errors"
        )
    use_full_fp32()
    metric = clamped_nmse if clamp else nmse
    out: Dict[str, torch.Tensor] = {}
    proposed_branch = bool({"proposed", "proposed_angles", "svt", "tssr"} & set(pc.methods))
    if draws is None:
        with span("draws"):
            draws = point_draws(gens, pc, noise_var, batch, H_ext, observe=proposed_branch, rows=rows)
    ch, Psi, N, W, _ = draws
    batch = ch.H.shape[0]

    if {"ls", "vamp", "omp_mmv", "omp_td"} & set(pc.methods):
        # conventional branch under the fair training budget T_hbf
        # (plot_errorVSsnr.m:73-78)
        Y_c, A_c, B_c = _conventional(pc, ch, Psi, N, W)
        if "ls" in pc.methods:
            out["ls"] = metric(ls_estimate(Y_c, A_c, B_c), ch.Zbar)
        if "vamp" in pc.methods:
            nv = noise_var if pc.vamp_true_noise else 1.0
            if pc.vamp_normal_eq:
                # vec(Y·Bᴴ) = vec(A·X·(B·Bᴴ)): the reference's Phi in matrix form
                S_vamp = vamp_mmwave(Y_c @ B_c.mH, A_c, B_c @ B_c.mH, nv, pc.num_nonzero,
                                     nit=pc.vamp_nit, damp=pc.vamp_damp)
            else:
                S_vamp = vamp_mmwave(Y_c, A_c, B_c, nv, pc.num_nonzero, nit=pc.vamp_nit,
                                     damp=pc.vamp_damp)
            out["vamp"] = metric(S_vamp, ch.Zbar)
        if "omp_mmv" in pc.methods:
            # spx joint OMP on Y·pinv(B) (plot_errorVSsnr.m:116-118); numOfnz
            # > Gr saturates at the atom count, so MMV-OMP equals LS there
            S_omp = omp_mmv(A_c, Y_c @ pinv(B_c), min(pc.num_nonzero, pc.Gr)).x
            out["omp_mmv"] = metric(S_omp, ch.Zbar)
        if "omp_td" in pc.methods:
            # the figure legends' non-saturating "TD-OMP [11]": single OMP
            # over the implicit kron dictionary with numOfnz atoms
            k = min(pc.num_nonzero, pc.Gr * pc.L * pc.Gt)
            out["omp_td"] = metric(omp_td(A_c, B_c, Y_c, k).x, ch.Zbar)

    if proposed_branch:
        with span("frontend"):
            _, obs, A_p, B_p, tau_Y, tau_S, rho = _proposed_frontend(gens, pc, noise_var, batch, draws=draws)
        kw = dict(
            mode=pc.admm_mode, svt_method=pc.svt_method, track_rounds=pc.track_rounds,
            track_precision=pc.track_precision,
        )
        shapes = dict(route=pc.svt_method, B=obs.Y.shape[0], N=obs.Y.shape[-2], M=obs.Y.shape[-1],
                      Gr=A_p.shape[-1], K=B_p.shape[-2], Imax=pc.Imax)
        if "proposed" in pc.methods:
            with span("solve", method="proposed", **shapes):
                res = proposed_admm(obs.Y, obs.Omega, A_p, B_p, pc.Imax, tau_Y, tau_S, rho, **kw)
            with span("nmse", method="proposed"):
                out["proposed"] = metric(res.S, ch.Zbar)
        if {"svt", "tssr"} & set(pc.methods):
            # SVT completion of the masked observation, then LS de-mixing or
            # joint OMP with 2·nnz atoms: the SVT/TSSR baselines of the
            # commented blocks of plot_errorVSsnr.m:148-163, on the
            # configured SVT
            Y_svt = mc_svt(obs.Y, obs.Omega, pc.Imax, tau_Y, 0.1, svt_method=pc.svt_method,
                           track_rounds=pc.track_rounds, track_precision=pc.track_precision)
            if "svt" in pc.methods:
                out["svt"] = metric(ls_estimate(Y_svt, A_p, B_p), ch.Zbar)
            if "tssr" in pc.methods:
                S_tssr = omp_mmv(A_p, Y_svt @ pinv(B_p), min(2 * pc.num_nonzero, pc.Gr)).x
                out["tssr"] = metric(S_tssr, ch.Zbar)
        if "proposed_angles" in pc.methods:
            with span("solve", method="proposed_angles", **shapes):
                res_a = proposed_admm_angles(
                    obs.Y, obs.Omega, _oracle_order(ch.Zbar), A_p, B_p, pc.Imax, tau_Y, tau_S, rho, **kw
                )
            with span("nmse", method="proposed_angles"):
                out["proposed_angles"] = metric(res_a.S, ch.Zbar)
    if with_zbar:
        out["Zbar"] = ch.Zbar
    return out


def proposed_problem(gens, pc: PointConfig, noise_var, batch: int, H_ext=None, rows=None) -> Dict[str, torch.Tensor]:
    """The batched solver problem of the proposed-HBF branch
    (``plot_errorVSsnr.m:48-146``): subY, Omega, A, B, tau_Y, tau_S, rho,
    Zbar and the Algorithm-3 support rank, as the fused kernel takes them;
    ``H_ext`` and ``rows`` as in :func:`realization_errors`.

    Everything before ρ's eigenvalues is :func:`_problem`.  Where
    :func:`harness.frontend_graph.takes` the call (fresh CUDA generators, a
    noise variance given as a number, neither ``H_ext`` nor ``rows``), it
    replays as the CUDA graph of the point's shape once that shape has been
    called before, and gives the same bits; every other call runs it
    eagerly."""
    use_full_fp32()
    with span("frontend"):
        if frontend_graph.takes(gens, noise_var, H_ext, rows):
            prob = frontend_graph.problem(gens, pc, noise_var, batch)
        else:
            prob = _problem(gens, pc, noise_var, batch, H_ext, rows)
        with span("hyperparams"):
            prob["rho"] = admm_rho(prob.pop("G"), prob["tau_Y"]) * pc.rho_scale
        return prob


def _problem(gens, pc: PointConfig, noise_var, batch: int, H_ext=None, rows=None) -> Dict[str, torch.Tensor]:
    """:func:`proposed_problem` up to ρ's eigenvalues, run eagerly, with the
    thin-side Gram of :func:`solvers.admm.admm_gram` under ``G`` in ρ's
    place.  None of it waits on the device, which is what
    :mod:`harness.frontend_graph` captures."""
    use_full_fp32()
    with span("draws"):
        ch, Psi, _, _, obs = point_draws(gens, pc, noise_var, batch, H_ext, rows=rows)
    with span("oracle_rank"):
        rank = support_rank_from_order(_oracle_order(ch.Zbar), pc.Gr * pc.L * pc.Gt).reshape(ch.Zbar.shape)
    with span("dictionaries"):
        A_p, B_p = _dictionaries(ch, obs.W_e, Psi)
        A_p = _per_realization(A_p, ch.H.shape[0])
    tau_Y, tau_S, G = admm_gram(obs.Y, ch.Zbar)
    return {"subY": obs.Y.contiguous(), "Omega": obs.Omega.contiguous(), "A": A_p, "B": B_p.contiguous(),
            "tau_Y": tau_Y, "tau_S": tau_S, "G": G, "Zbar": ch.Zbar, "rank": rank}


def fused_point_errors(gens, pc: PointConfig, noise_var, batch: int, rows=None) -> Dict[str, torch.Tensor]:
    """Batch-level proposed / proposed_angles evaluation on the fused
    tracked-SVT ADMM (``kernels/admm_fused.py``) — the JAX package's
    ``svt_method='pallas'`` route.  On CUDA generators the solve is the
    CUDA kernel; on CPU ones its plain version.  ``rows`` as in
    :func:`realization_errors`."""
    from jstsp19_torch.kernels.admm_fused import fused_tracked_admm

    _check_methods(pc)
    if pc.admm_mode != "approximate":
        raise ValueError(
            "the fused route implements only admm_mode='approximate' "
            f"(the kernel's sparse-code update); got {pc.admm_mode!r}"
        )
    prob = proposed_problem(gens, pc, noise_var, batch, rows=rows)
    args = (prob["subY"], prob["Omega"], prob["A"], prob["B"], prob["tau_Y"], prob["tau_S"], prob["rho"])
    Bt, N, M = prob["subY"].shape
    shapes = dict(B=Bt, N=N, M=M, Gr=prob["A"].shape[-1], K=prob["B"].shape[-2], Imax=pc.Imax)
    out = {}
    if "proposed" in pc.methods:
        with span("solve", method="proposed", **shapes):
            S, _ = fused_tracked_admm(*args, Imax=pc.Imax, track_rounds=pc.track_rounds)
        with span("nmse", method="proposed"):
            out["proposed"] = clamped_nmse(S, prob["Zbar"])
    if "proposed_angles" in pc.methods:
        with span("solve", method="proposed_angles", **shapes):
            S_a, _ = fused_tracked_admm(
                *args, Imax=pc.Imax, track_rounds=pc.track_rounds, support_rank=prob["rank"]
            )
        with span("nmse", method="proposed_angles"):
            out["proposed_angles"] = clamped_nmse(S_a, prob["Zbar"])
    return out
