"""Batched simulation pipeline of the proposed estimator.

Counterpart of ``jstsp19_tpu/harness/pipeline.py``: params → channel →
training + noise → combiner → random spatial sampling → dictionaries and
hyper-parameters → proposed ADMM → clamped NMSE (``plot_errorVSsnr.m:48-167``).
Where the JAX package vmaps one realization, every function here takes
``gens`` (one ``torch.Generator`` per role, :func:`core.prng.realization_generators`)
and a ``batch`` count and works on the whole batch on the generators' device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch

from jstsp19_torch.channel import wideband_mmwave_channel
from jstsp19_torch.core import prng
from jstsp19_torch.core.config import matlab_round, use_full_fp32
from jstsp19_torch.core.metrics import clamped_nmse, nmse
from jstsp19_torch.frontend import awgn, create_beamformer, proposed_hbf, qam4_training_frames
from jstsp19_torch.solvers.admm import (
    admm_hyperparams,
    proposed_admm,
    proposed_admm_angles,
    support_rank_from_order,
)

PORTED_METHODS = ("proposed", "proposed_angles")


@dataclasses.dataclass(frozen=True)
class PointConfig:
    """Static configuration of one sweep point; defaults are the canonical
    ``plot_errorVSsnr.m:8-25`` block (fields as in the JAX package, less
    those of the estimators not ported yet, whose methods raise).

    ``svt_method`` is 'eigh', 'tracked' or 'fused'; 'fused' is the JAX
    package's 'pallas' and runs batch-level through
    :func:`fused_point_errors`.  ``track_precision`` is accepted for parity:
    the port runs every product in full float32.
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
    beamformer: str = "ZC"
    methods: Tuple[str, ...] = PORTED_METHODS
    admm_mode: str = "approximate"
    svt_method: str = "eigh"
    track_rounds: int = 1
    track_precision: str = "default"
    rho_scale: float = 1.0
    channel_quirks: bool = False

    @property
    def T_prop(self) -> int:
        return self.T * self.Nt

    @property
    def T_hbf(self) -> int:
        return matlab_round(self.T / (self.Nr / self.Mr)) * self.Nt


def _check_methods(pc: PointConfig) -> None:
    missing = [m for m in pc.methods if m not in PORTED_METHODS]
    if missing:
        raise NotImplementedError(
            f"methods {missing} are not ported yet (ROADMAP.md Queue 1, items 4-5: "
            "the other errorVSsnr families and the harness runner)"
        )


def _device(gens: Mapping[int, torch.Generator]) -> torch.device:
    return gens[prng.ROLE_CHANNEL].device


def _dictionaries(ch, W_c, Psi):
    """A = W_cᴴ·Dr and the stacked per-tap B blocks ``Dtᴴ·Psi_l``
    (``plot_errorVSsnr.m:74-78``); batched over Psi's leading dims."""
    A = W_c.mH @ ch.Dr
    Bl = torch.einsum("gn,...lnt->...lgt", ch.Dt.conj(), Psi)
    L, Gt, T = Bl.shape[-3:]
    return A, Bl.reshape(*Bl.shape[:-3], L * Gt, T)


def _system_realization(gens, pc: PointConfig, noise_var, batch: int):
    """Channel + training + noise + analog combiner for ``batch``
    realizations (``plot_errorVSsnr.m:57-73``)."""
    ch = wideband_mmwave_channel(
        gens[prng.ROLE_CHANNEL], pc.L, pc.Nr, pc.Nt, pc.n_clusters, pc.n_rays,
        pc.Gr, pc.Gt, quirks=pc.channel_quirks, batch=(batch,),
    )
    Psi = qam4_training_frames(gens[prng.ROLE_TRAINING], pc.Nt, pc.T_prop, pc.L, batch=(batch,))
    N = awgn(gens[prng.ROLE_NOISE], pc.Nr, pc.T_prop, noise_var, batch=(batch,))
    W = create_beamformer(pc.Nr, pc.beamformer, gen=gens[prng.ROLE_BEAMFORMER], device=_device(gens))
    return ch, Psi, N, W


def _proposed_frontend(gens, pc: PointConfig, noise_var, batch: int):
    """System realization → random-spatial-sampling observation →
    dictionaries → hyper-parameters (``plot_errorVSsnr.m:125-130``)."""
    use_full_fp32()
    ch, Psi, N, W = _system_realization(gens, pc, noise_var, batch)
    obs = proposed_hbf(gens[prng.ROLE_MASK], ch.H, N, Psi, pc.Mr_e, pc.Mr, W)
    A_p, B_p = _dictionaries(ch, obs.W_e, Psi)
    A_p = A_p.expand(batch, *A_p.shape[-2:]).contiguous()
    tau_Y, tau_S, rho = admm_hyperparams(obs.Y, ch.Zbar)
    return ch, obs, A_p, B_p, tau_Y, tau_S, rho * pc.rho_scale


def _oracle_order(Zbar: torch.Tensor) -> torch.Tensor:
    """Flat indices of Zbar by decreasing magnitude (``plot_errorVSsnr.m:143``);
    stable, as JAX's argsort is."""
    return torch.argsort(-Zbar.abs().flatten(-2), dim=-1, stable=True)


def realization_errors(
    gens, pc: PointConfig, noise_var, batch: int, *, clamp=True, with_zbar=False
) -> Dict[str, torch.Tensor]:
    """Evaluate the configured estimators on ``batch`` channel realizations.

    Returns {method: (batch,) clamped spectral NMSE vs Zbar}; ``clamp=False``
    gives the raw NMSE and ``with_zbar`` adds the true beamspace channel.
    Only 'proposed' and 'proposed_angles' are ported.
    """
    _check_methods(pc)
    if pc.svt_method == "fused":
        raise ValueError(
            "svt_method='fused' runs batch-level; use harness.pipeline.fused_point_errors"
        )
    metric = clamped_nmse if clamp else nmse
    ch, obs, A_p, B_p, tau_Y, tau_S, rho = _proposed_frontend(gens, pc, noise_var, batch)
    kw = dict(
        mode=pc.admm_mode, svt_method=pc.svt_method, track_rounds=pc.track_rounds,
        track_precision=pc.track_precision,
    )
    out: Dict[str, torch.Tensor] = {}
    if "proposed" in pc.methods:
        res = proposed_admm(obs.Y, obs.Omega, A_p, B_p, pc.Imax, tau_Y, tau_S, rho, **kw)
        out["proposed"] = metric(res.S, ch.Zbar)
    if "proposed_angles" in pc.methods:
        res_a = proposed_admm_angles(
            obs.Y, obs.Omega, _oracle_order(ch.Zbar), A_p, B_p, pc.Imax, tau_Y, tau_S, rho, **kw
        )
        out["proposed_angles"] = metric(res_a.S, ch.Zbar)
    if with_zbar:
        out["Zbar"] = ch.Zbar
    return out


def proposed_problem(gens, pc: PointConfig, noise_var, batch: int) -> Dict[str, torch.Tensor]:
    """The batched solver problem of the proposed-HBF branch
    (``plot_errorVSsnr.m:48-146``): subY, Omega, A, B, tau_Y, tau_S, rho,
    Zbar and the Algorithm-3 support rank, as the fused kernel takes them."""
    ch, obs, A_p, B_p, tau_Y, tau_S, rho = _proposed_frontend(gens, pc, noise_var, batch)
    total = pc.Gr * pc.L * pc.Gt
    rank = support_rank_from_order(_oracle_order(ch.Zbar), total).reshape(ch.Zbar.shape)
    return dict(
        subY=obs.Y.contiguous(), Omega=obs.Omega.contiguous(), A=A_p, B=B_p.contiguous(),
        tau_Y=tau_Y, tau_S=tau_S, rho=rho, Zbar=ch.Zbar, rank=rank,
    )


def fused_point_errors(gens, pc: PointConfig, noise_var, batch: int) -> Dict[str, torch.Tensor]:
    """Batch-level proposed / proposed_angles evaluation on the fused
    tracked-SVT ADMM (``kernels/admm_fused.py``) — the JAX package's
    ``svt_method='pallas'`` route.  On CUDA generators the solve is the
    CUDA kernel; on CPU ones its plain version."""
    from jstsp19_torch.kernels.admm_fused import fused_tracked_admm

    _check_methods(pc)
    if pc.admm_mode != "approximate":
        raise ValueError(
            "the fused route implements only admm_mode='approximate' "
            f"(the kernel's sparse-code update); got {pc.admm_mode!r}"
        )
    prob = proposed_problem(gens, pc, noise_var, batch)
    args = (prob["subY"], prob["Omega"], prob["A"], prob["B"], prob["tau_Y"], prob["tau_S"], prob["rho"])
    out = {}
    if "proposed" in pc.methods:
        S, _ = fused_tracked_admm(*args, Imax=pc.Imax, track_rounds=pc.track_rounds)
        out["proposed"] = clamped_nmse(S, prob["Zbar"])
    if "proposed_angles" in pc.methods:
        S_a, _ = fused_tracked_admm(
            *args, Imax=pc.Imax, track_rounds=pc.track_rounds, support_rank=prob["rank"]
        )
        out["proposed_angles"] = clamped_nmse(S_a, prob["Zbar"])
    return out
