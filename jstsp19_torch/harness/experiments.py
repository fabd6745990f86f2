"""The reference's NMSE sweep scripts as typed recipes
(counterpart of the ``run_sweep`` recipes of ``jstsp19_tpu/harness/experiments.py``).

Each entry reproduces one top-level ``plot_*.m`` script's configuration and
produces the same curve data (JSON instead of ``.fig``), with the JAX
recipes' sweep values, noise constants, curve names and extras.  Recipes
take ``device=`` where the JAX ones take ``mesh=``: the card unless named.
The NMSE sweeps go through :func:`run_sweep`; the specialized recipes (rate,
approximate front end, capacity, energy efficiency, rank, ...) draw each
sweep point's whole batch from the point's generators
(:func:`core.prng.realization_generators`) and average it;
``time_comparisons`` times each family through :func:`run_point`.
"""
from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from jstsp19_torch.channel import wideband_mmwave_channel
from jstsp19_torch.channel.nyu import load_nyu_taps, normalize_taps
from jstsp19_torch.core import prng
from jstsp19_torch.core.config import resolve_device, use_full_fp32
from jstsp19_torch.core.metrics import (
    achievable_rate,
    clamped_nmse,
    combined_spectral_efficiency,
    power_conventional_hbf,
    power_digital_bf,
    power_proposed,
    spectral_efficiency,
)
from jstsp19_torch.frontend import (
    awgn,
    comm_system_training,
    create_beamformer,
    proposed_hbf,
    qam4_training_frames,
)
from jstsp19_torch.harness.pipeline import (
    DEFAULT_METHODS,
    PointConfig,
    _dictionaries,
    _oracle_order,
    fastest_point_config,
    realization_errors,
)
from jstsp19_torch.harness.runner import SweepResult, run_point, run_sweep
from jstsp19_torch.solvers.admm import admm_hyperparams, proposed_admm, proposed_admm_angles
from jstsp19_torch.solvers.lsq import ls_estimate

EXPERIMENTS: Dict[str, Callable] = {}


def _register(name):
    def deco(fn):
        EXPERIMENTS[name] = fn
        fn.experiment_name = name
        return fn

    return deco


def get_experiment(name: str) -> Callable:
    return EXPERIMENTS[name]


def _nv(snr_db) -> float:
    return float(10 ** (-snr_db / 10))


# The fixed-SNR scripts hard-code their noise variance as a literal, e.g.
# ``square_noise_variance = 10^(-5/10)`` (plot_errorVSpaths.m:24,
# plot_errorVSdelays.m:22, plot_errorVSnrf.m:23) or ``10^(-15/10)``
# (plot_errorVSframelength.m:21, plot_errorVSnt.m:22): +5 dB / +15 dB under
# the canonical script's convention (plot_errorVSsnr.m:49).  Parity follows
# the literals, as in the JAX package.
_NV_PATHS_DELAYS_NRF = _nv(5)
_NV_FRAMELEN_NT_RATE = _nv(15)


@_register("error_vs_snr")
def error_vs_snr(n_mc=8, seed=0, device=None, methods=None, **kw):
    """``plot_errorVSsnr.m``: canonical SNR sweep −15:3:15 dB."""
    base = PointConfig(methods=tuple(methods or DEFAULT_METHODS), **kw)
    return run_sweep(
        "error_vs_snr", "snr_db", list(range(-15, 16, 3)),
        point_fn=lambda s: base, noise_fn=_nv, n_mc=n_mc, seed=seed, device=device,
    )


@_register("error_vs_snr_quirks")
def error_vs_snr_quirks(n_mc=64, seed=0, device=None, methods=None, **kw):
    """``plot_errorVSsnr.m`` under the reference-quirks channel ensemble
    (``channel_quirks=True``, the ensemble of the committed reference
    artifacts; PARITY.md)."""
    base = PointConfig(methods=tuple(methods or DEFAULT_METHODS), channel_quirks=True, **kw)
    return run_sweep(
        "error_vs_snr_quirks", "snr_db", list(range(-15, 16, 3)),
        point_fn=lambda s: base, noise_fn=_nv, n_mc=n_mc, seed=seed, device=device,
    )


@_register("error_vs_framelength")
def error_vs_framelength(n_mc=8, seed=0, device=None, **kw):
    """``plot_errorVSframelength.m``: T ∈ {5,15,25,35}, Nt=8, FFT combiner,
    numOfnz=50, noise variance 10^(-15/10)."""
    return run_sweep(
        "error_vs_framelength", "T", [5, 15, 25, 35],
        point_fn=lambda T: PointConfig(
            Nt=8, Gt=8, T=T, num_nonzero=50, beamformer="fft", methods=DEFAULT_METHODS, **kw),
        noise_fn=lambda T: _NV_FRAMELEN_NT_RATE, n_mc=n_mc, seed=seed, device=device,
    )


@_register("error_vs_paths")
def error_vs_paths(n_mc=8, seed=0, device=None, **kw):
    """``plot_errorVSpaths.m``: rays ∈ {1,3,6,9,12}; noise variance 10^(-5/10)."""
    return run_sweep(
        "error_vs_paths", "n_rays", [1, 3, 6, 9, 12],
        point_fn=lambda r: PointConfig(n_rays=r, methods=DEFAULT_METHODS, **kw),
        noise_fn=lambda r: _NV_PATHS_DELAYS_NRF, n_mc=n_mc, seed=seed, device=device,
    )


@_register("error_vs_delays")
def error_vs_delays(n_mc=8, seed=0, device=None, **kw):
    """``plot_errorVSdelays.m``: L ∈ {2,4,6,8,10} with T = 5·index,
    numOfnz=50; noise variance 10^(-5/10)."""
    Ls = [2, 4, 6, 8, 10]
    return run_sweep(
        "error_vs_delays", "L", Ls,
        point_fn=lambda L: PointConfig(
            L=L, T=5 * (Ls.index(L) + 1), num_nonzero=50, methods=DEFAULT_METHODS, **kw),
        noise_fn=lambda L: _NV_PATHS_DELAYS_NRF, n_mc=n_mc, seed=seed, device=device,
    )


@_register("error_vs_nt")
def error_vs_nt(n_mc=8, seed=0, device=None, **kw):
    """``plot_errorVSnt.m``: Nt ∈ {4,6,8,12,16} with the per-Nt T table,
    numOfnz=50, FFT combiner; noise variance 10^(-15/10)."""
    T_table = {4: 35, 6: 35, 8: 35, 12: 35, 16: 25}
    return run_sweep(
        "error_vs_nt", "Nt", [4, 6, 8, 12, 16],
        point_fn=lambda Nt: PointConfig(
            Nt=Nt, Gt=Nt, T=T_table[Nt], num_nonzero=50, beamformer="fft", methods=DEFAULT_METHODS, **kw),
        noise_fn=lambda Nt: _NV_FRAMELEN_NT_RATE, n_mc=n_mc, seed=seed, device=device,
    )


@_register("error_vs_nrf")
def error_vs_nrf(n_mc=8, seed=0, device=None, **kw):
    """``plot_errorVSnrf.m``: RF chains Mr ∈ {4,8,12,16}, T=5; noise
    variance 10^(-5/10)."""
    return run_sweep(
        "error_vs_nrf", "Mr", [4, 8, 12, 16],
        point_fn=lambda Mr: PointConfig(Mr=Mr, T=5, methods=DEFAULT_METHODS, **kw),
        noise_fn=lambda Mr: _NV_PATHS_DELAYS_NRF, n_mc=n_mc, seed=seed, device=device,
    )


# ---------------------------------------------------------------------------
# Specialized drivers
# ---------------------------------------------------------------------------

def _start(device) -> torch.device:
    """The recipe's device (:func:`resolve_device`, before any other work),
    with every float32 product on it in full float32."""
    device = resolve_device(device)
    use_full_fp32()
    return device


def _append(curves: Dict[str, list], sd: Dict[str, list], name: str, x: torch.Tensor) -> None:
    """Append the mean of one point's per-realization values x to the curve
    ``name`` and their standard deviation to ``sd`` (the result's ``sd``)."""
    curves.setdefault(name, []).append(float(x.mean()))
    sd.setdefault(name, []).append(float(x.std()) if x.numel() > 1 else float("nan"))


def _noiseless_frame(H: torch.Tensor, Psi: torch.Tensor) -> torch.Tensor:
    """``Σ_l H_l·Psi_l`` (the received frame without noise)."""
    return torch.einsum("...lmn,...lnt->...mt", H, Psi)


@_register("rate_vs_framelength")
def rate_vs_framelength(n_mc=8, seed=0, device=None, **kw):
    """``plot_rateVSframelength.m``: achievable rate (bits/s/Hz) vs
    T ∈ {5,10,15}; Nt=8, FFT combiner, numOfnz=50, noise variance
    10^(-15/10).  Per realization and method,
    ``log2 det(I + (1/Nr)·Z̄·Z̄ᴴ/(σ² + NMSE))`` of the raw (unclamped)
    spectral NMSE (``plot_rateVSframelength.m:81,113,130,135``)."""
    device = _start(device)
    methods = ("ls", "omp_mmv", "proposed", "proposed_angles")
    nv = _NV_FRAMELEN_NT_RATE
    t0 = time.time()
    curves: Dict[str, list] = {}
    sd: Dict[str, list] = {}
    T_values = [5, 10, 15]
    for i, T in enumerate(T_values):
        pc = PointConfig(Nt=8, Gt=8, T=T, num_nonzero=50, beamformer="fft", methods=methods, **kw)
        gens = prng.realization_generators(seed, i, device)
        out = realization_errors(gens, pc, nv, n_mc, clamp=False, with_zbar=True)
        Zbar = out.pop("Zbar")
        for m, e in out.items():
            _append(curves, sd, m, achievable_rate(Zbar, e, nv, pc.Nr))
    return SweepResult("rate_vs_framelength", "T", T_values, curves, n_mc, time.time() - t0, sd=sd)


def _approx_problem(gens, noise_var, batch: int, *, T, sub_ratio, quirks=False):
    """One batch of the ``plot_errorVSsnr_approx.m`` front end (Nt=4, Nr=32,
    L=4): the channel, then ``comm_system_training``; A = Wᴴ·Dr (shared, the
    FFT combiner) and B built from the Gaussian frames the wrapper sent
    (``:55-58``).  Returns (Y_p, Omega, A, B, Zbar)."""
    Nt, Nr, L = 4, 32, 4
    ch = wideband_mmwave_channel(gens[prng.ROLE_CHANNEL], L, Nr, Nt, 2, 3, Nr, Nt, quirks=quirks, batch=(batch,))
    Yp, _, W, Omega, _, Psi = comm_system_training(gens, ch.H, T, noise_var, sub_ratio)
    A, B = _dictionaries(ch, W, Psi)
    return Yp, Omega, A, B, ch.Zbar


def _approx_hyperparams(Yp: torch.Tensor):
    """This driver's own hyper-parameters (``plot_errorVSsnr_approx.m:50-53``),
    not the canonical recipe's: τ_X = 1/‖Y_p‖²_F, τ_S = τ_X/2 and
    ρ = sqrt(λ₆·(τ_X+τ_S)/2), λ₆ the sixth largest eigenvalue of Y_p·Y_pᴴ
    (the smallest of MATLAB ``eigs``' six)."""
    tau_X = 1.0 / torch.sum(Yp.abs() ** 2, dim=(-2, -1))
    tau_S = tau_X / 2.0
    ev = torch.linalg.eigvalsh(Yp @ Yp.mH)  # ascending
    rho = torch.sqrt(torch.clamp(ev[..., -6], min=0.0) * (tau_X + tau_S) / 2.0)
    return tau_X, tau_S, rho


def _approx_errors(Yp, Omega, A, B, Zbar, Imax: int, mode: str, use_kernels: bool = True):
    """Clamped NMSE of the proposed ADMM in ``mode`` ('exact' is the
    reference's 'std'), S recovered by LS de-mixing of the completed Y
    (``plot_errorVSsnr_approx.m:60-72``)."""
    tau_X, tau_S, rho = _approx_hyperparams(Yp)
    res = proposed_admm(Yp, Omega, A, B, Imax, tau_X, tau_S, rho, mode=mode, use_kernels=use_kernels)
    return clamped_nmse(ls_estimate(res.Y, A, B), Zbar)


def _approx_realization(gens, noise_var, batch: int, *, T, sub_ratio, Imax, mode, quirks=False,
                        use_kernels: bool = True):
    """A batch of the ``plot_errorVSsnr_approx.m`` pipeline: (batch,) clamped NMSE."""
    prob = _approx_problem(gens, noise_var, batch, T=T, sub_ratio=sub_ratio, quirks=quirks)
    return _approx_errors(*prob, Imax, mode, use_kernels=use_kernels)


@_register("error_vs_snr_approx")
def error_vs_snr_approx(n_mc=8, seed=0, device=None, T=70, sub_ratio=0.75, channel_quirks=False, **kw):
    """``plot_errorVSsnr_approx.m``: SNR −15:5:15 × Imax ∈ {10,30,50},
    'std' (exact) vs 'approximate' ADMM (T=70, subSamplingRatio=0.75,
    reference MC count 50)."""
    device = _start(device)
    curves: Dict[str, list] = {}
    sd: Dict[str, list] = {}
    snrs = list(range(-15, 16, 5))
    t0 = time.time()
    for mode in ("exact", "approximate"):
        for Imax in (10, 30, 50):
            label = f"{mode}_I{Imax}"
            for i, s in enumerate(snrs):
                gens = prng.realization_generators(seed, i, device)
                errs = _approx_realization(gens, _nv(s), n_mc, T=T, sub_ratio=sub_ratio, Imax=Imax, mode=mode,
                                           quirks=channel_quirks)
                _append(curves, sd, label, errs)
    return SweepResult("error_vs_snr_approx", "snr_db", snrs, curves, n_mc, time.time() - t0, sd=sd)


def _ps_problem(gens, batch: int, noise_var, *, Nt, Mr, n_rays, T):
    """A batch of the 'ps'-combiner drivers' proposed front end (Nr = Mr_e =
    32, L = 4, QAM-4 training): (channel, observation, A, B)."""
    Nr, Mr_e, L = 32, 32, 4
    device = gens[prng.ROLE_CHANNEL].device
    ch = wideband_mmwave_channel(gens[prng.ROLE_CHANNEL], L, Nr, Nt, 2, n_rays, Nr, Nt, batch=(batch,))
    Psi = qam4_training_frames(gens[prng.ROLE_TRAINING], Nt, T, L, batch=(batch,))
    N = awgn(gens[prng.ROLE_NOISE], Nr, T, noise_var, batch=(batch,))
    W = create_beamformer(Nr, "ps", device=device)
    obs = proposed_hbf(gens[prng.ROLE_MASK], ch.H, N, Psi, Mr_e, Mr, W)
    A, B = _dictionaries(ch, obs.W_e, Psi)
    return ch, obs, A, B


@_register("error_vs_zy")
def error_vs_zy(n_mc=4, seed=0, device=None, Imax=50, **kw):
    """``plot_errorVSzy.m``: Nt=16, Mr=16, 'ps' combiner, ρ/2; compares
    recovering S directly from the ADMM output Z vs LS on the completed Y
    (``plot_errorVSzy.m:66-75``)."""
    device = _start(device)
    t0 = time.time()
    gens = prng.realization_generators(seed, 0, device)
    ch, obs, A, B = _ps_problem(gens, n_mc, _nv(15), Nt=16, Mr=16, n_rays=6, T=5 * 16)
    tau_Y, tau_S, rho = admm_hyperparams(obs.Y, ch.Zbar)
    res = proposed_admm(obs.Y, obs.Omega, A, B, Imax, tau_Y, tau_S, rho / 2)
    curves: Dict[str, list] = {}
    sd: Dict[str, list] = {}
    _append(curves, sd, "from_Z", clamped_nmse(res.S, ch.Zbar))
    _append(curves, sd, "from_Y", clamped_nmse(ls_estimate(res.Y, A, B), ch.Zbar))
    return SweepResult("error_vs_zy", "F", [5], curves, n_mc, time.time() - t0, sd=sd)


@_register("error_vs_admmiters")
def error_vs_admmiters(n_mc=4, seed=0, device=None, Imax=100, snr_db=15, **kw):
    """``plot_errorVSadmmiters.m``: per-iteration convergence residuals
    ε1 = ‖V1‖²/‖X‖², ε2 = ‖V2‖²/‖X‖² for both algorithms
    (``plot_errorVSadmmiters.m:50-67``); Mr=16, T=10·Nt, 'ps' combiner."""
    device = _start(device)
    t0 = time.time()
    gens = prng.realization_generators(seed, 0, device)
    ch, obs, A, B = _ps_problem(gens, n_mc, _nv(snr_db), Nt=4, Mr=16, n_rays=3, T=10 * 4)
    tau_Y, tau_S, rho = admm_hyperparams(obs.Y, ch.Zbar)
    res = proposed_admm(obs.Y, obs.Omega, A, B, Imax, tau_Y, tau_S, rho, track_convergence=True)
    res_a = proposed_admm_angles(obs.Y, obs.Omega, _oracle_order(ch.Zbar), A, B, Imax, tau_Y, tau_S, rho,
                                 track_convergence=True)
    curves, sd = {}, {}
    for suffix, conv in (("", res.convergence), ("_angles", res_a.convergence)):  # (n_mc, Imax, 3)
        for name, col in (("eps1", 0), ("eps2", 1)):
            curves[name + suffix] = conv[..., col].mean(dim=0).tolist()
            sd[name + suffix] = conv[..., col].std(dim=0).tolist() if n_mc > 1 else [float("nan")] * Imax
    return SweepResult("error_vs_admmiters", "iteration", list(range(1, Imax + 1)), curves, n_mc,
                       time.time() - t0, sd=sd)


@_register("capacity")
def capacity(n_mc=64, seed=0, device=None, snr_db=15, sizes=((16, 32, 32), (16, 64, 32), (16, 128, 64)), **kw):
    """``plot_capacity.m``: ASE vs Mr for digital / PS-HBF / ZC-HBF /
    proposed front ends (noiseless observation, T=5) at all three reference
    array geometries (Nt, Nr, Mr_e) = (16,32,32) / (16,64,32) / (16,128,64)
    (``plot_capacity.m:8-20,92-104,175-187``; reference MC count is 1e4).

    Mr enters only through which combiner columns are kept, and a zeroed
    column adds an identity block to the log-det: each point keeps the
    first Mr of 31 combined outputs by a mask on Wᴴ·Y, with no copy of W.
    The proposed combiner is a random Mr_e-permutation of the 'quantized'
    one per realization (``plot_capacity.m:63-64``), drawn from the mask
    role's generator."""
    device = _start(device)
    t0 = time.time()
    curves: Dict[str, list] = {}
    sd: Dict[str, list] = {}
    nv = _nv(snr_db)
    Mr_values = list(range(1, 32, 3))
    Mmax = max(Mr_values)
    L, T = 4, 5
    for (Nt, Nr, Mr_e) in sizes:
        W_zc = create_beamformer(Nr, "ZC", device=device)
        W_q = create_beamformer(Nr, "quantized", device=device)
        tag = f"Nr{Nr}"
        for i, Mr in enumerate(Mr_values):
            gens = prng.realization_generators(seed, i, device)
            ch = wideband_mmwave_channel(gens[prng.ROLE_CHANNEL], L, Nr, Nt, 2, 3, Nr, Nt, batch=(n_mc,))
            Psi = qam4_training_frames(gens[prng.ROLE_TRAINING], Nt, T, L, batch=(n_mc,))
            Y = _noiseless_frame(ch.H, Psi)
            keep = (torch.arange(Mmax, device=device) < Mr).to(Y.real.dtype)[:, None]
            scores = torch.rand((n_mc, Mr_e), generator=gens[prng.ROLE_MASK], device=device)
            perm = torch.argsort(scores, dim=-1)[:, :Mmax]  # a random Mr_e-permutation's first Mmax
            # the proposed combiner's outputs, gathered from the wide combiner's
            G_p = torch.take_along_dim(W_q[:, :Mr_e].mH @ Y, perm[..., None], dim=-2)
            for name, c in (
                ("dbf", spectral_efficiency(Y, W_zc, nv, Nt)),
                ("hbf_ps", combined_spectral_efficiency(keep * (W_q[:, :Mmax].mH @ Y), nv, Nt)),
                ("hbf_zc", combined_spectral_efficiency(keep * (W_zc[:, :Mmax].mH @ Y), nv, Nt)),
                ("proposed", combined_spectral_efficiency(keep * G_p, nv, Nt)),
            ):
                _append(curves, sd, f"{name}_{tag}", c)
    return SweepResult("capacity", "Mr", Mr_values, curves, n_mc, time.time() - t0, sd=sd)


@_register("energy_efficiency")
def energy_efficiency(n_mc=64, seed=0, device=None, **kw):
    """``plot_ee.m``: EE = capacity/power vs Mr (Nt=16, Nr=64, Mr_e=32)."""
    Nt, Nr, Mr_e = 16, 64, 32
    cap = capacity(n_mc=n_mc, seed=seed, device=device, sizes=((Nt, Nr, Mr_e),), **kw)
    tag = f"Nr{Nr}"
    curves: Dict[str, list] = {}
    sd: Dict[str, list] = {}
    for i, Mr in enumerate(cap.sweep_values):
        for name, power in (("dbf", power_digital_bf(Nr)), ("hbf_ps", power_conventional_hbf(Nr, Mr)),
                            ("hbf_zc", power_conventional_hbf(Nr, Mr, zc=True)),
                            ("proposed", power_proposed(Nr, Mr_e))):
            curves.setdefault(f"ee_{name}", []).append(cap.curves[f"{name}_{tag}"][i] / power)
            sd.setdefault(f"ee_{name}", []).append(cap.sd[f"{name}_{tag}"][i] / power)
    return SweepResult("energy_efficiency", "Mr", cap.sweep_values, curves, n_mc, cap.seconds, sd=sd)


@_register("rank_r")
def rank_r(n_mc=16, seed=0, device=None, geometries=None, channel_quirks=False, **kw):
    """``plot_rankR.m``: mean singular-value spectra of the noiseless
    wide-combiner observation Y = W̃ᴴ·R for L ∈ {1,4,8}, the low-rank
    justification (rank marker at min(Np, L·Nt)).

    Six panels by default: Nr ∈ {32, 64, 128} (Mr_e=32, Nt=4, T=50) at
    clusters=2/rays=3 (Np=6) and clusters=3/rays=12 (Np=36); each gives the
    min(Nr, Mr_e)=32 singular values of the 32×50 observation (QAM-4
    Toeplitz training, ZC combiner, no noise; ``plot_rankR.m``).
    ``geometries`` entries are (Nr, Mr_e, Nt, clusters, rays)."""
    device = _start(device)
    if geometries is None:
        geometries = tuple((Nr, 32, 4, c, r) for (c, r) in ((2, 3), (3, 12)) for Nr in (32, 64, 128))
    t0 = time.time()
    curves: Dict[str, list] = {}
    sd: Dict[str, list] = {}
    L_values = [1, 4, 8]
    T = 50  # plot_rankR.m:19 (all six panels)
    for (Nr, Mr_e, Nt, n_cl, n_rays) in geometries:
        W = create_beamformer(Nr, "ZC", device=device)
        for L in L_values:
            gens = prng.realization_generators(seed, L, device)
            ch = wideband_mmwave_channel(gens[prng.ROLE_CHANNEL], L, Nr, Nt, n_cl, n_rays, Nr, Nt,
                                         quirks=channel_quirks, batch=(n_mc,))
            Psi = qam4_training_frames(gens[prng.ROLE_TRAINING], Nt, T, L, batch=(n_mc,))
            Y = W[:, :Mr_e].mH @ _noiseless_frame(ch.H, Psi)
            sig2 = torch.linalg.eigvalsh(Y @ Y.mH).flip(-1)
            sv = torch.sqrt(torch.clamp(sig2, min=0.0))
            key = f"Nr{Nr}_Mre{Mr_e}_Np{n_cl * n_rays}_L{L}"
            curves[key] = sv.mean(dim=0).tolist()
            sd[key] = sv.std(dim=0).tolist() if n_mc > 1 else [float("nan")] * sv.shape[-1]
    res = SweepResult("rank_r", "sv_index", list(range(1, 1 + min(len(c) for c in curves.values()))),
                      curves, n_mc, time.time() - t0, sd=sd)
    # the marker per geometry, min(Np, L·Nt) with that geometry's Nt
    res.extras["rank_marker"] = {
        f"Np{c * r}_Nt{Nt}": {f"L{L}": min(c * r, L * Nt) for L in L_values}
        for (_, _, Nt, c, r) in geometries
    }
    res.extras["channel_quirks"] = channel_quirks
    return res


@_register("rank_r_quirks")
def rank_r_quirks(n_mc=16, seed=0, device=None, geometries=None, **kw):
    """:func:`rank_r` under the reference-quirks ensemble, the generating
    mode of the committed fig: the tap-1 steering reuse
    (``wideband_mmwave_channel.m:24``) caps the stacked beamspace rank at Np."""
    res = rank_r(n_mc=n_mc, seed=seed, device=device, geometries=geometries, channel_quirks=True, **kw)
    res.name = "rank_r_quirks"
    return res


@_register("error_vs_snr_nyuwireless")
def error_vs_snr_nyuwireless(n_mc=8, seed=0, device=None, mat_path=None, **kw):
    """``plot_errorVSsnr_nyuwireless.m``: the SNR sweep on NYU-Wireless
    ray-traced channels.  With ``mat_path`` the channels are read and each
    tap normalized (``:59-70``); the file is not part of the reference, so
    without it n_mc synthetic channels, drawn once and held over the SNR
    points as the file's would be, go through the same normalization."""
    device = _start(device)
    taps = load_nyu_taps(mat_path, device) if mat_path else None
    if taps is not None:
        taps = normalize_taps(taps)
        n_real, L, Nr, Nt = taps.shape
        n_mc = min(n_mc, n_real)
        taps = taps[:n_mc]
        dims = dict(L=L, Nr=Nr, Nt=Nt)
        dims.update({k: kw.pop(k) for k in ("Gr", "Gt", "Mr_e", "Mr") if k in kw})
        dims.setdefault("Gr", Nr)
        dims.setdefault("Gt", Nt)
        dims.setdefault("Mr_e", Nr)  # the wide combiner is bounded by the array
        dims.setdefault("Mr", max(1, Nr // 8))
        kw = {**dims, **kw}
    base = PointConfig(methods=("ls", "vamp", "proposed", "proposed_angles"), **kw)
    if taps is None:
        gen = prng.realization_generators(seed, 9999, device)[prng.ROLE_CHANNEL]
        taps = normalize_taps(wideband_mmwave_channel(
            gen, base.L, base.Nr, base.Nt, base.n_clusters, base.n_rays, base.Gr, base.Gt, batch=(n_mc,)).H)
    return run_sweep(
        "error_vs_snr_nyuwireless", "snr_db", list(range(-15, 16, 3)),
        point_fn=lambda s: base, noise_fn=_nv, n_mc=n_mc, seed=seed, device=device, taps=taps,
    )


@_register("channel_correlation")
def channel_correlation(n_mc=1, seed=0, device=None, **kw):
    """``plot_channelcorrelation_nyuwireless.m``: beamspace correlation
    surface |Z̄·Z̄ᴴ| of a synthetic channel (``:17-31``)."""
    device = _start(device)
    t0 = time.time()
    ch = wideband_mmwave_channel(prng.role_generator(seed, 0, prng.ROLE_CHANNEL, device), 4, 32, 4, 2, 3, 32, 4)
    C = (ch.Zbar @ ch.Zbar.mH).abs().cpu().numpy()
    res = SweepResult("channel_correlation", "row", list(range(C.shape[0])),
                      {"corr_rows_max": C.max(axis=1).tolist()}, n_mc, time.time() - t0)
    res.extras["surface"] = C.tolist()
    return res


@_register("bar3_beamspace")
def bar3_beamspace(n_mc=1, seed=0, device=None, **kw):
    """``plot_bar3.m``: |Z̄| magnitude grids for L ∈ {4,8,12} (the shipped
    script plots an undefined variable; here each grid is produced)."""
    device = _start(device)
    t0 = time.time()
    curves, extras = {}, {}
    for L in (4, 8, 12):
        ch = wideband_mmwave_channel(prng.role_generator(seed + L, 0, prng.ROLE_CHANNEL, device), L, 32, 4, 2, 3, 32, 4)
        mag = ch.Zbar.abs().cpu().numpy()
        curves[f"L{L}_colmax"] = mag.max(axis=0).tolist()
        extras[f"L{L}"] = mag.tolist()
    res = SweepResult("bar3_beamspace", "column", list(range(len(curves["L4_colmax"]))), curves, n_mc,
                      time.time() - t0)
    res.extras.update(extras)
    return res


@_register("time_comparisons")
def time_comparisons(n_mc=4, seed=0, device=None, reps=3, **kw):
    """``plot_time_comparisions.m``: wall-clock of each estimator at the
    canonical config (here: the best of ``reps`` timed batches over the
    realizations, each family at :func:`fastest_point_config`)."""
    device = _start(device)
    t0 = time.time()
    curves: Dict[str, list] = {}
    for method in ("ls", "vamp", "omp_mmv", "proposed", "proposed_angles", "svt", "tssr"):
        pc = fastest_point_config(method)
        run_point(pc, _nv(0), n_mc, seed=seed, device=device)  # warm-up: builds, caches
        best = float("inf")
        for _ in range(reps):
            t1 = time.time()
            run_point(pc, _nv(0), n_mc, seed=seed, device=device)  # returns host arrays: synchronised
            best = min(best, time.time() - t1)
        curves[method] = [best / n_mc]
    res = SweepResult("time_comparisons", "seconds_per_realization", [0], curves, n_mc, time.time() - t0)
    res.extras["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    if device.type == "cuda":
        from jstsp19_torch.bench import card_line

        res.extras["card"] = card_line()
    res.extras["note"] = (
        f"latency-bound small-batch numbers (batch={n_mc}): per-realization wall-clock at this batch, not "
        "peak throughput; the batched throughput of every family at B=256, with its spread, comes from "
        "`python -m jstsp19_torch.bench_all`"
    )
    return res
