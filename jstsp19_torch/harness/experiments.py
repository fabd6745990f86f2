"""The reference's NMSE sweep scripts as typed recipes
(counterpart of the ``run_sweep`` recipes of ``jstsp19_tpu/harness/experiments.py``).

Each entry reproduces one top-level ``plot_*.m`` script's configuration and
produces the same curve data (JSON instead of ``.fig``), with the JAX
recipes' sweep values, noise constants and method lists.  Recipes take
``device=`` where the JAX ones take ``mesh=``: the card unless named.  The specialized recipes
(rate, capacity, energy efficiency, rank, NYU, ...) are not ported yet
(ROADMAP.md Queue 1, item 5).
"""
from __future__ import annotations

from typing import Callable, Dict

from jstsp19_torch.harness.pipeline import PointConfig
from jstsp19_torch.harness.runner import run_sweep

EXPERIMENTS: Dict[str, Callable] = {}
ALL_METHODS = ("ls", "vamp", "omp_mmv", "proposed", "proposed_angles")


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
    base = PointConfig(methods=tuple(methods or ALL_METHODS), **kw)
    return run_sweep(
        "error_vs_snr", "snr_db", list(range(-15, 16, 3)),
        point_fn=lambda s: base, noise_fn=_nv, n_mc=n_mc, seed=seed, device=device,
    )


@_register("error_vs_snr_quirks")
def error_vs_snr_quirks(n_mc=64, seed=0, device=None, methods=None, **kw):
    """``plot_errorVSsnr.m`` under the reference-quirks channel ensemble
    (``channel_quirks=True``, the ensemble of the committed reference
    artifacts; PARITY.md)."""
    base = PointConfig(methods=tuple(methods or ALL_METHODS), channel_quirks=True, **kw)
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
            Nt=8, Gt=8, T=T, num_nonzero=50, beamformer="fft", methods=ALL_METHODS, **kw),
        noise_fn=lambda T: _NV_FRAMELEN_NT_RATE, n_mc=n_mc, seed=seed, device=device,
    )


@_register("error_vs_paths")
def error_vs_paths(n_mc=8, seed=0, device=None, **kw):
    """``plot_errorVSpaths.m``: rays ∈ {1,3,6,9,12}; noise variance 10^(-5/10)."""
    return run_sweep(
        "error_vs_paths", "n_rays", [1, 3, 6, 9, 12],
        point_fn=lambda r: PointConfig(n_rays=r, methods=ALL_METHODS, **kw),
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
            L=L, T=5 * (Ls.index(L) + 1), num_nonzero=50, methods=ALL_METHODS, **kw),
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
            Nt=Nt, Gt=Nt, T=T_table[Nt], num_nonzero=50, beamformer="fft", methods=ALL_METHODS, **kw),
        noise_fn=lambda Nt: _NV_FRAMELEN_NT_RATE, n_mc=n_mc, seed=seed, device=device,
    )


@_register("error_vs_nrf")
def error_vs_nrf(n_mc=8, seed=0, device=None, **kw):
    """``plot_errorVSnrf.m``: RF chains Mr ∈ {4,8,12,16}, T=5; noise
    variance 10^(-5/10)."""
    return run_sweep(
        "error_vs_nrf", "Mr", [4, 8, 12, 16],
        point_fn=lambda Mr: PointConfig(Mr=Mr, T=5, methods=ALL_METHODS, **kw),
        noise_fn=lambda Mr: _NV_PATHS_DELAYS_NRF, n_mc=n_mc, seed=seed, device=device,
    )
