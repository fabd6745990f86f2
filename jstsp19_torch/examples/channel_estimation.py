"""End-to-end wideband mmWave channel estimation demo.

Generates one channel realization at the canonical errorVSsnr configuration,
sounds it through the random-spatial-sampling hybrid receiver, and recovers
the beamspace channel with LS / VAMP / MMV-OMP / the proposed ADMM
(the `plot_errorVSsnr.m` pipeline as a minimal script).

Run: python -m jstsp19_torch demo channel_estimation [--cpu]
"""
import torch

from jstsp19_torch.channel.widemmwave import Channel
from jstsp19_torch.core import prng
from jstsp19_torch.examples import _common
from jstsp19_torch.frontend import proposed_hbf
from jstsp19_torch.harness import pipeline

SEED = 0
# VAMP's 100 damped float32 iterations: JAX's own jitted and eager runs of
# this realization give 0.17300 and 0.16602 (4.0%); the port 0.17506
TOLERANCE = ((r" vamp NMSE", "rel", 5e-2),)
SNR_DB = 10.0
PC = pipeline.PointConfig(methods=("ls", "vamp", "omp_mmv", "proposed", "proposed_angles"))


def build(device, gen):
    """One realization's channel, training, noise, combiner and sampling
    mask (one batch of 1), each role from ``fold_in(gen, role)``."""
    gens = {r: prng.fold_in(gen, r) for r in prng.ROLES}
    ch, Psi, N, W, obs = pipeline.point_draws(gens, PC, 10 ** (-SNR_DB / 10), 1)
    drawn = dict(ch._asdict(), Psi=Psi[0], N=N[0], W=W, Omega=obs.Omega[0])
    for k in ("H", "Zbar", "Ar", "At"):
        drawn[k] = drawn[k][0]
    return {k: v.to(device) for k, v in drawn.items()}


def lines(p):
    nv = torch.tensor(10 ** (-SNR_DB / 10), dtype=torch.float32, device=p["H"].device)
    ch = Channel(p["H"][None], p["Zbar"][None], p["Ar"][None], p["At"][None], p["Dr"], p["Dt"])
    Psi, N, W = p["Psi"][None], p["N"][None], p["W"]
    obs = proposed_hbf(None, ch.H, N, Psi, PC.Mr_e, PC.Mr, W, Omega=p["Omega"][None])
    errs = pipeline.realization_errors(None, PC, nv, 1, draws=(ch, Psi, N, W, obs))
    out = [("SNR = {} dB (Nt={}, Nr={}, Mr={}/{}, T={})", (SNR_DB, PC.Nt, PC.Nr, PC.Mr, PC.Mr_e, PC.T))]
    for m, e in sorted(errs.items()):
        out.append(("  {:18s} NMSE = {:.4f}", (m, float(e[0]))))
    return out


def solve(problem):
    return _common.labelled(lines(problem))


def main(argv=None):
    return _common.main(build, lines, SEED, argv)


if __name__ == "__main__":
    raise SystemExit(main())
