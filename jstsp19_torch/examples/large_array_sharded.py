"""Large-array OFDM capacity/EE on a sharded device mesh.

BASELINE.json config 5: the Nr=128 / Mr_e=64 receive geometry
(``plot_capacity.m:175-187``) with K=64 subcarriers and the Monte-Carlo
realizations shared over ranks of ``torch.distributed``
(``jstsp19_torch/parallel/``): one rank drives one device, and each takes
its share of the realizations; rank 0 gathers the per-subcarrier rates and
prints.  The JAX script's mesh also splits the subcarrier axis (its ``sp``
axis); here a rank computes all K subcarriers of its realizations.  The
printout equals a one-process run's; the header names the ranks where the
JAX script names its mesh.

Run: python -m jstsp19_torch demo large_array_sharded [--cpu] [--ranks N]
(``--ranks N`` starts N ranks on this host; they share the card over gloo,
or run on the CPU with ``--cpu``).  ``python -m
jstsp19_torch.examples.large_array_sharded [--ranks N] --labels`` prints the
numbers unrounded, by label (``_common.labelled``), as one JSON line.
"""
import json
import math
import os
import sys

import numpy as np
import torch

from jstsp19_torch.channel import taps_to_subcarriers, wideband_mmwave_channel
from jstsp19_torch.core import prng
from jstsp19_torch.core.metrics import power_conventional_hbf, power_proposed
from jstsp19_torch.examples import _common

SEED = 0
TOLERANCE = ()  # the classes of _common.tolerance
NT, NR, MR_E, MR = 16, 128, 64, 16
L, K = 8, 64
N_MC = 8
SNR_DB = 10.0
NV = 10 ** (-SNR_DB / 10)


def build(device, gen):
    """The N_MC channels from ``fold_in(gen, ROLE_CHANNEL)`` and the combiner
    phases' uniforms from ``fold_in(gen, ROLE_BEAMFORMER)``, one batch."""
    ch = wideband_mmwave_channel(prng.fold_in(gen, prng.ROLE_CHANNEL), L, NR, NT, 2, 3, NR, NT, batch=(N_MC,))
    u = torch.rand((N_MC, NR, MR_E), generator=prng.fold_in(gen, prng.ROLE_BEAMFORMER))
    return _common.moved(dict(H=ch.H, u=u), device)


def capacity(p, rows=slice(None)):
    """Per-subcarrier ASE (realizations of ``rows``, K) in bits/s/Hz:
    log2 det(I + 1/(σ² Nt) Wᴴ H_k H_kᴴ W) with a random Mr_e-subset of a
    quantized-phase bank, Mr outputs kept (plot_capacity.m:63-64)."""
    Hk = taps_to_subcarriers(p["H"][rows], K)  # (b, K, Nr, Nt)
    W = torch.exp(2j * math.pi * torch.round(p["u"][rows] * 64) / 64) / math.sqrt(NR)
    Wm = W[..., :MR]
    G = torch.einsum("bnm,bknt->bkmt", Wm.conj(), Hk)  # (b, K, Mr, Nt)
    Gram = G @ G.mH
    eye = torch.eye(MR, dtype=Gram.dtype, device=Gram.device)
    return torch.linalg.slogdet(eye + Gram / (NV * NT))[1] / math.log(2.0)


def lines(p, cap=None, ranks=1):
    cap = (capacity(p) if cap is None else cap).double().cpu().numpy()
    mean_cap = float(cap.mean())
    spec = cap.mean(axis=0)
    return [("ranks {}, Nr={} Mr_e={} Mr={} K={} n_mc={} @ {:.0f} dB", (ranks, NR, MR_E, MR, K, N_MC, SNR_DB)),
            ("mean ASE over {} subcarriers: {:.2f} bits/s/Hz", (K, mean_cap)),
            ("EE (proposed wide-combiner power model): {:.2f} bits/Joule", (mean_cap / power_proposed(NR, MR_E),)),
            ("EE (conventional HBF power model):      {:.2f} bits/Joule", (mean_cap / power_conventional_hbf(NR, MR),)),
            ("subcarrier ASE spectrum: min {:.2f} / median {:.2f} / max {:.2f}",
             (float(spec.min()), float(np.median(spec)), float(spec.max())))]


def solve(problem):
    return _common.labelled(lines(problem))


def _show(text_lines, labels: bool) -> None:
    print(json.dumps(_common.labelled(text_lines)) if labels else "\n".join(_common.printed(text_lines)))


def _rank_main(cpu: bool, labels: bool) -> None:
    """One rank: its share of the realizations, gathered to rank 0, which prints."""
    import torch.distributed as dist

    from jstsp19_torch.parallel import distributed

    device = distributed.initialize_from_env(cpu=cpu)
    rank, world = dist.get_rank(), dist.get_world_size()
    p = build(device, _common.generator(SEED))
    mine = capacity(p, slice(rank * N_MC // world, (rank + 1) * N_MC // world)).cpu()
    parts = [None] * world
    dist.all_gather_object(parts, mine)
    if rank == 0:
        _show(lines(p, torch.cat(parts), ranks=world), labels)
    distributed.finish(0)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    from jstsp19_torch.parallel.distributed import ENV_PID

    cpu, labels = "--cpu" in argv, "--labels" in argv
    if ENV_PID in os.environ:
        _rank_main(cpu, labels)
    ranks = int(argv[argv.index("--ranks") + 1]) if "--ranks" in argv else 1
    device = _common.device_from_argv(argv)
    if device is None:
        return 1
    if ranks == 1:
        _show(lines(build(device, _common.generator(SEED))), labels)
        return 0
    from jstsp19_torch.parallel.launch import launch

    flags = [f for f in ("--cpu", "--labels") if f in argv]
    try:
        results = launch(ranks, ["-m", "jstsp19_torch.examples.large_array_sharded", *flags], timeout=600)
    except (RuntimeError, TimeoutError) as e:
        print(f"--ranks {ranks}: {e}", file=sys.stderr)
        return 1
    # rank 0's printout, without its join line and the collectives' warnings
    # (both "[...]"; the launcher merges a rank's stderr into its stdout)
    print("\n".join(ln for ln in results[0].stdout.splitlines() if not ln.startswith("[")))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
