"""Batched throughput of every estimator family of the port, the
``plot_time_comparisions.m`` analog (counterpart of the root ``bench_all.py``).

Each family runs as one batch of Monte-Carlo realizations of the canonical
errorVSsnr point (Imax=100, 0 dB), channel synthesis to clamped NMSE, at its
fastest configuration (``harness/pipeline.py::fastest_point_config``; the
``mc_admm`` family completes the unmasked frame ``Y_full`` on 'tracked' and
LS-de-mixes it).  Every timed rep draws a fresh batch; the times come from
CUDA events around the whole batch (the host clock with ``--cpu``), over
``--reps`` reps after one warm-up, and the table gives est/s from the best,
the best, median and spread, ``vs_matlab`` against the conservative
single-workstation MATLAB estimate of 1 est/s (the JAX bench's), and the
mean NMSE over the timed batches.  ``--batches 1,4,32`` adds the best wall
time of each family at those batch sizes (the latency axis).

    python -m jstsp19_torch.bench_all [--batch 256] [--reps 5] [--batches 1,4,32]
                                      [--methods m1,m2] [--out results_torch/bench_all.json] [--cpu]

The table goes to stdout, the artifact to ``--out`` (git-ignored
``results_torch/`` by default, never ``results/``).  Without ``--cpu`` it
needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict

import torch

from jstsp19_torch.bench import NOISE_VAR_0DB, card_line, cuda_event_times
from jstsp19_torch.core import prng
from jstsp19_torch.core.metrics import clamped_nmse
from jstsp19_torch.harness.pipeline import PointConfig, _proposed_frontend, fastest_point_config
from jstsp19_torch.harness.runner import run_point
from jstsp19_torch.solvers.lowrank import mc_admm
from jstsp19_torch.solvers.lsq import ls_estimate

METHODS = ("ls", "vamp", "omp_mmv", "omp_td", "svt", "tssr", "mc_admm", "proposed", "proposed_angles")
MATLAB_EST_PER_SEC = 1.0  # the JAX bench's conservative single-workstation MATLAB estimate


def mc_admm_errors(gens, noise_var, batch: int) -> torch.Tensor:
    """(batch,) clamped NMSE of the mc_admm family at the canonical point:
    ADMM completion of ``Y_full`` from its masked observation on the
    'tracked' SVT (``mc_admm.m``), then LS de-mixing."""
    pc = PointConfig()
    ch, obs, A_p, B_p, tau_Y, _, rho = _proposed_frontend(gens, pc, noise_var, batch)
    X, _ = mc_admm(obs.Y_full, obs.Y, obs.Omega, pc.Imax, tau_Y, rho, svt_method="tracked")
    return clamped_nmse(ls_estimate(X, A_p, B_p), ch.Zbar)


def family_run(method: str, device) -> Callable[[int, int], torch.Tensor]:
    """``run(seed, batch)`` → (batch,) NMSE of one family at 0 dB."""
    if method == "mc_admm":
        return lambda seed, batch: mc_admm_errors(prng.realization_generators(seed, 0, device), NOISE_VAR_0DB, batch)
    pc = fastest_point_config(method)
    return lambda seed, batch: torch.as_tensor(run_point(pc, NOISE_VAR_0DB, batch, seed=seed, device=device)[method])


def timed(run: Callable[[int, int], torch.Tensor], batch: int, reps: int, device):
    """(seconds of each of ``reps`` timed batches, their NMSE): seed 0 warms
    up, seeds 1..reps are timed between CUDA events (on the CPU, the host
    clock)."""
    if device.type == "cuda":
        return cuda_event_times(lambda r: run(r, batch), reps)
    run(0, batch)
    times, outs = [], []
    for r in range(1, reps + 1):
        t0 = time.perf_counter()
        outs.append(run(r, batch))
        times.append(time.perf_counter() - t0)
    return times, outs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--batches", default="", help="comma-separated batch sizes of the latency table, e.g. 1,4,32")
    p.add_argument("--methods", default=",".join(METHODS))
    p.add_argument("--out", default=os.path.join("results_torch", "bench_all.json"))
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    ns = p.parse_args(argv)
    if ns.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        print("bench_all: no CUDA device; pass --cpu to run on the CPU", file=sys.stderr)
        return 1
    methods = [m.strip() for m in ns.methods.split(",") if m.strip()]
    for m in methods:
        if m not in METHODS:
            print(f"bench_all: unknown family {m!r}; one of {', '.join(METHODS)}", file=sys.stderr)
            return 1
    if device.type == "cuda":
        card, kind = card_line(), torch.cuda.get_device_name(0)
    else:
        card, kind = "cpu (no card)", "cpu"
    batches = [int(b) for b in ns.batches.split(",") if b.strip()]

    rows: Dict[str, dict] = {}
    print(f"[bench_all] B={ns.batch}, 0 dB, canonical point, best/median/spread of {ns.reps} reps after a warm-up "
          f"(card: {card})", flush=True)
    for m in methods:
        run = family_run(m, device)
        times, outs = timed(run, ns.batch, ns.reps, device)
        srt = sorted(times)
        best, median = srt[0], srt[len(srt) // 2]
        est = ns.batch / best
        row = dict(
            config=fastest_point_config(m).svt_method if m != "mc_admm" else "tracked",
            est_per_sec=est, vs_matlab=est / MATLAB_EST_PER_SEC, best_s=best, median_s=median,
            spread_s=srt[-1] - best, reps=ns.reps, times_s=times, mean_nmse_0db=float(torch.cat(outs).mean()),
            batch=ns.batch,
        )
        if batches:
            row["latency_best_s"] = {str(b): min(timed(run, b, ns.reps, device)[0]) for b in batches}
        rows[m] = row
        lat = "".join(f", b{b} {row['latency_best_s'][str(b)] * 1e3:.3f} ms" for b in batches)
        print(f"[bench_all] {m:16s} {est:10.1f} est/s (vs_matlab {row['vs_matlab']:.1f}); best {best * 1e3:.3f} ms, "
              f"median {median * 1e3:.3f} ms, spread {row['spread_s'] * 1e3:.3f} ms over {ns.reps} reps "
              f"[{row['config']}]; NMSE@0dB {row['mean_nmse_0db']:.4f}{lat}", flush=True)

    out_dir = os.path.dirname(ns.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(ns.out, "w") as f:
        json.dump(dict(batch=ns.batch, reps=ns.reps, batches=batches, device=kind, card=card,
                       matlab_reference_est_per_sec=MATLAB_EST_PER_SEC,
                       config="canonical errorVSsnr (Imax=100, 0 dB), each family at fastest_point_config",
                       methods=rows), f, indent=1)
    print(f"[bench_all] wrote {ns.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
