"""Headline benchmark of the port: proposed-ADMM channel estimations per second.

Runs the canonical errorVSsnr point (Nt=4, Nr=32, Mr_e=32, Mr=4, L=4, T=35,
Imax=100, 0 dB — ``plot_errorVSsnr.m:8-25``) as one batch of Monte-Carlo
realizations on one CUDA device: channel synthesis → random-spatial-sampling
HBF → proposed ADMM → clamped NMSE.  Each timed rep draws a fresh batch;
times come from CUDA events around the whole batch, over 5 reps after one
warm-up, and the best, median and spread are reported.

    python -m jstsp19_torch.bench [batch] [--svt-method fused|tracked|eigh]

Output: ONE JSON line on stdout,
  {"metric": "proposed_admm_channel_estimations_per_sec", "value": N, ...};
the device, NMSE context and per-rep times go to stderr.  Needs a CUDA
device: there is no CPU fallback for a measurement.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Any, Callable, List, Tuple

import torch

from jstsp19_torch.core import prng
from jstsp19_torch.harness.pipeline import PointConfig, fused_point_errors, realization_errors

MATLAB_EST_PER_SEC_ESTIMATE = 1.0  # the JAX bench's conservative MATLAB estimate
NOISE_VAR_0DB = 1.0
REPS = 5


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def run_route(svt_method: str, batch: int, seed: int, device="cuda") -> torch.Tensor:
    """One batch of the canonical point on one route; returns (batch,) NMSE."""
    pc = PointConfig(methods=("proposed",), svt_method=svt_method)
    gens = prng.realization_generators(seed, 0, device)
    if svt_method == "fused":
        return fused_point_errors(gens, pc, NOISE_VAR_0DB, batch)["proposed"]
    return realization_errors(gens, pc, NOISE_VAR_0DB, batch)["proposed"]


def cuda_event_times(fn: Callable[[int], Any], reps: int) -> Tuple[List[float], List[Any]]:
    """Call ``fn(0)`` once untimed, then ``fn(1)`` .. ``fn(reps)``, each
    between two CUDA events; returns the seconds of each timed call and
    its output."""
    fn(0)
    torch.cuda.synchronize()
    times, outs = [], []
    for r in range(1, reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs.append(fn(r))
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return times, outs


def time_route(svt_method: str, batch: int, reps: int = REPS) -> Tuple[List[float], List[float]]:
    """Seconds per rep and the NMSE batch mean of each rep; every rep draws
    a fresh batch (seed = rep number, the warm-up uses seed 0)."""
    times, errs = cuda_event_times(lambda r: run_route(svt_method, batch, r), reps)
    return times, [float(e.mean()) for e in errs]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("batch", nargs="?", type=int, default=256)
    p.add_argument("--svt-method", default="fused", choices=("fused", "tracked", "eigh"))
    ns = p.parse_args()
    if not torch.cuda.is_available():
        print("bench: no CUDA device; the benchmark measures the GPU only", file=sys.stderr)
        return 1
    card = card_line()
    times, means = time_route(ns.svt_method, ns.batch)
    best = min(times)
    srt = sorted(times)
    median = srt[len(srt) // 2]
    est = ns.batch / best
    print(
        f"[bench] card={card!r} route={ns.svt_method} batch={ns.batch} reps={REPS} "
        f"times_s={[round(t, 6) for t in times]} NMSE@0dB batch means={[round(m, 4) for m in means]}",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": "proposed_admm_channel_estimations_per_sec",
        "value": est,
        "unit": "estimations/s (canonical errorVSsnr config, Imax=100)",
        "vs_baseline": est / MATLAB_EST_PER_SEC_ESTIMATE,
        "best_s": best,
        "median_s": median,
        "spread_s": max(times) - best,
        "reps": REPS,
        "route": ns.svt_method,
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
