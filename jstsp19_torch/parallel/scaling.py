"""Weak scaling over ranks: channel estimations per second at a fixed
per-rank batch (counterpart of ``jstsp19_tpu/parallel/scaling.py``).

For each rank count n (1, 2 and 4 unless named) the launcher starts n ranks
of ``parallel/distributed.py``'s worker on the canonical point, n × the
per-rank batch realizations, and reads back the best of ``reps`` sweeps
after the first; the efficiency is the per-rank throughput at n over the
per-rank throughput at 1.  Where the ranks share one card or run on the CPU
(here: more ranks than cards, or ``cpu``), per-rank throughput falls by
construction and the ratio says nothing about the interconnect, so no
efficiency is reported, only a note, as the JAX package does on its virtual
CPU mesh.

    python -m jstsp19_torch.parallel.scaling [--per-rank-batch 8] [--imax 50] [--ranks 1,2,4] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict, Sequence

import torch


def scaling_benchmark(
    methods: Sequence[str] = ("proposed",),
    Imax: int = 50,
    svt_method: str = "tracked",
    per_rank_batch: int = 8,
    noise_var: float = 1.0,
    rank_counts: Sequence[int] = (1, 2, 4),
    reps: int = 3,
    cpu: bool = False,
    timeout: float = 600,
) -> Dict:
    """Weak-scaling measurement; returns the rank counts, the throughput
    (est/s) and per-rank throughput at each, the backend, and either the
    efficiency or the note saying why there is none."""
    from jstsp19_torch.parallel.launch import launch

    res = {"rank_counts": list(rank_counts), "throughput": [], "per_rank": [], "backend": []}
    for n in rank_counts:
        with tempfile.TemporaryDirectory() as td:
            out = os.path.join(td, "point.json")
            launch(n, ["-m", "jstsp19_torch.parallel.distributed", "--methods", ",".join(methods),
                       "--imax", str(Imax), "--svt-method", svt_method, "--n-mc", str(per_rank_batch * n),
                       "--noise-vars", repr(float(noise_var)), "--reps", str(reps), "--out", out]
                   + (["--cpu"] if cpu else []), timeout=timeout)
            with open(out) as f:
                point = json.load(f)
        res["throughput"].append(point["throughput_est_per_s"])
        res["per_rank"].append(point["throughput_est_per_s"] / n)
        res["backend"].append(point["backend"])
    cards = 0 if cpu else torch.cuda.device_count()
    if max(rank_counts) <= cards:
        res["efficiency"] = [p / res["per_rank"][0] for p in res["per_rank"]]
    else:
        where = "the CPU" if cpu else f"{cards} card(s)"
        res["note"] = (f"ranks share {where}: per-rank throughput falls by construction, so no efficiency is "
                       "reported; the Monte-Carlo axis is embarrassingly parallel (one gather a point)")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--per-rank-batch", type=int, default=8)
    p.add_argument("--imax", type=int, default=50)
    p.add_argument("--ranks", default="1,2,4")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--cpu", action="store_true")
    ns = p.parse_args(argv)
    if not ns.cpu and not torch.cuda.is_available():
        print("scaling: no CUDA device; pass --cpu to run the ranks on the CPU", file=sys.stderr)
        return 1
    res = scaling_benchmark(Imax=ns.imax, per_rank_batch=ns.per_rank_batch, reps=ns.reps, cpu=ns.cpu,
                            rank_counts=[int(n) for n in ns.ranks.split(",")])
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
