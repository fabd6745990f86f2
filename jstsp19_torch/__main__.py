"""Command-line entry of the port: run experiment recipes.

Usage:
  python -m jstsp19_torch list
  python -m jstsp19_torch run error_vs_nrf --n-mc 256 --no-plot --out results_torch
  python -m jstsp19_torch run all --n-mc 16
  python -m jstsp19_torch run error_vs_nrf --cpu --n-mc 8     # the CPU, plain versions
  python -m jstsp19_torch run error_vs_snr_nyuwireless --mat-path nywireless_channel.mat
  python -m jstsp19_torch run error_vs_snr --methods omp_td,svt,tssr --n-mc 256 --no-plot
  python -m jstsp19_torch run time_comparisons --n-mc 8 --no-plot

Without ``--cpu`` a run needs a CUDA device and exits 1 when there is none.
The JAX CLI's ``demo``, ``panel`` and ``--distributed`` are not ported yet
(ROADMAP.md Queue 1, item 5).
"""
from __future__ import annotations

import argparse
import inspect
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="jstsp19_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list experiment recipes")
    runp = sub.add_parser("run", help="run an experiment recipe")
    runp.add_argument("experiment")
    runp.add_argument("--n-mc", type=int, default=8)
    runp.add_argument("--seed", type=int, default=0)
    # not results/: that directory holds the JAX package's reference runs
    runp.add_argument("--out", default="results_torch")
    runp.add_argument("--no-plot", action="store_true")
    runp.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    runp.add_argument(
        "--checkpoint-dir", default=None,
        help="journal per-point results here and resume completed points",
    )
    runp.add_argument("--mat-path", default=None, help="NYU-Wireless channel .mat for error_vs_snr_nyuwireless")
    runp.add_argument(
        "--methods", default=None,
        help="comma-separated estimator subset for recipes that accept it, from ls, vamp, omp_mmv, "
             "omp_td, svt, tssr, proposed, proposed_angles (e.g. omp_td,svt,tssr)",
    )
    args = parser.parse_args(argv)

    from jstsp19_torch.harness import EXPERIMENTS

    if args.cmd == "list":
        for name, fn in sorted(EXPERIMENTS.items()):
            doc = (fn.__doc__ or "").strip().splitlines()[0]
            print(f"{name:28s} {doc}")
        return 0

    import torch

    from jstsp19_torch.harness.artifacts import save_result
    from jstsp19_torch.harness.runner import set_default_checkpoint

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        print("no CUDA device; pass --cpu to run on the CPU", file=sys.stderr)
        return 1
    names = sorted(EXPERIMENTS) if args.experiment == "all" else [args.experiment]
    for name in names:
        if name not in EXPERIMENTS:
            print(f"unknown experiment {name!r}; try `list`", file=sys.stderr)
            return 1
    set_default_checkpoint(args.checkpoint_dir)
    for name in names:
        kwargs = {"n_mc": args.n_mc, "seed": args.seed, "device": device}
        if args.mat_path and name == "error_vs_snr_nyuwireless":
            kwargs["mat_path"] = args.mat_path
        if args.methods:
            if "methods" in inspect.signature(EXPERIMENTS[name]).parameters:
                kwargs["methods"] = tuple(m.strip() for m in args.methods.split(",") if m.strip())
            else:
                print(f"[{name}] --methods not supported by this recipe; ignored", file=sys.stderr)
        res = EXPERIMENTS[name](**kwargs)
        path = save_result(res, args.out, plot=not args.no_plot)
        print(f"[{name}] wrote {path} ({res.seconds:.1f}s)")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. `... list | head`
        sys.exit(0)
