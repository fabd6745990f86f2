"""Command-line entry of the port: run experiment recipes.

Usage:
  python -m jstsp19_torch list
  python -m jstsp19_torch run error_vs_nrf --n-mc 256 --no-plot --out results_torch
  python -m jstsp19_torch run all --n-mc 16
  python -m jstsp19_torch run error_vs_nrf --cpu --n-mc 8     # the CPU, plain versions
  python -m jstsp19_torch run error_vs_snr_nyuwireless --mat-path nywireless_channel.mat
  python -m jstsp19_torch run error_vs_snr --methods omp_td,svt,tssr --n-mc 256 --no-plot
  python -m jstsp19_torch run time_comparisons --n-mc 8 --no-plot
  python -m jstsp19_torch run error_vs_nrf --n-mc 256 --checkpoint-dir ck --checkpoint-backend orbax
  python -m jstsp19_torch run error_vs_nrf --n-mc 256 --no-plot --distributed 2 [--dist-timeout 900]
  python -m jstsp19_torch panel [--batch] [--set field=value ...] [--n-mc 16] [--snr-db 0] [--out hist.png]
  python -m jstsp19_torch demo                       # list the worked examples
  python -m jstsp19_torch demo sparse_recovery [--cpu]
  python -m jstsp19_torch demo large_array_sharded [--cpu] [--ranks 2]

Without ``--cpu`` a run or a demo needs a CUDA device and exits 1 when there
is none.

``run --distributed N`` starts N ranks of this same command on this host
(``parallel/launch.py``, one deadline for all, ``--dist-timeout``): each rank
solves its share of every sweep point's realizations, the per-realization
errors are gathered to every rank, and rank 0 writes the artifacts; the
result is the single-process run's, realization by realization.  On the card
the ranks take NCCL when each has a card of its own and gloo when they share
one; with ``--cpu``, gloo on the CPU (``parallel/distributed.py``).  A
recipe that does not go through ``run_point`` (the specialized figures) runs
whole on every rank, as in the JAX package.  The JAX
CLI's ``--devices-per-process`` has no counterpart: one rank drives one
device.

``demo`` lists the worked examples (``jstsp19_torch/examples/``, one module
for each of the JAX package's ``examples/*.py`` scripts) with their first
docstring lines, and ``demo <name>`` runs one, printing the script's lines.
The JAX CLI's ``demo`` runs on the CPU unless given ``--tpu``; here, as for
every entry point of the port, the card is the default and ``--cpu`` asks
for the CPU.  ``--ranks N`` shares ``large_array_sharded``'s realizations
over N ranks on this host.
"""
from __future__ import annotations

import argparse
import inspect
import os
import sys

# the launcher's flags, which a rank must not see again
_LAUNCHER_FLAGS = ("--distributed", "--dist-timeout")


def strip_launcher_flags(argv):
    """``argv`` without the launcher's flags, in both the ``--flag N`` and
    the ``--flag=N`` forms."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in _LAUNCHER_FLAGS:
            skip = True
        elif not a.startswith(tuple(f + "=" for f in _LAUNCHER_FLAGS)):
            out.append(a)
    return out


def _device(cpu: bool):
    """The device a command runs on, or None (and a message) without a card."""
    import torch

    if cpu:
        return torch.device("cpu")
    if torch.cuda.is_available():
        return torch.device("cuda")
    print("no CUDA device; pass --cpu to run on the CPU", file=sys.stderr)
    return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="jstsp19_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list experiment recipes")
    demop = sub.add_parser("demo", help="list the worked examples, or run one (on the card unless --cpu)")
    demop.add_argument("name", nargs="?", default=None)
    demop.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    demop.add_argument("--ranks", type=int, default=None, help="large_array_sharded: share it over N ranks")
    panelp = sub.add_parser(
        "panel",
        help="parameter panel: edit a sweep point's fields, run a Monte-Carlo batch and print the NMSE",
    )
    panelp.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    panelp.add_argument("--set", action="append", default=[], metavar="FIELD=VALUE",
                        help="set a field without a prompt (repeatable)")
    panelp.add_argument("--batch", action="store_true", help="no prompts: the defaults and --set only")
    panelp.add_argument("--n-mc", type=int, default=16)
    panelp.add_argument("--snr-db", type=float, default=0.0)
    panelp.add_argument("--out", default=None, help="PNG path of a histogram of log10 NMSE")
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
    runp.add_argument(
        "--checkpoint-backend", default="json", choices=("json", "orbax"),
        help="json = per-point means; orbax = per-realization arrays (stored as .npz)",
    )
    runp.add_argument("--mat-path", default=None, help="NYU-Wireless channel .mat for error_vs_snr_nyuwireless")
    runp.add_argument(
        "--methods", default=None,
        help="comma-separated estimator subset for recipes that accept it, from ls, vamp, omp_mmv, "
             "omp_td, svt, tssr, proposed, proposed_angles (e.g. omp_td,svt,tssr)",
    )
    runp.add_argument(
        "--distributed", type=int, default=0, metavar="N",
        help="run over N ranks on this host; each point's realizations are shared out and rank 0 writes",
    )
    runp.add_argument("--dist-timeout", type=float, default=None, metavar="SECONDS",
                      help="one deadline for all ranks of --distributed (default: none)")
    args = parser.parse_args(argv)

    from jstsp19_torch.harness import EXPERIMENTS

    if args.cmd == "list":
        for name, fn in sorted(EXPERIMENTS.items()):
            doc = (fn.__doc__ or "").strip().splitlines()[0]
            print(f"{name:28s} {doc}")
        return 0
    if args.cmd == "demo":
        return _demo(args)
    if args.cmd == "panel":
        return _panel(args)

    from jstsp19_torch.parallel.distributed import ENV_PID

    worker = ENV_PID in os.environ
    if worker and args.distributed:
        print("a rank was handed --distributed: the launcher's flags must not reach the ranks", file=sys.stderr)
        return 2
    if args.distributed and not worker:
        return _launch(args, list(sys.argv[1:] if argv is None else argv))

    names = sorted(EXPERIMENTS) if args.experiment == "all" else [args.experiment]
    for name in names:
        if name not in EXPERIMENTS:
            print(f"unknown experiment {name!r}; try `list`", file=sys.stderr)
            return 1
    if worker:
        from jstsp19_torch.harness import runner
        from jstsp19_torch.parallel import distributed

        device = distributed.initialize_from_env(cpu=args.cpu)
        runner.set_distributed_mesh(distributed.global_mc_mesh())
    else:
        device = _device(args.cpu)
        if device is None:
            return 1
    rc = _run(args, names, device)
    if worker:
        import torch.distributed as dist

        from jstsp19_torch.kernels import launch_counts

        counts = ", ".join(f"{k} {v}" for k, v in launch_counts().items())
        print(f"[rank {dist.get_rank()}] backend {dist.get_backend()}, device {device}; launches {counts}", flush=True)
        distributed.finish(rc)
    return rc


def _demo(args) -> int:
    """``demo``: list the examples, or run one's ``main``."""
    import importlib

    from jstsp19_torch.examples import NAMES

    if args.name is None:
        print("worked demos (run: python -m jstsp19_torch demo <name> [--cpu]):")
        for name in NAMES:
            doc = importlib.import_module(f"jstsp19_torch.examples.{name}").__doc__
            print(f"  {name:26s} {doc.strip().splitlines()[0].rstrip('.')}")
        return 0
    if args.name not in NAMES:
        print(f"unknown demo {args.name!r}; run `demo` to list", file=sys.stderr)
        return 1
    if args.ranks and args.name != "large_array_sharded":
        print("--ranks applies to large_array_sharded only", file=sys.stderr)
        return 1
    # the example's main takes the device: the card, or without one exit 1 unless --cpu
    argv = (["--cpu"] if args.cpu else []) + (["--ranks", str(args.ranks)] if args.ranks else [])
    return importlib.import_module(f"jstsp19_torch.examples.{args.name}").main(argv)


def _run(args, names, device) -> int:
    from jstsp19_torch.harness import EXPERIMENTS
    from jstsp19_torch.harness.artifacts import save_result
    from jstsp19_torch.harness.runner import primary_process, set_default_checkpoint

    set_default_checkpoint(args.checkpoint_dir, args.checkpoint_backend)
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
        if primary_process():
            path = save_result(res, args.out, plot=not args.no_plot)
            print(f"[{name}] wrote {path} ({res.seconds:.1f}s)")
    return 0


def _launch(args, raw) -> int:
    """The launcher side of ``run --distributed N``: N ranks of this command
    without the launcher's flags; every rank's output is printed."""
    from jstsp19_torch.parallel.launch import launch

    n = args.distributed
    if args.n_mc % n:
        print(f"--n-mc {args.n_mc} must be divisible by the {n} ranks; try --n-mc {-(-args.n_mc // n) * n}",
              file=sys.stderr)
        return 1
    if _device(args.cpu) is None:
        return 1
    try:
        results = launch(n, ["-m", "jstsp19_torch", *strip_launcher_flags(raw)], timeout=args.dist_timeout)
    except (RuntimeError, TimeoutError) as e:
        print(f"--distributed {n}: {e}", file=sys.stderr)
        return 1
    for i, r in enumerate(results):
        sys.stdout.write(f"===== rank {i} =====\n{r.stdout}")
    return 0


def _panel(args) -> int:
    """The parameter panel (the reference ``GUI/``'s forms): prompt for each
    ``PointConfig`` field with its default (enter keeps it), ``--set
    field=value`` fills a field, ``--batch`` asks for nothing; then run
    ``--n-mc`` realizations at ``--snr-db`` and print each method's mean
    NMSE and its 5% and 95% quantiles, and with ``--out`` write a histogram
    of log10 NMSE."""
    import dataclasses

    import numpy as np

    from jstsp19_torch.harness.pipeline import PointConfig
    from jstsp19_torch.harness.runner import run_point

    device = _device(args.cpu)
    if device is None:
        return 1
    overrides = {}
    for kv in args.set:
        k, _, v = kv.partition("=")
        overrides[k.strip()] = v.strip()
    fields = {f.name: f for f in dataclasses.fields(PointConfig)}
    unknown = set(overrides) - set(fields)
    if unknown:
        print(f"unknown PointConfig field(s) {sorted(unknown)}; the fields: {', '.join(fields)}", file=sys.stderr)
        return 1
    values = {}
    print("sweep-point configuration (enter to keep the default):")
    for name, f in fields.items():
        if name in overrides:
            raw = overrides[name]
        elif args.batch:
            raw = ""
        else:
            try:
                raw = input(f"  {name} [{f.default!r}]: ").strip()
            except EOFError:
                raw = ""
        if not raw:
            continue
        if name == "methods":
            values[name] = tuple(m.strip() for m in raw.split(",") if m.strip())
        elif isinstance(f.default, bool):
            values[name] = raw.lower() in ("1", "true", "yes", "y")
        elif isinstance(f.default, int):
            values[name] = int(raw)
        elif isinstance(f.default, float):
            values[name] = float(raw)
        else:
            values[name] = raw
    pc = PointConfig(**values)
    nv = float(10 ** (-args.snr_db / 10))
    print(f"running n_mc={args.n_mc} @ {args.snr_db:+.1f} dB on {device}: {pc}")
    out = run_point(pc, nv, args.n_mc, device=device)
    for m in sorted(out):
        e = np.asarray(out[m])
        q5, q95 = np.quantile(e, 0.05), np.quantile(e, 0.95)
        print(f"  {m:16s} mean NMSE {float(e.mean())!r}   [q5 {q5:.3g}, q95 {q95:.3g}]")
    if args.out:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        for m in sorted(out):
            ax.hist(np.log10(np.maximum(np.asarray(out[m]), 1e-12)), bins=24, alpha=0.5, label=m)
        ax.set_xlabel("log10 NMSE")
        ax.set_ylabel("realizations")
        ax.legend()
        fig.tight_layout()
        fig.savefig(args.out, dpi=120)
        plt.close(fig)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. `... list | head`
        sys.exit(0)
