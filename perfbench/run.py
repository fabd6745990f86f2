"""Run one cell of the benchmark once on the card and print its result line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  It exits non-zero and prints no result where
the card is missing (there is no CPU fallback), where a module of JAX or of
the JAX package has been loaded by the time the window closed, or where the
program is not in the checkout.  The last lines on standard error, and the
result line's last key, ``checks``, give each number the correctness check
compared, beside its limit.
"""
import time

T0 = time.time()  # the process's start, as near as Python sees it

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / ".perfbench_cache"  # the kernel caches, at fixed places inside the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "jstsp19_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, its libraries' or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not available ({e})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed takes a whole number >= 0")

    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    import torch

    from perfbench import bench, cells
    from perfbench.system import Port

    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}. The benchmark measures the card "
              "only.", file=sys.stderr)
        return 2
    print(f"[perfbench] {cell.name}: config {cell.config_name}, traffic {cell.traffic_name}, seed {args.seed}, "
          f"{args.seconds} s, trace {args.trace}; card: {card_line()}", file=sys.stderr)
    result = bench.run_cell(cell, Port("cuda", args.seed), args.seed, args.seconds, bool(args.trace), T0)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; the benchmark runs the port without JAX",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
