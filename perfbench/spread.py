"""Sets of runs of one cell, each a process of its own, and the spread of each metric.

    python3 -m perfbench.spread --workload <name> --seeds <a,b,...> [--seconds S] [--out FILE]

Runs ``python3 -m perfbench.run`` once per seed, in two sets with the same
seeds, one run at a time, and prints for each metric and set its median and
its spread: the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median.  A first
run before the sets builds what a fresh checkout builds and is reported
apart.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

from perfbench import cells

TIMEOUT_S = 1200
SETS = 2


def one(workload: str, seed: int, seconds: float) -> dict:
    cmd = [sys.executable, "-m", "perfbench.run", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", "0"]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    card = next((line for line in proc.stderr.splitlines() if line.startswith("[perfbench]")), "")
    return {"seed": seed, "rc": proc.returncode, "wall_s": time.time() - t0, "result": result, "card": card,
            "stderr_tail": proc.stderr[-2000:] if proc.returncode else ""}


def spread(values) -> dict:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return {"median": med, "spread": (q3 - q1) / med if med else float("nan"), "min": min(values),
            "max": max(values)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float)
    p.add_argument("--out")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    seconds = args.seconds
    if seconds is None:
        with open(cells.ROOT / "BENCHMARK.json") as f:
            seconds = json.load(f)["run_seconds"]
    # the first run takes a seed of its own
    out = {"workload": args.workload, "seconds": seconds, "first": one(args.workload, max(seeds) + 1, seconds),
           "sets": []}
    print(f"[spread] first run: {json.dumps(out['first'])}", flush=True)
    for s in range(SETS):
        runs = []
        for seed in seeds:
            r = one(args.workload, seed, seconds)
            runs.append(r)
            print(f"[spread] set {s + 1} seed {seed}: rc {r['rc']} {r['wall_s']:.1f} s "
                  f"{json.dumps(r['result']) if r['result'] else r['stderr_tail']}", flush=True)
        good = [r["result"] for r in runs if r["result"]]
        stats = {}
        for name in sorted({k for g in good for k in g["metrics"]}):
            values = [g["metrics"][name]["value"] for g in good if name in g["metrics"]]
            if len(values) >= 2:
                stats[name] = spread(values)
        out["sets"].append({"runs": runs, "stats": stats,
                            "correct": [g["correct"] for g in good], "failed_runs": len(runs) - len(good)})
        print(f"[spread] set {s + 1}: {json.dumps(stats)}; correct {[g['correct'] for g in good]}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
