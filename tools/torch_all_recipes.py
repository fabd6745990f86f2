"""Runs the port's sweep recipes (those whose committed JAX run in
``results/`` keeps its per-realization ``raw`` errors) through its CLI and
holds each to that run.

For every recipe, ``python -m jstsp19_torch run <recipe> --n-mc N --no-plot
--out DIR`` in-process, then, for every method at every sweep point, the
z-score of the port's mean against the mean of ``results/<recipe>.json``'s
``raw`` errors under their combined standard error.  Prints the wall time
and the z-scores of each recipe and the largest |z|.

Usage: ``python tools/torch_all_recipes.py N OUT_DIR [--cpu]`` (without
``--cpu`` it needs a CUDA device, as the CLI does).
"""
from __future__ import annotations

import json
import math
import os
import pathlib
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO) if REPO not in sys.path else None

from jstsp19_torch import __main__ as cli  # noqa: E402
from jstsp19_torch.harness.experiments import EXPERIMENTS  # noqa: E402


def _mean_var(x):
    m = sum(x) / len(x)
    return m, sum((v - m) ** 2 for v in x) / (len(x) - 1)


def main(argv) -> int:
    n_mc, out, extra = argv[0], argv[1], argv[2:]
    worst = 0.0
    # the sweep recipes: those whose committed JAX run keeps its per-realization errors
    sweeps = [n for n in sorted(EXPERIMENTS) if (pathlib.Path(REPO) / "results" / f"{n}.json").exists()
              and "raw" in json.loads((pathlib.Path(REPO) / "results" / f"{n}.json").read_text())]
    for name in sweeps:
        t0 = time.time()
        rc = cli.main(["run", name, "--n-mc", n_mc, "--no-plot", "--out", out, *extra])
        if rc != 0:
            return rc
        got = json.loads((pathlib.Path(out) / f"{name}.json").read_text())
        ref = json.loads((pathlib.Path(REPO) / "results" / f"{name}.json").read_text())
        zs = {}
        for m in ref["raw"]:
            z = []
            for g, r in zip(got["raw"][m], ref["raw"][m]):
                (mg, vg), (mr, vr) = _mean_var(g), _mean_var(r)
                se = math.sqrt(vg / len(g) + vr / len(r))
                z.append((mg - mr) / se if se > 0 else 0.0)
            zs[m] = [round(v, 2) for v in z]
            worst = max(worst, max(abs(v) for v in z))
        print(f"== {name}: {time.time() - t0:.1f} s; z vs JAX (n_mc {ref['n_mc']}): {zs}", flush=True)
    print(f"max |z| over all recipes: {worst:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
