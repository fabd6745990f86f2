"""Time the fused ADMM kernel of this checkout against another checkout's,
in turns, on one GPU.

    python tools/torch_admm_turns.py OTHER_ROOT [--batches 1,132,256]

OTHER_ROOT is a second checkout of the repository (say, the parent commit
unpacked with ``git archive`` into a git-ignored directory).  Each turn is a
fresh process that imports ``jstsp19_torch`` from one root, builds that
root's ``csrc/admm_fused.cu`` into that root's ``kernels/build/``, and times
``fused_tracked_admm`` on the canonical errorVSsnr problem (0 dB, seed 0,
Imax=100) at each batch size: best, median and spread of 5 CUDA-event reps
after a warm-up.  The turns run other, this, this, other, so that drift of
the card's clocks shows as a difference between a root's two turns.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAX = 100


def _worker(root: str, batches) -> int:
    sys.path.insert(0, root)
    import torch

    from jstsp19_torch.bench import NOISE_VAR_0DB, REPS, card_line, cuda_event_times
    from jstsp19_torch.core import prng
    from jstsp19_torch.harness.pipeline import PointConfig, proposed_problem
    from jstsp19_torch.kernels import admm_fused

    assert admm_fused.__file__.startswith(os.path.abspath(root)), admm_fused.__file__
    dev = torch.device("cuda")
    pc = PointConfig(methods=("proposed",), svt_method="fused")
    out = {"root": root, "card": card_line(), "ms": {}}
    for b in batches:
        prob = proposed_problem(prng.realization_generators(0, 0, dev), pc, NOISE_VAR_0DB, b)
        args = [prob[k] for k in ("subY", "Omega", "A", "B", "tau_Y", "tau_S", "rho")]
        t, _ = cuda_event_times(lambda r: admm_fused.fused_tracked_admm(*args, Imax=IMAX), REPS)
        t = sorted(1e3 * x for x in t)
        out["ms"][b] = {"best": t[0], "median": t[len(t) // 2], "spread": t[-1] - t[0]}
    print(json.dumps(out))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other_root")
    ap.add_argument("--batches", default="1,132,256")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ns = ap.parse_args()
    batches = [int(b) for b in ns.batches.split(",")]
    if ns.worker:
        return _worker(ns.other_root, batches)
    other = os.path.abspath(ns.other_root)
    results = []
    for label, root in (("other", other), ("this", THIS_ROOT), ("this", THIS_ROOT), ("other", other)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root, "--batches", ns.batches, "--worker"],
            capture_output=True, text=True, cwd=root, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append((label, res))
        cells = ", ".join(f"B={b}: best {v['best']:.3f} ms, median {v['median']:.3f}, spread {v['spread']:.3f}"
                          for b, v in res["ms"].items())
        print(f"{label:5s} {root}: {cells} ({res['card']})", flush=True)
    for b in batches:
        this = min(r["ms"][str(b)]["best"] for lab, r in results if lab == "this")
        oth = min(r["ms"][str(b)]["best"] for lab, r in results if lab == "other")
        print(f"B={b}: this {this:.3f} ms, other {oth:.3f} ms, ratio other/this {oth / this:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
