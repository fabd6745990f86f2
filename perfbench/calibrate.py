"""The readings that a cell's correctness limits are set from, in one process.

    python3 -m perfbench.calibrate --workload <name> --seeds <a,b,...> --control-seeds <c,d,...> [--out FILE]

For each seed, the program (or, for a control seed, the reference with TF32
products in its place) runs two passes of the cell's sweep at the cell's
size through the window's own call, and the check compares a sample of them
as a run does.  It prints each compared number per seed, the program's
largest (the lower reading) and the control's smallest (the upper), and with
``--out`` writes them as JSON: the numbers of ``check.numbers`` for the
cell's methods, the conventional branch's among them where the traffic
holds a baseline.  Runs on the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from perfbench import cells, check
from perfbench.system import Control, Port
from perfbench.traffic import Schedule

PASSES = 2


def readings(cell: cells.Cell, system_cls, seed: int) -> dict:
    system = system_cls("cuda", seed)
    schedule = Schedule(cell.config, cell.traffic)
    check.follows(system, schedule.warmups(), schedule.svt_method)
    points = schedule.window()
    done = [(pt, system.run_point(pt)) for pt, _ in zip(points, range(PASSES * schedule.size))]
    _, checks = check.run(system, done, seed, cell.limits)
    return {key: c["value"] for key, c in checks.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    out = {"workload": cell.name, "device": torch.cuda.get_device_name(0),
           "program": {}, "control": {}}
    runs = [("program", Port, s) for s in args.seeds.split(",") if s]
    runs += [("control", Control, s) for s in args.control_seeds.split(",") if s]
    # the kernel library and the card's first calls, before any seed is read
    readings(cell, Port, 0)
    for side, system_cls, s in runs:
        t0 = time.time()
        out[side][s] = readings(cell, system_cls, int(s))
        print(f"[calibrate] {cell.name} {side} seed {s}: "
              + ", ".join(f"{k} {v!r}" for k, v in out[side][s].items()) + f" ({time.time() - t0:.1f} s)", flush=True)
    for side, pick in (("program", max), ("control", min)):
        if out[side]:
            keys = next(iter(out[side].values()))
            out[side + "_" + pick.__name__] = {k: pick(r[k] for r in out[side].values()) for k in keys}
            print(f"[calibrate] {side} {pick.__name__}: {out[side + '_' + pick.__name__]}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
