"""The front end's CUDA graphs over one benchmark cell: captures, replays, and the front end's time both ways.

    python tools/torch_frontend_graph.py --workload snr_fused_b256 --seed 2000000001 [--points 44] [--reps 20]

Warms the cell up as a benchmark run does (``perfbench/bench.py::run_cell``),
runs ``--points`` points of its window, and then, for each distinct shape of
the sweep, times the front end between two synchronisations on the host's
clock in turns: ``pipeline.proposed_problem`` (the graph's replay, and ρ
after it) and ``pipeline._problem`` (the same code run eagerly) and ρ after
it, ``--reps`` times each.  Prints one JSON line: the captures made in set-up and in the
window, the replays a window point, and per shape the median milliseconds of
either side.  Needs the card (exits 2 without one).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from jstsp19_torch.core import prng  # noqa: E402
from jstsp19_torch.harness import frontend_graph, pipeline  # noqa: E402
from jstsp19_torch.solvers.admm import admm_rho  # noqa: E402
from perfbench import cells  # noqa: E402
from perfbench.run import card_line  # noqa: E402
from perfbench.system import Port  # noqa: E402
from perfbench.traffic import Schedule  # noqa: E402


def _counts():
    return frontend_graph.problem.captures, frontend_graph.problem.replays


def _eager(gens, pc, noise_var, batch):
    prob = pipeline._problem(gens, pc, noise_var, batch)
    return admm_rho(prob["G"], prob["tau_Y"]) * pc.rho_scale


def _ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--points", type=int, default=44)
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_frontend_graph: no CUDA device; the tool measures the card only", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    system = Port("cuda", args.seed)
    schedule = Schedule(cell.config, cell.traffic)
    warmups = schedule.warmups()
    for pt in warmups:
        system.run_point(pt)
    setup = _counts()
    window = schedule.window()
    for _ in range(args.points):
        system.run_point(next(window))
    after = _counts()

    shapes = {}
    for pt in warmups:
        shapes.setdefault(pt.fields, pt)
    timings = []
    for n, pt in enumerate(shapes.values()):
        pc = system.config(pt)
        sides = {"graph": [], "eager": []}
        for i in range(args.reps):
            for side in ("graph", "eager", "eager", "graph") if i % 2 else ("eager", "graph", "graph", "eager"):
                gens = prng.realization_generators(args.seed, (1 << 41) + 4 * (n * args.reps + i), "cuda")
                fn = pipeline.proposed_problem if side == "graph" else _eager
                sides[side].append(_ms(lambda: fn(gens, pc, pt.noise_var, pt.n_mc)))
        timings.append(dict(fields={k: v for k, v in pt.fields if k in ("Nt", "T")}, n_mc=pt.n_mc,
                            graph_ms=statistics.median(sides["graph"]), eager_ms=statistics.median(sides["eager"])))
    print(json.dumps(dict(
        workload=cell.name, seed=args.seed, card=card_line(), shapes=len(shapes), warmup_points=len(warmups),
        captures_in_setup=setup[0], replays_in_setup=setup[1], window_points=args.points,
        captures_in_window=after[0] - setup[0], replays_a_window_point=(after[1] - setup[1]) / args.points,
        frontend=timings)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
