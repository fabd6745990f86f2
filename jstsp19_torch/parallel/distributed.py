"""Multi-process backend on ``torch.distributed`` (counterpart of
``jstsp19_tpu/parallel/distributed.py``).

The reference's one real parallelism is a MATLAB process pool: a ``parfor``
over Monte-Carlo realizations (``plot_errorVSsnr_approx.m:41``) and the mean
of their errors.  Here N Python processes (ranks) join one process group;
each solves its share of a sweep point's realizations and the per-realization
errors are gathered to every rank, so every rank holds the whole point and
rank 0 writes the artifacts.

Protocol: the launcher (``parallel/launch.py``) starts N workers with the
``JSTSP19_DIST_*`` variables → each worker calls :func:`initialize_from_env`
before any other work → every worker walks the same sweep
(:func:`distributed_run_point`) → rank 0 writes.

Backend, picked from the layout before ``init_process_group`` (no fallback:
a failed init fails the run):

- each rank has a card of its own (world ≤ ``torch.cuda.device_count()``):
  NCCL, rank r on ``cuda:r``;
- more ranks than cards, as N ranks sharing one H100: gloo; every rank
  computes on the card (rank r on ``cuda:(r mod count)``) and only the small
  gathers and all-reduces go through gloo, on host copies;
- ``cpu=True``: gloo, on the CPU.

A worker standalone under the launcher::

    python -m jstsp19_torch.parallel.launch -n 2 -- \\
        -m jstsp19_torch.parallel.distributed --methods ls,proposed --cpu --out r.json
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the env protocol shared with parallel/launch.py (the JAX package's names)
ENV_COORD = "JSTSP19_DIST_COORD"
ENV_NPROC = "JSTSP19_DIST_NPROC"
ENV_PID = "JSTSP19_DIST_PID"
ENV_PIN = "JSTSP19_DIST_PIN"
ENV_PIN_CORES = "JSTSP19_DIST_PIN_CORES"


def backend_for(world_size: int, cpu: bool) -> str:
    """'nccl' where every rank has a card of its own, 'gloo' where ranks
    share a card or run on the CPU; raises without a card unless ``cpu``."""
    if cpu:
        return "gloo"
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device; pass --cpu to run the ranks on the CPU")
    return "nccl" if world_size <= cards else "gloo"


def initialize(coordinator_address: str, num_processes: int, process_id: int, cpu: bool = False) -> torch.device:
    """Join this process to the group as rank ``process_id`` of
    ``num_processes`` through ``tcp://coordinator_address``; returns the
    device this rank computes on and prints its backend and device.  A CPU
    rank takes 1/N of the cores it may run on for its threads
    (``OMP_NUM_THREADS`` where set)."""
    backend = backend_for(num_processes, cpu)
    if cpu:
        device = torch.device("cpu")
        # the ranks share the host's cores: as many intra-op threads each as
        # leave the others theirs (N ranks of all-core thread pools spin
        # against each other), unless OMP_NUM_THREADS names a count
        threads = int(os.environ.get("OMP_NUM_THREADS") or 0) or len(os.sched_getaffinity(0)) // num_processes
        torch.set_num_threads(max(1, threads))
    else:
        device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                            rank=process_id)
    share = f" (the {num_processes} ranks share the card; gloo carries the collectives)"
    note = "" if cpu or backend == "nccl" else share
    print(f"[rank {process_id}] backend {backend}, device {device}{note}", flush=True)
    return device


def initialize_from_env(cpu: bool = False) -> torch.device:
    """Worker-side entry: read the launcher's env protocol and join; returns
    this rank's device.  With ``JSTSP19_DIST_PIN=1`` the process pins itself
    to an equal, disjoint slice of the host's cores (``JSTSP19_DIST_PIN_CORES``
    cores a rank where set, so a 1-rank baseline gets what each of N ranks
    gets), so a host-scaling measurement partitions the cores."""
    nproc = int(os.environ[ENV_NPROC])
    pid = int(os.environ[ENV_PID])
    if os.environ.get(ENV_PIN) and hasattr(os, "sched_setaffinity"):
        cores = sorted(os.sched_getaffinity(0))
        per = int(os.environ.get(ENV_PIN_CORES, "0")) or len(cores) // nproc
        if per >= 1 and pid * per < len(cores):
            os.sched_setaffinity(0, set(cores[pid * per:(pid + 1) * per]))
    return initialize(os.environ[ENV_COORD], nproc, pid, cpu=cpu)


def finish(code: int = 0) -> None:
    """End a rank: leave the group, flush the output and exit with ``code``
    without the interpreter's teardown, in which gloo's threads at times
    abort a finished rank ('terminate called without an active exception',
    SIGABRT, about one run in twenty on a CPU host)."""
    dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def comm_device() -> torch.device:
    """Where the group's collectives take their tensors: this rank's card
    under NCCL, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_mc_mesh():
    """A one-axis ``mc`` ``DeviceMesh`` over every rank (the distributed form
    of the runner's Monte-Carlo axis)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(comm_device().type, torch.arange(dist.get_world_size()), mesh_dim_names=("mc",))


def distributed_run_point(
    pc,
    noise_var: float,
    n_mc: int,
    seed: int = 0,
    sweep_index: int = 0,
    device=None,
    taps: Optional[torch.Tensor] = None,
    mesh=None,
) -> Dict[str, np.ndarray]:
    """The multi-process twin of ``harness.runner.run_point``: rank r of N
    draws the whole point's inputs from the same (seed, sweep_index)
    generators, solves realizations r·n_mc/N .. (r+1)·n_mc/N − 1 (the fused
    route too), and the per-realization errors are gathered to every rank.
    Per realization the result is ``run_point``'s at the same seed, whatever
    N.  Every rank must call it (collective); each returns the whole point.
    """
    from jstsp19_torch.harness.runner import run_point

    group = (mesh or global_mc_mesh()).get_group()
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_mc % world:
        raise ValueError(f"n_mc={n_mc} must divide over {world} ranks")
    share = n_mc // world
    local = run_point(pc, noise_var, n_mc, seed=seed, sweep_index=sweep_index, device=device, taps=taps,
                      rows=slice(rank * share, (rank + 1) * share))
    methods = list(local)
    mine = torch.stack([torch.as_tensor(local[m]) for m in methods]).to(comm_device())
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine, group=group)
    whole = torch.cat(parts, dim=1).cpu().numpy()
    return {m: whole[i].astype(local[m].dtype) for i, m in enumerate(methods)}


def distributed_run_sweep(
    name: str,
    sweep_name: str,
    sweep_values: Sequence[float],
    point_fn,
    noise_fn,
    n_mc: int,
    seed: int = 0,
    device=None,
    mesh=None,
) -> Dict:
    """Collective sweep: every rank walks the same points; the curves and
    the per-realization errors come out the same on every rank (rank 0
    writes them)."""
    mesh = mesh or global_mc_mesh()
    t0 = time.time()
    curves: Dict[str, list] = {}
    raw: Dict[str, list] = {}
    seconds = []
    for i, val in enumerate(sweep_values):
        t_point = time.time()
        out = distributed_run_point(point_fn(val), noise_fn(val), n_mc, seed=seed, sweep_index=i, device=device,
                                    mesh=mesh)  # numpy arrays: the point's work has ended
        seconds.append(time.time() - t_point)
        for m, errs in out.items():
            curves.setdefault(m, []).append(float(np.mean(errs)))
            raw.setdefault(m, []).append(errs.tolist())
    return {
        "experiment": name,
        "sweep": {sweep_name: [float(v) for v in sweep_values]},
        "n_mc": n_mc,
        "curves": curves,
        "raw": raw,
        "seconds": time.time() - t0,
        "point_seconds": seconds,
        "num_processes": dist.get_world_size(),
        "backend": dist.get_backend(),
    }


def _worker_main(argv=None) -> None:
    """Standalone worker: join through the env protocol, run a small sweep
    of the canonical point over noise variances, print this rank's launch
    counts; rank 0 writes the JSON (with ``--reps`` > 1, the best repeat's
    time and the throughput, as ``parallel/scaling.py`` reads them)."""
    import argparse

    from jstsp19_torch.harness.pipeline import PointConfig

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--methods", default="ls,proposed")
    ap.add_argument("--imax", type=int, default=20)
    ap.add_argument("--svt-method", default="tracked", choices=("eigh", "tracked", "fused"))
    ap.add_argument("--n-mc", type=int, default=8)
    ap.add_argument("--noise-vars", default="0.1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=1, help="timed repeats of the sweep after the first")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    device = initialize_from_env(cpu=args.cpu)
    rank = dist.get_rank()
    mesh = global_mc_mesh()
    pc = PointConfig(methods=tuple(args.methods.split(",")), Imax=args.imax, svt_method=args.svt_method)
    nvs = [float(v) for v in args.noise_vars.split(",")]

    def sweep():
        return distributed_run_sweep("dist_worker", "noise_var", nvs, lambda _v: pc, lambda v: v, n_mc=args.n_mc,
                                     seed=args.seed, device=device, mesh=mesh)

    res = sweep()
    best = res["seconds"]  # one pass: its time includes the first call's set-up
    for _ in range(args.reps - 1):
        t0 = time.time()
        sweep()
        best = min(best, time.time() - t0)
    res["best_seconds"] = best
    res["throughput_est_per_s"] = args.n_mc * len(nvs) / best
    if rank == 0 and args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    from jstsp19_torch.kernels import launch_counts

    counts = ", ".join(f"{k} {v}" for k, v in launch_counts().items())
    print(f"[dist worker {rank}] done on {device}: {res['curves']}; launches {counts}", flush=True)
    finish()


if __name__ == "__main__":
    _worker_main()
