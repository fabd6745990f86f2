"""One sharded ADMM step over N ranks, checked against the unsharded
reference (the port's counterpart of ``__graft_entry__.py::dryrun_multichip``).

    python -m jstsp19_torch.parallel.dryrun N [--cpu] [--imax 3] [--timeout 300]

Starts N ranks through ``parallel/launch.py``; they build the
``mesh_shape_for(N)`` (dp, sp, tp) mesh, run ``sharded_admm_step`` on the
small problem of ``parallel/dist_hybrid.py`` (frame 4·sp, 2·dp
realizations), hold every rank's block of S to the unsharded
``reference_admm_batch`` (max|ΔS| ≤ 1e-4·max|S|), and ring-reduce the
batch's mean NMSE over dp (``parallel/ring.py``) against ``all_reduce``.
Rank 0 prints ``dryrun ok: mesh(dp=…,sp=…,tp=…), max|dS|=…``; every rank
prints its backend, device and kernel launches.  The exit code is non-zero
when the error passes the tolerance or any rank fails.  On the card the
ranks take NCCL when each has a card of its own and gloo when they share one
(``parallel/distributed.py``).
"""
from __future__ import annotations

import argparse
import os
import sys

import torch
import torch.distributed as dist


def _worker(args) -> None:
    from jstsp19_torch.parallel import dist_hybrid
    from jstsp19_torch.kernels import launch_counts
    from jstsp19_torch.parallel.distributed import comm_device, finish, initialize_from_env
    from jstsp19_torch.parallel.mesh import make_mesh, mesh_shape_for
    from jstsp19_torch.parallel.ring import ring_allreduce_mean

    device = initialize_from_env(cpu=args.cpu)
    rank, n = dist.get_rank(), dist.get_world_size()
    dp, sp, tp = mesh_shape_for(n)
    mesh = make_mesh(n)
    max_ds, scale, mean_nmse, S, nmse = dist_hybrid.run_layout(mesh, dist_hybrid.host_problem(sp, dp, device),
                                                                args.imax)
    # the ring backend: each dp block's mean NMSE, ring-averaged over dp,
    # against the all-reduced mean
    ring = float(ring_allreduce_mean(nmse.mean().reshape(1).to(comm_device()), mesh.get_group("dp")))
    tol = dist_hybrid.TOLERANCE * scale
    ok = max_ds <= tol and abs(ring - mean_nmse) <= 1e-5 * max(1.0, abs(mean_nmse))
    print(f"[rank {rank}] launches " + ", ".join(f"{k} {v}" for k, v in launch_counts().items()), flush=True)
    if rank == 0:
        print(f"dryrun {'ok' if ok else 'FAILED'}: mesh(dp={dp},sp={sp},tp={tp}), max|dS|={max_ds:.3e} "
              f"(tolerance {tol:.3e} = {dist_hybrid.TOLERANCE:g}*max|S|), S{tuple(S.shape)}, "
              f"mean nmse {mean_nmse:.6f}, ring mean {ring:.6f}, on {device}", flush=True)
    finish(0 if ok else 1)


def main(argv=None) -> int:
    from jstsp19_torch.parallel.distributed import ENV_PID

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--cpu", action="store_true", help="run the ranks on the CPU (gloo)")
    ap.add_argument("--imax", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=300, help="one deadline for all ranks, in seconds")
    args = ap.parse_args(argv)
    if ENV_PID in os.environ:
        _worker(args)  # exits
    if not args.cpu and not torch.cuda.is_available():
        print("dryrun: no CUDA device; pass --cpu to run the ranks on the CPU", file=sys.stderr)
        return 1
    from jstsp19_torch.parallel.launch import launch

    worker_args = [str(args.n), "--imax", str(args.imax)] + (["--cpu"] if args.cpu else [])
    try:
        results = launch(args.n, ["-m", "jstsp19_torch.parallel.dryrun", *worker_args], timeout=args.timeout)
    except (RuntimeError, TimeoutError) as e:
        print(f"dryrun failed: {e}", file=sys.stderr)
        return 1
    for i, r in enumerate(results):
        sys.stdout.write(f"===== rank {i} =====\n{r.stdout}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
