"""The sharded ADMM step over meshes whose axes span processes (counterpart
of ``jstsp19_tpu/parallel/dist_hybrid.py``).

With one rank a device, the JAX package's (hosts × chips) meshes become the
rank order of a ``DeviceMesh``; the (dp, sp, tp) step of
``parallel/sharded_admm.py`` runs in its two layouts:

* dp across processes, mesh (N, 1, 1): the solver's collectives stay inside
  a rank and only the final reduction crosses processes (the production
  layout);
* sp across processes, mesh (1, N, 1): every iteration's Gram and
  correlation all-reduce crosses processes (the stress layout).

Each rank checks its block of S against the unsharded reference
(``sharded_admm.reference_admm_batch``) on the same small deterministic
problem.  Run under the launcher::

    python -m jstsp19_torch.parallel.launch -n 2 -- \\
        -m jstsp19_torch.parallel.dist_hybrid --cpu --out hybrid.json
"""
from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

# Nt, Nr (= Gr), Mr_e, Mr, L of the small problem (the JAX package's dryrun shapes)
NT, NR, MR_E, MR, L = 2, 8, 8, 2, 2
TOLERANCE = 1e-4  # max|ΔS| against the reference, relative to max|S|


def host_problem(sp: int, dp: int, device):
    """(subY, Omega, A, B, tau_Y, tau_S, rho, Zbar): one channel, frame T =
    4·sp, 2·dp realizations of noise (variance 0.1) and mask, drawn from
    generators seeded 7, 8 and 9 on ``device``: the same on every rank of a
    device type."""
    from jstsp19_torch.channel import wideband_mmwave_channel
    from jstsp19_torch.frontend import awgn, create_beamformer, proposed_hbf, qam4_training_frames
    from jstsp19_torch.solvers.admm import admm_hyperparams

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    T, n_batch = 4 * sp, 2 * dp
    ch = wideband_mmwave_channel(gen(7), L, NR, NT, 1, 2, NR, NT)
    Psi = qam4_training_frames(gen(8), NT, T, L)
    W = create_beamformer(NR, "ZC", device=device)
    A = W[:, :MR_E].mH @ ch.Dr
    B = torch.einsum("gn,lnt->lgt", ch.Dt.conj(), Psi).reshape(L * NT, T)
    noise = gen(9)
    N = awgn(noise, NR, T, 0.1, batch=(n_batch,))
    obs = proposed_hbf(noise, ch.H, N, Psi, MR_E, MR, W)
    tau_Y, tau_S, rho = admm_hyperparams(obs.Y, ch.Zbar, top_k=2)
    Zbar = ch.Zbar.expand(n_batch, *ch.Zbar.shape).contiguous()
    return obs.Y, obs.Omega, A, B.contiguous(), tau_Y, tau_S.expand(n_batch).contiguous(), rho, Zbar


def run_layout(mesh, problem, Imax: int = 3):
    """The sharded step over ``mesh`` on ``problem`` (the whole problem on
    every rank); returns (max|ΔS| of every rank's block against the
    reference, max|S| of the reference, the mean NMSE over the batch, the
    whole sharded S, this rank's (b,) NMSE).  Every rank must call it."""
    from jstsp19_torch.parallel.distributed import comm_device
    from jstsp19_torch.parallel.sharded_admm import (
        gather_blocks,
        local_blocks,
        reference_admm_batch,
        sharded_admm_step,
    )

    blocks = local_blocks(mesh, *problem)
    S, nmse = sharded_admm_step(mesh, Imax=Imax)(*blocks)
    subY, Omega, A, B, tau_Y, tau_S, rho, _ = problem
    S_ref = reference_admm_batch(subY, Omega, A, B, Imax, tau_Y, tau_S, rho)
    ref_blocks = local_blocks(mesh, subY, Omega, A, B, tau_Y, tau_S, rho, S_ref)[-1]
    stats = torch.tensor([float((S - ref_blocks).abs().max()), float(nmse.sum())], dtype=torch.float64,
                         device=comm_device())
    dist.all_reduce(stats[:1], op=dist.ReduceOp.MAX)
    # the dp blocks' errors summed over dp: the final reduction of the
    # production layout (each dp group holds every realization once)
    dist.all_reduce(stats[1:], group=mesh.get_group("dp"))
    return (float(stats[0]), float(S_ref.abs().max()), float(stats[1]) / subY.shape[0], gather_blocks(mesh, S),
            nmse)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--imax", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from jstsp19_torch.kernels import launch_counts
    from jstsp19_torch.parallel.distributed import finish, initialize_from_env
    from jstsp19_torch.parallel.mesh import mesh_of_shape

    device = initialize_from_env(cpu=args.cpu)
    rank, n = dist.get_rank(), dist.get_world_size()
    results = {}
    for name, shape, (sp, dp) in (("dp_across_processes", (n, 1, 1), (1, n)),
                                  ("sp_across_processes", (1, n, 1), (n, 1))):
        max_ds, scale, mean_nmse, _, _ = run_layout(mesh_of_shape(shape), host_problem(sp, dp, device), args.imax)
        results[name] = dict(mesh=list(shape), max_abs_dS=max_ds, max_abs_S=scale, mean_nmse=mean_nmse,
                             ok=max_ds <= TOLERANCE * scale)
    results["ok"] = all(r["ok"] for r in results.values())
    print(f"[hybrid {rank}] {results}; launches {launch_counts()}", flush=True)
    if rank == 0 and args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    finish(0 if results["ok"] else 1)


if __name__ == "__main__":
    main()
