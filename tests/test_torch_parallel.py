"""The port's multi-process backend (``jstsp19_torch/parallel/``) on the CPU,
against the JAX package where it has a counterpart: the mesh factors, the
sharded ADMM step on 4 gloo ranks against JAX's ``sharded_admm_step`` on the
conftest's virtual CPU mesh and JAX's unsharded reference, the ring
collectives against ``all_reduce`` / ``all_gather``, the dryrun, the hybrid
layouts, weak scaling and the launcher's deadline and fail-fast.

Every multi-process case starts at most 4 ranks, each launch on a port of
its own (``launch.free_port``) and under a deadline of at most 60 s."""
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from jstsp19_torch.parallel import dist_hybrid, mesh as tmesh  # noqa: E402
from jstsp19_torch.parallel.launch import launch  # noqa: E402
from jstsp19_tpu.parallel.mesh import mesh_shape_for as jmesh_shape_for  # noqa: E402
from jstsp19_tpu.parallel.sharded_admm import reference_admm_batch, sharded_admm_step  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEADLINE = 60  # seconds, for every launch of this file
# one intra-op thread a rank: the suite's other workers hold the cores
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
IMAX = 5
LAYOUTS = {"dp1_sp2_tp2": (1, 2, 2), "dp2_sp2_tp1": (2, 2, 1)}


def test_mesh_shape_for_matches_jax():
    for n in range(1, 65):
        assert tmesh.mesh_shape_for(n) == jmesh_shape_for(n), n
    with pytest.raises(ValueError):
        tmesh.mesh_shape_for(0)


SHARDED_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from jstsp19_torch.parallel.distributed import finish, initialize_from_env
from jstsp19_torch.parallel.dist_hybrid import run_layout
from jstsp19_torch.parallel.mesh import mesh_of_shape

initialize_from_env(cpu=True)
out, imax = sys.argv[1], int(sys.argv[2])
with np.load(f"{{out}}/problem.npz") as z:
    problem = tuple(torch.from_numpy(z[f"arr_{{i}}"]) for i in range(8))
for name, shape in {layouts!r}.items():
    S = run_layout(mesh_of_shape(shape), problem, imax)[3]
    if dist.get_rank() == 0:
        np.save(f"{{out}}/{{name}}_S.npy", S.numpy())
finish()
"""


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """One small problem (frame T=8, 4 realizations: both layouts divide
    it), as numpy; for each layout JAX's sharded step on a 4-device virtual
    mesh, JAX's unsharded reference and the port's step on 4 gloo ranks."""
    out = tmp_path_factory.mktemp("sharded")
    host = [t.numpy() for t in dist_hybrid.host_problem(sp=2, dp=2, device="cpu")]
    np.savez(out / "problem.npz", *host)
    args = [jnp.asarray(h) for h in host]
    Y, Om, A, B, tY, tS, rho, _ = args
    ref = np.asarray(reference_admm_batch(Y, Om, A, B, IMAX, tY, tS, rho))
    runs = {}
    for name, shape in LAYOUTS.items():
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(shape), ("dp", "sp", "tp"))
        runs[name] = dict(jax=np.asarray(sharded_admm_step(mesh, Imax=IMAX)(*args)[0]), ref=ref)
    launch(4, ["-c", SHARDED_WORKER.format(layouts=LAYOUTS), str(out), str(IMAX)], env_extra=ONE_THREAD,
           timeout=DEADLINE, cwd=ROOT)
    for name in LAYOUTS:
        runs[name]["port"] = np.load(out / f"{name}_S.npy")
    return runs


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sharded_step_on_four_ranks_matches_jax(sharded_runs, layout):
    """The port's sharded step on 4 gloo ranks equals JAX's sharded step and
    JAX's unsharded reference within max|ΔS| ≤ 1e-4·max|S| (float32 sums
    in another order over Imax=5 iterations)."""
    run = sharded_runs[layout]
    assert run["port"].shape == run["ref"].shape == (4, dist_hybrid.NR, dist_hybrid.L * dist_hybrid.NT)
    scale = np.abs(run["ref"]).max()
    assert scale > 0
    assert np.abs(run["port"] - run["jax"]).max() <= 1e-4 * scale
    assert np.abs(run["port"] - run["ref"]).max() <= 1e-4 * scale


RING_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from jstsp19_torch.parallel.distributed import finish, initialize_from_env
from jstsp19_torch.parallel.ring import mc_mean_ring, ring_allreduce_mean, ring_pipeline_map

initialize_from_env(cpu=True)
r, n = dist.get_rank(), dist.get_world_size()
g = torch.Generator().manual_seed(r)
x = torch.randn(4, 6, generator=g)
summed = x.clone()
dist.all_reduce(summed)
parts = [torch.empty_like(x) for _ in range(n)]
dist.all_gather(parts, x)
fn = lambda s: (s ** 2).sum(dim=-1) + 3.0
errs = torch.rand(5, 3, generator=g)
every = [torch.empty_like(errs) for _ in range(n)]
dist.all_gather(every, errs)
np.savez(f"{sys.argv[1]}/ring_{r}.npz",
         ring=ring_allreduce_mean(x).numpy(), ring_ref=(summed / n).numpy(),
         pipe=ring_pipeline_map(fn, x).numpy(), pipe_ref=torch.stack([fn(p) for p in parts]).numpy(),
         mc=mc_mean_ring(errs).numpy(), mc_ref=torch.cat(every).mean(dim=0).numpy())
finish()
"""


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring")
    launch(3, ["-c", RING_WORKER, str(out)], env_extra=ONE_THREAD, timeout=DEADLINE, cwd=ROOT)
    return [dict(np.load(out / f"ring_{r}.npz")) for r in range(3)]


@pytest.mark.parametrize("kind", ["ring", "pipe", "mc"])
def test_ring_collectives_equal_all_reduce_and_all_gather(ring_runs, kind):
    """On 3 ranks: the ring mean equals all_reduce/N, the pipelined map
    equals the all-gather-then-map result in origin order, the ring MC mean
    equals the mean of the gathered errors (rtol 1e-6: float32 sums in
    another order), the same on every rank."""
    for res in ring_runs:
        np.testing.assert_allclose(res[kind], res[f"{kind}_ref"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(res[kind], ring_runs[0][kind], rtol=1e-6, atol=1e-6)


def _run(args):
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True, timeout=2 * DEADLINE,
                          env=dict(os.environ, **ONE_THREAD))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_dryrun_checks_sharded_against_unsharded_on_four_cpu_ranks():
    out = _run(["-m", "jstsp19_torch.parallel.dryrun", "4", "--cpu", "--timeout", str(DEADLINE)])
    line = next(ln for ln in out.splitlines() if ln.startswith("dryrun "))
    assert line.startswith("dryrun ok: mesh(dp=1,sp=2,tp=2), max|dS|="), line
    max_ds = float(line.split("max|dS|=")[1].split()[0])
    tol = float(line.split("(tolerance ")[1].split()[0])
    assert 0 <= max_ds <= tol
    assert out.count("backend gloo, device cpu") >= 4


def test_dist_hybrid_layouts_match_the_reference(tmp_path):
    """Two gloo ranks, dp and then sp across processes: each rank's block of
    S against the unsharded reference, max|ΔS| ≤ 1e-4·max|S|."""
    import json

    launch(2, ["-m", "jstsp19_torch.parallel.dist_hybrid", "--cpu", "--out", str(tmp_path / "h.json")],
           env_extra=ONE_THREAD, timeout=DEADLINE, cwd=ROOT)
    res = json.loads((tmp_path / "h.json").read_text())
    assert res["ok"] and res["dp_across_processes"]["mesh"] == [2, 1, 1]
    for layout in ("dp_across_processes", "sp_across_processes"):
        r = res[layout]
        assert 0 <= r["max_abs_dS"] <= dist_hybrid.TOLERANCE * r["max_abs_S"]
        assert 0 < r["mean_nmse"] < 10


def test_scaling_reports_no_efficiency_where_ranks_share_the_cpu(monkeypatch):
    from jstsp19_torch.parallel.scaling import scaling_benchmark

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = scaling_benchmark(Imax=2, per_rank_batch=2, rank_counts=(2,), reps=1, cpu=True, timeout=DEADLINE)
    assert res["rank_counts"] == [2] and res["backend"] == ["gloo"]
    assert all(t > 0 for t in res["throughput"])
    assert "efficiency" not in res and "share the CPU" in res["note"]


def test_launcher_fails_fast():
    """One worker exits 1 at once while the other sleeps 60 s: the launcher
    stops the sleeper and raises, naming the failed worker, within 10 s."""
    code = ("import os, sys, time\nif os.environ['JSTSP19_DIST_PID'] == '0':\n    print('rank 0 fails'); sys.exit(1)\n"
            "time.sleep(60)")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="worker 0 of 2 exited 1") as err:
        launch(2, ["-c", code], timeout=DEADLINE)
    assert time.monotonic() - t0 < 10
    assert "rank 0 fails" in str(err.value)


def test_launcher_has_one_deadline_for_all_workers():
    """Workers of 2 s and 4 s under a 3 s deadline: a launcher that gave
    each wait a fresh 3 s would pass (the second ends 2 s into its wait);
    the shared deadline stops them at 3 s."""
    code = "import os, time\ntime.sleep(2 * (1 + int(os.environ['JSTSP19_DIST_PID'])))"
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"workers \[(0, )?1\] of 2 still ran at the 3 s deadline"):
        launch(2, ["-c", code], timeout=3)
    assert time.monotonic() - t0 < 3.9
