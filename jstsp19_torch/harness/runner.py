"""Sweep runner (counterpart of ``jstsp19_tpu/harness/runner.py``).

The reference parallelizes with a MATLAB ``parfor`` over realizations
(``plot_errorVSsnr_approx.m:41``); here one sweep point is one batch of
``n_mc`` realizations on one device, and the curve value is the batch mean
(``plot_errorVSsnr.m:170-178``).  Under ``--distributed`` (after
:func:`set_distributed_mesh`) each point's realizations are shared out over
the ranks (``parallel/distributed.py``).  The JAX package's single-process
``mesh=`` (several local devices) is not ported: the card's machine has one
card (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from jstsp19_torch.core import prng, trace
from jstsp19_torch.core.config import COMPLEX_DTYPE, resolve_device
from jstsp19_torch.harness import frontend_graph
from jstsp19_torch.harness.pipeline import PointConfig, fused_point_errors, realization_errors
from jstsp19_torch.kernels import admm_fused, launch_counts
from jstsp19_torch.solvers import admm_graph, admm_transposed

FUSED_METHODS = ("proposed", "proposed_angles")


@dataclasses.dataclass
class SweepResult:
    name: str
    sweep_name: str
    sweep_values: List
    curves: Dict[str, List[float]]  # method -> mean metric per sweep point
    n_mc: int
    seconds: float
    extras: Dict = dataclasses.field(default_factory=dict)
    # method -> standard deviation over the realizations (ddof 1) per sweep
    # point, where the run kept it; not written to the JSON, whose schema is
    # the JAX package's
    sd: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(
            {
                "experiment": self.name,
                "sweep": {self.sweep_name: list(map(float, self.sweep_values))},
                "n_mc": self.n_mc,
                "curves": {k: list(map(float, v)) for k, v in self.curves.items()},
                "seconds": self.seconds,
                **{k: v for k, v in self.extras.items() if _jsonable(v)},
            },
            indent=2,
        )


def _jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except TypeError:
        return False


def svt_route(pc: PointConfig, with_taps: bool = False) -> str:
    """The SVT method :func:`run_point` runs ``pc`` with: 'tracked' in place
    of 'fused' where the point has external taps (the fused route's batch
    entry draws its own channels) or the fused kernel cannot take the
    point's shapes (N = Mr_e, M = T·Nt, Gr, K = L·Gt, as
    ``fused_point_errors`` builds them): N > M, or operands its shared
    memory cannot hold."""
    N, M, K = pc.Mr_e, pc.T * pc.Nt, pc.L * pc.Gt
    if pc.svt_method == "fused" and (with_taps or N > M or not admm_fused.fits(N, M, pc.Gr, K)):
        return "tracked"
    return pc.svt_method


# process-wide multi-process mode: set by the CLI's --distributed workers (or
# any program that joined a process group); run_point then shares each point
# out over the ranks and run_sweep's writes are left to rank 0
_DISTRIBUTED = {"mesh": None}


def set_distributed_mesh(mesh) -> None:
    """Route later :func:`run_point` calls through
    ``parallel/distributed.py::distributed_run_point`` on ``mesh`` (a
    one-dimensional ``DeviceMesh`` over every rank,
    ``distributed.global_mc_mesh()``); ``None`` restores one process."""
    _DISTRIBUTED["mesh"] = mesh


def run_point(
    pc: PointConfig,
    noise_var: float,
    n_mc: int,
    seed: int = 0,
    sweep_index: int = 0,
    device=None,
    taps: Optional[torch.Tensor] = None,
    rows: Optional[slice] = None,
) -> Dict[str, np.ndarray]:
    """Evaluate one sweep point over ``n_mc`` realizations on ``device``
    (the card unless named; without one it raises unless ``device="cpu"``);
    returns {method: (n_mc,) NMSE}.

    ``svt_method='fused'`` (the JAX package's 'pallas') solves the proposed
    methods on the fused kernel and the others on 'tracked'; it falls back
    to 'tracked' for all of them when N > M (``Mr_e > T·Nt``), for which
    the fused kernel has no branch, and when the kernel's shared memory
    cannot hold the operands it keeps whole (``admm_fused.fits``; say,
    ``Nr = Mr_e = Gr = 64``).  Both are decided from the shapes, before any
    launch (:func:`svt_route`).  Every call draws from fresh generators of
    (seed, sweep_index), so both halves see the same realizations.

    ``taps``: (n_mc, L, Nr, Nt) external channels (NYU-Wireless ingestion)
    in place of the synthetic generator; with them 'fused' runs as
    'tracked'.  A taps batch other than n_mc raises ValueError.

    ``rows``: solve only this slice of the point's realizations, on the
    whole point's draws; the arrays then have its length.  Under
    :func:`set_distributed_mesh` (and without ``rows``) every rank solves
    its share and every rank returns the whole point.

    Under ``core.trace.recording()`` the call is a ``point`` span, with the
    realizations it solved, the kernel launches it made and the CUDA-graph
    captures and replays of its front end and tracked solves, and the
    tracked solves the fused kernel answered on the transpose
    (``core/trace.py``).
    """
    if _DISTRIBUTED["mesh"] is not None and rows is None:
        from jstsp19_torch.parallel.distributed import distributed_run_point

        return distributed_run_point(pc, noise_var, n_mc, seed=seed, sweep_index=sweep_index, device=device,
                                     taps=taps, mesh=_DISTRIBUTED["mesh"])
    route = svt_route(pc, with_taps=taps is not None)
    with trace.span("point", sweep_index=sweep_index, n_mc=n_mc, route=route) as point:
        launched = launch_counts() if point.on else None
        graphed = _graph_counts() if point.on else None
        device = resolve_device(device)
        if taps is not None:
            if taps.shape[0] != n_mc:
                raise ValueError(f"taps batch {taps.shape[0]} != n_mc {n_mc}")
            taps = taps.to(device=device, dtype=COMPLEX_DTYPE)

        def gens():
            return prng.realization_generators(seed, sweep_index, device)

        pc = dataclasses.replace(pc, svt_method=route)
        if pc.svt_method == "fused":
            out = {}
            fused = tuple(m for m in FUSED_METHODS if m in pc.methods)
            if fused:
                out.update(fused_point_errors(gens(), dataclasses.replace(pc, methods=fused), noise_var, n_mc,
                                              rows=rows))
            rest = tuple(m for m in pc.methods if m not in FUSED_METHODS)
            if rest:
                pcr = dataclasses.replace(pc, methods=rest, svt_method="tracked")
                out.update(realization_errors(gens(), pcr, noise_var, n_mc, rows=rows))
        else:
            out = realization_errors(gens(), pc, noise_var, n_mc, H_ext=taps, rows=rows)
        with trace.span("to_host"):
            answers = {k: v.cpu().numpy() for k, v in out.items()}
        if point.on:
            point.set(realizations=n_mc if rows is None else len(range(n_mc)[rows]),
                      launches={k: n - launched[k] for k, n in launch_counts().items()},
                      **{k: n - graphed[k] for k, n in _graph_counts().items()})
    return answers


def _graph_counts() -> Dict[str, int]:
    """The process's CUDA-graph captures and replays, the front end's
    (``harness/frontend_graph.py``) and the tracked solve's
    (``solvers/admm_graph.py``) together, and its tracked solves answered
    by the fused kernel on the transpose (``solvers/admm_transposed.py``)."""
    return {"captures": frontend_graph.problem.captures + admm_graph.solve.captures,
            "replays": frontend_graph.problem.replays + admm_graph.solve.replays,
            "transposed": admm_transposed.solve.calls}


# process-wide checkpoint defaults, so the CLI can enable sweep resume
# without threading kwargs through every experiment recipe
_DEFAULT_CHECKPOINT = {"dir": None, "backend": "json"}
CHECKPOINT_BACKENDS = ("json", "orbax")


def set_default_checkpoint(directory: Optional[str], backend: str = "json") -> None:
    """Set the checkpoint directory and backend used by every later
    :func:`run_sweep` call that does not pass its own."""
    if backend not in CHECKPOINT_BACKENDS:
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    _DEFAULT_CHECKPOINT["dir"] = directory
    _DEFAULT_CHECKPOINT["backend"] = backend


def primary_process() -> bool:
    """Whether this process writes: the only one, or rank 0 of a process group."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _save_arrays(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """{method: (n_mc,) errors} as one ``.npz``, written whole or not at all."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def run_sweep(
    name: str,
    sweep_name: str,
    sweep_values: Sequence,
    point_fn: Callable[[object], PointConfig],
    noise_fn: Callable[[object], float],
    n_mc: int = 8,
    seed: int = 0,
    device=None,
    verbose: bool = True,
    checkpoint_dir: Optional[str] = None,
    checkpoint_backend: Optional[str] = None,
    taps: Optional[torch.Tensor] = None,
) -> SweepResult:
    """Run a full sweep: for each sweep value build the PointConfig, run the
    Monte-Carlo batch and average each method's metric.

    ``checkpoint_dir``: per-point results are journaled there and completed
    points are skipped on a re-run.  ``checkpoint_backend`` (default: the
    one :func:`set_default_checkpoint` set): ``"json"`` journals each
    point's means as ``<name>.<sweep>.<i>.json``; ``"orbax"`` keeps each
    point's per-realization errors, {method: (n_mc,) array}, as
    ``<name>.<sweep>.<i>.npz`` through numpy (JAX's backend stores the same
    content through orbax, which needs JAX; the value keeps its name so
    the two CLIs take the same flags), and a restore gives the means
    bit-exactly.  Under ``--distributed`` only rank 0 writes and prints;
    every rank reads, so every rank skips the same points.  The verbose
    line of each point ends with its wall time in brackets.
    ``extras['raw']`` holds the per-realization errors when every point
    ran fresh.  ``taps``: external channels for every point, as in
    :func:`run_point`.
    """
    checkpoint_dir = checkpoint_dir or _DEFAULT_CHECKPOINT["dir"]
    backend = checkpoint_backend or _DEFAULT_CHECKPOINT["backend"]
    if backend not in CHECKPOINT_BACKENDS:
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    device = resolve_device(device)
    primary = primary_process()
    verbose = verbose and primary
    ext = ".json" if backend == "json" else ".npz"
    t0 = time.time()
    curves: Dict[str, List[float]] = {}
    raw: Dict[str, List[List[float]]] = {}
    for i, val in enumerate(sweep_values):
        t_point = time.time()
        ckpt = os.path.join(checkpoint_dir, f"{name}.{sweep_name}.{i}{ext}") if checkpoint_dir else None
        point = None
        if ckpt and os.path.exists(ckpt):
            if backend == "json":
                with open(ckpt) as f:
                    point = json.load(f)
            else:
                with np.load(ckpt) as arrays:
                    point = {m: float(np.mean(arrays[m])) for m in arrays.files}
        if point is None:
            out = run_point(point_fn(val), noise_fn(val), n_mc, seed=seed, sweep_index=i, device=device,
                            taps=taps)
            point = {m: float(np.mean(errs)) for m, errs in out.items()}
            for m, errs in out.items():
                raw.setdefault(m, []).append(np.asarray(errs).tolist())
            if ckpt and primary:
                os.makedirs(checkpoint_dir, exist_ok=True)
                if backend == "json":
                    with open(ckpt, "w") as f:
                        json.dump(point, f)
                else:
                    _save_arrays(ckpt, {m: np.asarray(errs) for m, errs in out.items()})
        for m, mean_err in point.items():
            curves.setdefault(m, []).append(mean_err)
        if verbose:
            msg = ", ".join(f"{m}={point[m]:.4g}" for m in sorted(point))
            print(f"[{name}] {sweep_name}={val}: {msg} [{time.time() - t_point:.3f} s]", flush=True)
    res = SweepResult(
        name=name, sweep_name=sweep_name, sweep_values=list(sweep_values), curves=curves,
        n_mc=n_mc, seconds=time.time() - t0,
    )
    if raw and all(len(v) == len(sweep_values) for v in raw.values()):
        res.extras["raw"] = raw
        if n_mc > 1:
            res.sd = {m: [float(np.std(p, ddof=1)) for p in points] for m, points in raw.items()}
    return res
