"""JAX reference for the port's EM and turbo checks (``chip_smoke.py`` phase 20).

Runs the JAX package on the CPU, one call per realization, over the problems
of ``jstsp19_torch/harness/em_turbo.py``:

* ``em_bg_vamp`` and ``em_gm_vamp`` (JAX defaults) and the five turbo solvers
  (``turbo_markov_vamp``, ``turbo_mrf_vamp``, ``em_turbo_markov_vamp``,
  ``turbo_gauss_markov_vamp``, ``em_turbo_gauss_markov_vamp``) on the 256
  canonical VAMP problems of ``harness/amp_sparse.py`` through ``KronDictOp``;
* ``em_nngm_gamp`` (JAX defaults) on the 32 partial-Hadamard problems of
  ``harness/hadamard_cs.py`` with the non-negative signal, through
  ``SubsetOp(FWHTOp(n), idx)``;
* ``turbo_mrf3d_vamp`` on the 256 clustered 3-D problems and
  ``turbo_mrf_arb_vamp`` on the 256 Markov-support problems (the first 256
  seeds with a non-empty support) with the ring adjacency, through
  ``MatrixOp``;

and writes each solver's NMSE per realization (dB) with its mean, sd and n,
and each learned hyperparameter per realization with its batch mean, sd and
n (``noise_var`` in dB), to ``results/torch_em_turbo_jax.json``, with the
JAX version, the platform and the seconds it took.

Usage: ``python tools/torch_em_turbo_reference.py [OUT_JSON]``.
"""
from __future__ import annotations

import json
import os
import platform
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO) if REPO not in sys.path else None

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from jstsp19_torch.harness import amp_sparse as aps  # noqa: E402
from jstsp19_torch.harness import em_turbo as et  # noqa: E402
from jstsp19_torch.harness import hadamard_cs as hcs  # noqa: E402
from jstsp19_tpu import solvers  # noqa: E402
from jstsp19_tpu.ops import KronDictOp, MatrixOp  # noqa: E402
from jstsp19_tpu.ops.fourier import FWHTOp  # noqa: E402
from jstsp19_tpu.ops.structured import SubsetOp  # noqa: E402

# the learned hyperparameters each solver reports (noise_var in dB)
PARAMS = {
    "em_bg_vamp": ("noise_var", "p1"),
    "em_gm_vamp": ("noise_var", "p1"),
    "em_turbo_markov_vamp": ("p01", "lam"),
    "em_turbo_gauss_markov_vamp": ("alpha", "sigma2"),
    "em_nngm_gamp": ("noise_var", "p1"),
}


def _stats(v) -> dict:
    v = np.asarray(v, np.float64)
    return dict(values=[float(e) for e in v], mean=float(v.mean()), sd=float(v.std(ddof=1)), n=len(v))


def learned(res, name: str) -> dict:
    """The learned hyperparameters of one JAX result, as numbers."""
    out = {}
    for p in PARAMS.get(name, ()):
        if p == "noise_var":
            out["noise_var_db"] = float(10 * np.log10(float(res.noise_var)))
        elif p == "p1":
            out["p1"] = float(np.asarray(res.prior.p1))
        else:
            out[p] = float(getattr(res, p))
    return out


def _record(doc, name, dbs, params, t0, **extra):
    doc[name] = dict(nmse_db=[float(e) for e in dbs], mean_db=float(np.mean(dbs)), sd_db=float(np.std(dbs, ddof=1)),
                     n=len(dbs), params={k: _stats([p[k] for p in params]) for k in (params[0] if params else {})},
                     **extra)
    print(f"{name}: {doc[name]['mean_db']:.4f} dB over {len(dbs)} [{time.time() - t0:.0f} s]", flush=True)


def main(argv) -> int:
    out = argv[0] if argv else os.path.join(REPO, "results", "torch_em_turbo_jax.json")
    t0 = time.time()
    doc = {}

    # the EM and turbo solvers on the canonical VAMP problems
    vp = aps.vamp_slm_problem()
    beta = float(vp["beta"])
    ops = [KronDictOp(jnp.asarray(vp["A"][b]), jnp.asarray(vp["B"][b])) for b in range(len(vp["y"]))]
    for name, (kw, _) in et.EM_SOLVERS.items():
        dbs, params = [], []
        for b, op in enumerate(ops):
            res = getattr(solvers, name)(jnp.asarray(vp["y"][b]), op, **kw)
            dbs.append(float(aps.nmse_db(np.asarray(res.x)[None], vp["x"][b:b + 1])[0]))
            params.append(learned(res, name))
        _record(doc, name, dbs, params, t0, kwargs=kw)
    for name in et.TURBO_SOLVERS:
        dbs, params = [], []
        for b, op in enumerate(ops):
            args, kw = et.turbo_arguments(name, beta, jnp.float32(vp["gamw"][b]))
            res = getattr(solvers, name)(jnp.asarray(vp["y"][b]), op, *args, **kw)
            dbs.append(float(aps.nmse_db(np.asarray(res.x)[None], vp["x"][b:b + 1])[0]))
            params.append(learned(res, name))
        _record(doc, name, dbs, params, t0, kwargs=kw)

    # em_nngm_gamp on the non-negative partial-Hadamard problems
    prob = hcs.hadamard_cs_problem(nonneg=True)
    n = prob["x"].shape[-1]
    dbs, params = [], []
    for b in range(prob["x"].shape[0]):
        op = SubsetOp(FWHTOp(n), tuple(int(i) for i in prob["idx"][b]))
        res = solvers.em_nngm_gamp(jnp.asarray(prob["y"][b]), op, **et.NNGM_KW)
        dbs.append(float(hcs.nmse_db(np.asarray(res.x)[None], prob["x"][b:b + 1])[0]))
        params.append(learned(res, "em_nngm_gamp"))
    _record(doc, "em_nngm_gamp", dbs, params, t0, kwargs=et.NNGM_KW)

    # the 3-D and arbitrary-adjacency MRF supports
    p3 = et.clustered_3d_problems()
    dbs = [float(aps.nmse_db(np.asarray(solvers.turbo_mrf3d_vamp(
        jnp.asarray(p3["y"][b]), MatrixOp(jnp.asarray(p3["A"][b])), et.MRF_SLAB_VAR, et.MRF_GAMW,
        shape3d=et.SHAPE3D).x)[None], p3["x"][b:b + 1])[0]) for b in range(len(p3["y"]))]
    _record(doc, "turbo_mrf3d_vamp", dbs, [], t0)
    pa = et.markov_support_problems()
    adj = jnp.asarray(et.ring_adjacency())
    dbs = [float(aps.nmse_db(np.asarray(solvers.turbo_mrf_arb_vamp(
        jnp.asarray(pa["y"][b]), MatrixOp(jnp.asarray(pa["A"][b])), et.MRF_SLAB_VAR, et.MRF_GAMW, adj,
        coupling=et.ARB_COUPLING, field=et.ARB_FIELD).x)[None], pa["x"][b:b + 1])[0]) for b in range(len(pa["y"]))]
    _record(doc, "turbo_mrf_arb_vamp", dbs, [], t0)

    doc.update(source="jstsp19_torch/harness/em_turbo.py", jax=jax.__version__,
               platform=f"JAX on the CPU ({platform.machine()})", seconds=time.time() - t0)
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {out} in {doc['seconds']:.0f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
