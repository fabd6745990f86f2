"""JAX reference for the port's AMP, S-AMP, l1 beamspace ADMM and VAMP-SLM checks.

Runs the JAX package on the CPU, one call per realization, over the problems
of ``jstsp19_torch/harness/amp_sparse.py``:

* ``amp_est`` with ``rvar_method`` 'mean' and 'median' (50 iterations) on the
  32 partial-Hadamard problems of ``harness/hadamard_cs.py`` (n = 65536,
  m = 16384, seed 0) through ``ScaledOp(SubsetOp(FWHTOp(n), idx), 2)``;
* S-AMP (``amp_est`` with ``evals_aah``, 200 iterations, damp 0.5) on the 16
  condition-10 log-spectrum problems (numpy seeds 0-15) through ``MatrixOp``;
* ``sparse_admm`` (Imax 100, ρ 0.01, τ_s 1e-4) on the 256 beamspace problems;
* ``vamp_slm`` (50 iterations, damp 0.9) on the 256 canonical VAMP problems;

and writes each one's NMSE per realization (dB) with its mean, sd and n to
``results/torch_amp_sparse_jax.json``, which ``chip_smoke.py`` phase 19 reads.

Usage: ``python tools/torch_amp_sparse_reference.py [OUT_JSON]``.
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
from jstsp19_torch.harness import hadamard_cs as hcs  # noqa: E402
from jstsp19_tpu.ops import KronDictOp, MatrixOp, ScaledOp  # noqa: E402
from jstsp19_tpu.ops.fourier import FWHTOp  # noqa: E402
from jstsp19_tpu.ops.structured import SubsetOp  # noqa: E402
from jstsp19_tpu.solvers import amp_est, sparse_admm, vamp_slm  # noqa: E402
from jstsp19_tpu.solvers.estim import AwgnPrior, CAwgnPrior, SparsePrior  # noqa: E402


def _summary(v, **extra):
    v = np.asarray(v, np.float64)
    return dict(nmse_db=[float(e) for e in v], mean_db=float(v.mean()), sd_db=float(v.std(ddof=1)), n=len(v),
                **extra)


def _log(what, b, db, t0):
    print(f"{what} realization {b}: {db:.3f} dB [{time.time() - t0:.0f} s]", flush=True)


def main(argv) -> int:
    out = argv[0] if argv else os.path.join(REPO, "results", "torch_amp_sparse_jax.json")
    t0 = time.time()
    doc = {}

    # amp_est on the partial-Hadamard problems
    prob = hcs.hadamard_cs_problem()
    n = prob["x"].shape[-1]
    prior = SparsePrior(AwgnPrior(0.0, 1.0 / hcs.EPS), hcs.EPS)
    for method in ("mean", "median"):
        dbs = []
        for b in range(prob["x"].shape[0]):
            op = ScaledOp(SubsetOp(FWHTOp(n), tuple(int(i) for i in prob["idx"][b])), jnp.float32(2.0))
            x = amp_est(jnp.asarray(prob["y"][b] * 2.0), op, prior, nit=aps.AMP_NIT, rvar_method=method,
                        damp=aps.AMP_DAMP)
            dbs.append(float(aps.nmse_db(np.asarray(x)[None], prob["x"][b:b + 1])[0]))
            _log(f"amp_est {method}", b, dbs[-1], t0)
        doc[f"amp_est_{method}"] = _summary(dbs, nit=aps.AMP_NIT, damp=aps.AMP_DAMP)

    # S-AMP on the condition-10 log-spectrum problems
    sp = aps.spectrum_problems()
    prior = SparsePrior(base=AwgnPrior(mean0=0.0, var0=1.0), p1=aps.SPEC_K / aps.SPEC_N)
    dbs = []
    for b in range(len(sp["y"])):
        x = amp_est(jnp.asarray(sp["y"][b]), MatrixOp(jnp.asarray(sp["A"][b])), prior, nit=aps.SAMP_NIT,
                    wvar=aps.SPEC_WVAR, evals_aah=jnp.asarray(sp["evals"][b]), damp=aps.SAMP_DAMP)
        dbs.append(float(aps.nmse_db(np.asarray(x)[None], sp["x"][b:b + 1])[0]))
        _log("S-AMP", b, dbs[-1], t0)
    doc["s_amp"] = _summary(dbs, nit=aps.SAMP_NIT, damp=aps.SAMP_DAMP, seeds=list(aps.SPEC_SEEDS))

    # sparse_admm on the beamspace problems
    bp = aps.beamspace_problem()
    dbs = []
    for b in range(len(bp["H"])):
        _, errs = sparse_admm(jnp.asarray(bp["H"][b]), jnp.asarray(bp["OH"][b]), jnp.asarray(bp["Dr"]),
                              jnp.asarray(bp["Dt"]), aps.ADMM_IMAX, aps.ADMM_RHO, aps.ADMM_TAU_S)
        dbs.append(float(10 * np.log10(np.asarray(errs)[-1])))
        if b % 32 == 0:
            _log("sparse_admm", b, dbs[-1], t0)
    doc["sparse_admm"] = _summary(dbs, imax=aps.ADMM_IMAX, rho=aps.ADMM_RHO, tau_s=aps.ADMM_TAU_S,
                                  snr_db=aps.ADMM_SNR_DB)

    # vamp_slm on the canonical VAMP problems
    vp = aps.vamp_slm_problem()
    beta = float(vp["beta"])
    prior = SparsePrior(CAwgnPrior(jnp.asarray(0.0 + 0.0j), jnp.float32(1.0 / beta)), jnp.float32(beta))
    dbs = []
    for b in range(len(vp["y"])):
        res = vamp_slm(prior, jnp.asarray(vp["y"][b]), KronDictOp(jnp.asarray(vp["A"][b]), jnp.asarray(vp["B"][b])),
                       jnp.float32(vp["gamw"][b]), nit=aps.VAMP_NIT, damp=aps.VAMP_DAMP)
        dbs.append(float(aps.nmse_db(np.asarray(res.x)[None], vp["x"][b:b + 1])[0]))
        if b % 32 == 0:
            _log("vamp_slm", b, dbs[-1], t0)
    doc["vamp_slm"] = _summary(dbs, nit=aps.VAMP_NIT, damp=aps.VAMP_DAMP, noise_var=aps.VAMP_NOISE_VAR)

    doc.update(source="jstsp19_torch/harness/amp_sparse.py", jax=jax.__version__,
               platform=f"JAX on the CPU ({platform.machine()})", seconds=time.time() - t0)
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    print("; ".join(f"{k} {v['mean_db']:.3f} dB" for k, v in doc.items() if isinstance(v, dict))
          + f"; wrote {out} in {doc['seconds']:.0f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
