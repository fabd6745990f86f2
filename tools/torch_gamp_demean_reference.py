"""JAX reference for the port's mean-removal GAMP on the partial-Hadamard slice.

Runs the JAX package's ``gamp_est`` with ``GampOptions(remove_mean=True)``
(otherwise the defaults: 200 iterations, adaptive step, tol 1e-4) on the CPU
over the problems of
``jstsp19_torch/harness/hadamard_cs.py::hadamard_cs_problem`` (32
realizations, n = 65536, m = 16384, seed 0), one call per realization
(``SubsetOp.idx`` is static, so each call traces anew), and writes the
iterations run and the NMSE per realization and as a batch mean, in dB, to
``results/torch_gamp_demean_jax.json``.  ``chip_smoke.py`` reads that file.

Usage: ``python tools/torch_gamp_demean_reference.py [OUT_JSON]``.
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

from jstsp19_torch.harness import hadamard_cs as hcs  # noqa: E402
from jstsp19_tpu.ops.fourier import FWHTOp  # noqa: E402
from jstsp19_tpu.ops.structured import SubsetOp  # noqa: E402
from jstsp19_tpu.solvers.estim import AwgnPrior, CAwgnLikelihood, SparsePrior  # noqa: E402
from jstsp19_tpu.solvers.gamp_full import GampOptions, gamp_est  # noqa: E402


def main(argv) -> int:
    out = argv[0] if argv else os.path.join(REPO, "results", "torch_gamp_demean_jax.json")
    t0 = time.time()
    prob = hcs.hadamard_cs_problem()
    n = prob["x"].shape[-1]
    prior = SparsePrior(AwgnPrior(0.0, 1.0 / hcs.EPS), hcs.EPS)
    nmse_db, nit = [], []
    for b in range(prob["x"].shape[0]):
        op = SubsetOp(FWHTOp(n), tuple(int(i) for i in prob["idx"][b]))
        like = CAwgnLikelihood(jnp.asarray(prob["y"][b]), jnp.float32(prob["wvar"][b]))
        fin, _, _ = gamp_est(prior, like, op, GampOptions(remove_mean=True))
        nmse_db.append(float(hcs.nmse_db(np.asarray(fin.xhat)[None], prob["x"][b:b + 1])[0]))
        nit.append(int(fin.nit))
        print(f"realization {b}: {nmse_db[-1]:.3f} dB in {nit[-1]} iterations [{time.time() - t0:.0f} s]",
              flush=True)
    v = np.asarray(nmse_db, np.float64)
    doc = dict(
        problem=dict(seed=hcs.SEED, batch=len(nmse_db), n=n, m=int(prob["idx"].shape[-1]), eps=hcs.EPS,
                     snr_db=hcs.SNR_DB, source="jstsp19_torch/harness/hadamard_cs.py::hadamard_cs_problem"),
        gamp_est=dict(options="GampOptions(remove_mean=True)", nit=nit, nmse_db=[float(e) for e in v],
                      mean_db=float(v.mean()), sd_db=float(v.std(ddof=1))),
        jax=jax.__version__, platform=f"JAX on the CPU ({platform.machine()})", seconds=time.time() - t0,
    )
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"gamp_est(remove_mean=True) mean {doc['gamp_est']['mean_db']:.3f} dB; wrote {out} in "
          f"{doc['seconds']:.0f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
