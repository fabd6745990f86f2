"""JAX reference, with standard errors, for the port's errorVSsnr families.

Runs the JAX package on the CPU and writes ``results/torch_families_jax.json``:

- ``error_vs_snr`` (``jstsp19_tpu/harness/experiments.py``) with the methods
  ``omp_td``, ``svt`` and ``tssr`` over its 11 SNR points: for every method
  and point the mean, the standard deviation (ddof 1) and the count of the
  per-realization clamped NMSE values (the sweep's ``raw``);
- ``mc_admm`` at the canonical point, 0 dB: SVT-ADMM matrix completion of
  the unmasked frame ``Y_full`` on the 'tracked' chain, then LS de-mixing
  (the ``mc_admm`` family of the root ``bench_all.py``), over the same
  count of realizations, with its mean, sd and n.

``chip_smoke.py`` phase [16] and ``tests/test_torch_families.py`` hold the
port to it within 4 combined standard errors.

Usage: ``python tools/torch_families_reference.py [N_MC] [OUT_JSON]``
(N_MC defaults to 256; a few minutes on a CPU).
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

from jstsp19_tpu.core import prng  # noqa: E402
from jstsp19_tpu.core.metrics import clamped_nmse  # noqa: E402
from jstsp19_tpu.harness import experiments as jexp  # noqa: E402
from jstsp19_tpu.harness.pipeline import PointConfig, _proposed_frontend  # noqa: E402
from jstsp19_tpu.solvers import ls_estimate  # noqa: E402
from jstsp19_tpu.solvers.lowrank import mc_admm  # noqa: E402

METHODS = ("omp_td", "svt", "tssr")


def _stats(values):
    v = np.asarray(values, np.float64)
    return dict(mean=float(v.mean()), sd=float(v.std(ddof=1)), n=int(v.size))


def mc_admm_errors(n_mc: int, seed: int = 0, noise_var: float = 1.0) -> np.ndarray:
    """(n_mc,) clamped NMSE of the mc_admm family at the canonical point."""
    pc = PointConfig()
    nv = jnp.asarray(noise_var, jnp.float32)

    def one(key):
        ch, obs, A_p, B_p, tau_Y, _, rho = _proposed_frontend(key, pc, nv)
        X, _ = mc_admm(obs.Y_full, obs.Y, obs.Omega, pc.Imax, tau_Y, rho, svt_method="tracked")
        return clamped_nmse(ls_estimate(X, A_p, B_p), ch.Zbar)

    keys = prng.realization_keys(prng.experiment_key(seed), 0, n_mc)
    return np.asarray(jax.jit(jax.vmap(one))(keys))


def main(argv) -> int:
    n_mc = int(argv[0]) if argv else 256
    out_path = argv[1] if len(argv) > 1 else os.path.join(REPO, "results", "torch_families_jax.json")
    t_all = time.time()
    res = jexp.error_vs_snr(n_mc=n_mc, seed=0, methods=METHODS)
    t_sweep = time.time() - t_all
    curves = {}
    for m in METHODS:
        st = [_stats(p) for p in res.extras["raw"][m]]
        curves[m] = {k: [s[k] for s in st] for k in ("mean", "sd", "n")}
    print(f"[error_vs_snr] {METHODS} n_mc {n_mc}: {t_sweep:.1f} s", flush=True)
    t0 = time.time()
    admm = _stats(mc_admm_errors(n_mc))
    t_admm = time.time() - t0
    print(f"[mc_admm] 0 dB n_mc {n_mc}: mean {admm['mean']:.6f}, {t_admm:.1f} s", flush=True)
    doc = dict(
        note=("JAX reference of the errorVSsnr families on the CPU, seed 0: error_vs_snr with methods "
              "omp_td, svt, tssr (svt_method 'eigh', the recipe's default), per SNR point the mean, sd "
              "(ddof 1) and n of the per-realization clamped NMSE; mc_admm at the canonical point, 0 dB "
              "(Y_full completed on 'tracked', then LS de-mixed). Written by "
              "tools/torch_families_reference.py."),
        n_mc=n_mc,
        error_vs_snr=dict(sweep={res.sweep_name: [float(x) for x in res.sweep_values]}, curves=curves),
        mc_admm=dict(snr_db=0.0, **admm),
        seconds=dict(error_vs_snr=t_sweep, mc_admm=t_admm),
        jax=jax.__version__, platform=platform.platform(), total_seconds=time.time() - t_all,
    )
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {out_path} in {time.time() - t_all:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
