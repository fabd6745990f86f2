"""JAX reference for the port's bilinear solvers (``chip_smoke.py`` phase 21).

Runs the JAX package on the CPU, one call per realization (the key of
realization b is ``jax.random.key(b)``), over the 256-realization problems
of ``jstsp19_torch/harness/bilinear.py``:

* ``bigamp_mc``, ``em_bigamp_mc``, ``bigamp_lite``, ``em_bigamp_dl``,
  ``bigamp_rpca``, ``bigamp_pev`` and its X2 branch (``bigamp_pev_x2``);
* ``hutamp``;
* ``pbigamp`` and ``em_pbigamp`` on the self-calibration problems;
* ``rank_one_fit`` at 0, 5 and 10 dB (``rank_one_<snr>db``), with
  ``rank_one_se`` on ``mc_prior_mse`` (8192 samples);

and writes each solver's NMSE of Z per realization (dB) with its mean, sd
and n, and each learned quantity per realization with its batch mean, sd
and n (``noise_var`` in dB, ``rank4`` as 0/1, ``sparsity``, ``p1``,
``corr_u``/``corr_v``), to ``results/torch_bilinear_jax.json``, with the
JAX version, the platform and the seconds it took.

Usage: ``python tools/torch_bilinear_reference.py [OUT_JSON] [--batch B]``
(B 256 unless given; a smaller B is for trying the tool out).
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

from jstsp19_torch.harness import bilinear as bl  # noqa: E402
from jstsp19_tpu import solvers  # noqa: E402
from jstsp19_tpu.solvers import estim  # noqa: E402


def _stats(v) -> dict:
    v = np.asarray(v, np.float64)
    return dict(values=[float(e) for e in v], mean=float(v.mean()), sd=float(v.std(ddof=1)), n=len(v))


def _record(doc, name, dbs, params, t0, **extra):
    dbs = np.asarray(dbs, np.float64)
    doc[name] = dict(nmse_db=[float(e) for e in dbs], mean_db=float(dbs.mean()), sd_db=float(dbs.std(ddof=1)),
                     n=len(dbs), params={k: _stats([p[k] for p in params]) for k in (params[0] if params else {})},
                     **extra)
    print(f"{name}: {doc[name]['mean_db']:.4f} dB over {len(dbs)} "
          f"{ {k: round(v['mean'], 5) for k, v in doc[name]['params'].items()} } [{time.time() - t0:.0f} s]",
          flush=True)


def _db(v) -> float:
    return float(10 * np.log10(float(v)))


def _gauss():
    return estim.CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0))


def main(argv) -> int:
    batch = bl.BATCH
    if "--batch" in argv:
        i = argv.index("--batch")
        batch = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    out = argv[0] if argv else os.path.join(REPO, "results", "torch_bilinear_jax.json")
    t0 = time.time()
    doc = {}
    keys = [jax.random.key(b) for b in range(batch)]

    def one(z_true, solve):
        """Each realization's NMSE of Z (dB) and learned quantities."""
        dbs, params = [], []
        for b in range(batch):
            zhat, par = solve(b)
            dbs.append(float(bl.nmse_db(np.asarray(zhat)[None], z_true[b:b + 1])[0]))
            params.append(par)
        return dbs, params

    # [21a] BiG-AMP
    p = bl.mc_problems(batch)
    dbs, _ = one(p["Z"], lambda b: (solvers.bigamp_mc(jnp.asarray(p["Y"][b]), jnp.asarray(p["mask"][b]), bl.MC["R"],
                                                      bl.MC["nv"], keys[b], **bl.MC_KW).Z, {}))
    _record(doc, "bigamp_mc", dbs, [], t0, kwargs=bl.MC_KW)

    p = bl.dl_mc_problems(batch)

    def em_mc(b):
        r = solvers.em_bigamp_mc(jnp.asarray(p["Y"][b]), jnp.asarray(p["mask"][b]), key=keys[b], **bl.EM_MC_KW)
        return r.Z, dict(noise_var_db=_db(r.noise_var), rank4=float(r.rank == bl.DL_MC["R"]))

    dbs, params = one(p["Z"], em_mc)
    _record(doc, "em_bigamp_mc", dbs, params, t0, kwargs=bl.EM_MC_KW)

    def lite(b):
        r, hist = solvers.bigamp_lite(jnp.asarray(p["Y"][b]), jnp.asarray(p["mask"][b]), bl.DL_MC["R"], 1.0, 1.0,
                                      bl.DL_MC["nv"], keys[b], **bl.LITE_KW)
        return r.Z, dict(pass_rate=float(np.asarray(hist["passed"]).mean()))

    dbs, params = one(p["Z"], lite)
    _record(doc, "bigamp_lite", dbs, params, t0, kwargs=bl.LITE_KW)

    dbs, _ = one(p["Z"], lambda b: (solvers.bigamp_pev(
        jnp.asarray(p["Y"][b]), jnp.asarray(p["mask"][b]), bl.DL_MC["R"], _gauss(), _gauss(), bl.DL_MC["nv"],
        keys[b], solvers.BigAmpOptions(nit=bl.PEV_NIT)).Z, {}))
    _record(doc, "bigamp_pev", dbs, [], t0, nit=bl.PEV_NIT)

    p = bl.x2_problems(batch)
    px2 = estim.SparsePrior(base=estim.CAwgnPrior(mean0=0.0 + 0j, var0=1.0), p1=bl.X2["frac"])

    def x2(b):
        r = solvers.bigamp_pev(jnp.asarray(p["Y"][b]), jnp.ones(p["Y"][b].shape, jnp.float32), bl.X2["R"], _gauss(),
                               _gauss(), bl.X2["nv"], keys[b], solvers.BigAmpOptions(nit=bl.X2_NIT),
                               A2=jnp.asarray(p["A2"][b]), prior_x2=px2)
        return r.Z, dict(x2_nmse_db=float(bl.nmse_db(np.asarray(r.X2)[None], p["X2"][b:b + 1])[0]))

    dbs, params = one(p["Z"], x2)
    _record(doc, "bigamp_pev_x2", dbs, params, t0, nit=bl.X2_NIT)

    p = bl.dl_problems(batch)

    def dl(b):
        r = solvers.em_bigamp_dl(jnp.asarray(p["Y"][b]), bl.DL["R"], keys[b])
        return r.Z, dict(noise_var_db=_db(r.noise_var), sparsity=float(r.sparsity))

    dbs, params = one(p["Z"], dl)
    _record(doc, "em_bigamp_dl", dbs, params, t0)

    p = bl.rpca_problems(batch)
    dbs, _ = one(p["Z"], lambda b: (solvers.bigamp_rpca(
        jnp.asarray(p["Y"][b]), bl.RPCA["R"], bl.RPCA["nv"], bl.RPCA["outlier_var"], bl.RPCA["frac"], keys[b],
        nit=bl.RPCA_NIT).Z, {}))
    _record(doc, "bigamp_rpca", dbs, [], t0, nit=bl.RPCA_NIT)

    # [21b] hutamp
    p = bl.hsi_problems(batch)
    dbs, _ = one(p["Z"], lambda b: (solvers.hutamp(jnp.asarray(p["Y"][b]), bl.HSI["R"], keys[b], **bl.HUTAMP_KW).Z,
                                    {}))
    _record(doc, "hutamp", dbs, [], t0, kwargs=bl.HUTAMP_KW)

    # [21c] pbigamp and em_pbigamp on the self-calibration problems
    p = bl.calib_problems(batch)
    beta = bl.CALIB["k"] / bl.CALIB["Nc"]
    prior_b = estim.CAwgnPrior(jnp.asarray(1.0 + 0j), jnp.asarray(bl.CALIB["gain_var"], jnp.float32))
    prior_c = estim.SparsePrior(estim.CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0 / beta, jnp.float32)),
                                jnp.asarray(beta, jnp.float32))
    nv_calib = [10 ** (-bl.CALIB["snr_db"] / 10) * float(np.mean(np.abs(p["z"][b]) ** 2)) for b in range(batch)]
    dbs, _ = one(p["z"], lambda b: (solvers.pbigamp(
        jnp.asarray(p["y"][b]), jnp.asarray(bl.calib_tensor(p["Phi"][b])), prior_b, prior_c, nv_calib[b], keys[b],
        **bl.PBIGAMP_KW).z, {}))
    _record(doc, "pbigamp", dbs, [], t0, kwargs=bl.PBIGAMP_KW)

    def em_pb(b):
        r = solvers.em_pbigamp(jnp.asarray(p["y"][b]), jnp.asarray(bl.calib_tensor(p["Phi"][b])), keys[b])
        return r.z, dict(noise_var_db=_db(r.noise_var), p1=float(jnp.mean(jnp.asarray(r.prior_c.p1))))

    dbs, params = one(p["z"], em_pb)
    _record(doc, "em_pbigamp", dbs, params, t0)

    # [21d] rank_one_fit and its SE
    p = bl.rank_one_problems(batch)
    atoms, weights = bl.v_prior_grid()
    estimu = estim.AwgnPrior(jnp.asarray(0.0), jnp.asarray(1.0))
    estimv = estim.DiscretePrior(jnp.asarray(atoms), jnp.asarray(weights))
    um, uv = solvers.prior_moments(estimu)
    vm, vv = solvers.prior_moments(estimv)
    w = estimv.weights / jnp.sum(estimv.weights)
    mse_u = solvers.mc_prior_mse(lambda k, n: jax.random.normal(k, (n,)), estimu, n_samples=bl.RANK_ONE["n_samples"])
    mse_v = solvers.mc_prior_mse(lambda k, n: estimv.atoms[jax.random.choice(k, estimv.atoms.shape[0], (n,), p=w)],
                                 estimv, n_samples=bl.RANK_ONE["n_samples"])
    m, n = bl.RANK_ONE["m"], bl.RANK_ONE["n"]
    for snr in bl.RANK_ONE["snrs_db"]:
        wvar = bl.rank_one_wvar(snr)
        A = bl.rank_one_matrix(p, snr)
        params = []
        for b in range(batch):
            r = solvers.rank_one_fit(jnp.asarray(A[b]), estimu, estimv, jnp.asarray(wvar, jnp.float32),
                                     nit=bl.RANK_ONE["nit"])
            params.append(dict(corr_u=float(bl.sq_corr(np.asarray(r.u), p["u0"][b])),
                               corr_v=float(bl.sq_corr(np.asarray(r.v), p["v0"][b]))))
        cu, cv = solvers.rank_one_se(mse_u, mse_v, n / m, um, uv, vm, vv, jnp.asarray(wvar, jnp.float32),
                                     nit=bl.RANK_ONE["nit"])
        # the NMSE slot holds 10·log10(1 − corr_v), the v estimate's error after scale alignment
        dbs = [10 * np.log10(max(1.0 - q["corr_v"], 1e-30)) for q in params]
        _record(doc, f"rank_one_{snr:g}db", dbs, params, t0, snr_db=snr, wvar=wvar,
                se_corr_u=float(cu[-1]), se_corr_v=float(cv[-1]))

    doc.update(source="jstsp19_torch/harness/bilinear.py", batch=batch, jax=jax.__version__,
               platform=f"JAX on the CPU ({platform.machine()})", seconds=time.time() - t0)
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {out} in {doc['seconds']:.0f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
