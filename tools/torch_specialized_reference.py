"""JAX reference, with standard errors, for the port's specialized recipes.

Runs the JAX package's specialized recipes (``jstsp19_tpu/harness/experiments.py``:
``rate_vs_framelength``, ``error_vs_snr_approx``, ``error_vs_zy``,
``error_vs_admmiters``, ``capacity``, ``energy_efficiency``, ``rank_r``,
``rank_r_quirks``, ``error_vs_snr_nyuwireless``, ``channel_correlation`` and
``bar3_beamspace``) on the CPU and writes, for every point of every curve,
the mean, the standard deviation and the count of the per-realization values
behind it to ``results/torch_specialized_jax.json``.  ``chip_smoke.py`` and
``tests/test_torch_specialized_recipes.py`` hold the port's recipes to it.

The recipes average each point with ``np.mean`` and keep only the mean; this
script runs them unchanged with the module's ``np`` replaced by a proxy whose
``mean`` also records the array it averaged, and matches each curve point to
the recorded array whose mean it is.  ``error_vs_snr_nyuwireless`` keeps its
per-realization errors in ``raw``.  ``channel_correlation`` and
``bar3_beamspace`` draw one channel per seed, so they run over ``SEEDS``
seeds and a point's statistics are over the seeds.  ``energy_efficiency`` is
``capacity`` at Nr=64 (the same seed, so the same realizations) over each
front end's power; it runs as itself all the same.

Usage: ``python tools/torch_specialized_reference.py [OUT_JSON]`` (a few
minutes on a CPU).
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

import numpy as np  # noqa: E402

from jstsp19_tpu.harness import experiments as jexp  # noqa: E402

# n_mc of each recipe here; the JAX artifacts in results/ used 16 (rate), 50
# (approx), 8 (zy, nyu), 20 (admmiters), 10000 (capacity, EE), 16 (rank)
N_MC = {
    "rate_vs_framelength": 64,
    "error_vs_snr_approx": 64,
    "error_vs_zy": 128,
    "error_vs_admmiters": 512,
    "capacity": 2000,
    "energy_efficiency": 2000,
    "rank_r": 64,
    "rank_r_quirks": 64,
    "error_vs_snr_nyuwireless": 32,
}
SEEDS = 64  # channel_correlation and bar3_beamspace: one channel a seed


class _RecordingNumpy:
    """numpy, whose ``mean`` also records (array, axis)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(np, name)

    def mean(self, a, axis=None, **kw):
        a = np.asarray(a)
        self.calls.append((a, axis))
        return np.mean(a, axis=axis, **kw)


def _stats(values: np.ndarray, axis: int = 0):
    v = np.asarray(values, np.float64)
    return v.mean(axis=axis), v.std(axis=axis, ddof=1), v.shape[axis]


def _record(name, **kw):
    """Run the JAX recipe ``name`` with np.mean recorded: (SweepResult, calls)."""
    rec = _RecordingNumpy()
    jexp.np = rec
    try:
        res = jexp.EXPERIMENTS[name](**kw)
    finally:
        jexp.np = np
    return res, rec.calls


def _match_scalars(res, calls):
    """{curve: {mean, sd, n}} for recipes whose points are np.mean of a
    (n_mc,) array: each point takes the first unused recorded array whose
    mean it is."""
    pool = [(a, float(np.mean(a))) for a, axis in calls if axis is None]
    used = [False] * len(pool)
    out = {}
    for m, curve in res.curves.items():
        means, sds, ns = [], [], []
        for v in curve:
            j = next(j for j, (a, mu) in enumerate(pool) if not used[j] and mu == v)
            used[j] = True
            mu, sd, n = _stats(pool[j][0])
            means.append(float(mu))
            sds.append(float(sd))
            ns.append(int(n))
        out[m] = dict(mean=means, sd=sds, n=ns)
    return out


def _entry(res, curves, n_mc, **extra):
    return dict(n_mc=n_mc, sweep={res.sweep_name: [float(x) for x in res.sweep_values]}, curves=curves, **extra)


def main(argv) -> int:
    out_path = argv[0] if argv else os.path.join(REPO, "results", "torch_specialized_jax.json")
    t_all = time.time()
    recipes, seconds = {}, {}
    for name in ("rate_vs_framelength", "error_vs_snr_approx", "error_vs_zy", "capacity", "energy_efficiency"):
        t0 = time.time()
        res, calls = _record(name, n_mc=N_MC[name], seed=0)
        if name == "energy_efficiency":  # its means are capacity's over the power: scale the records
            cap = _match_scalars(_record("capacity", n_mc=N_MC[name], seed=0, sizes=((16, 64, 32),))[0], calls)
            curves = {}
            for m, c in res.curves.items():
                src = cap[{"ee_dbf": "dbf_Nr64", "ee_hbf_ps": "hbf_ps_Nr64", "ee_hbf_zc": "hbf_zc_Nr64",
                           "ee_proposed": "proposed_Nr64"}[m]]
                scale = [v / mu for v, mu in zip(c, src["mean"])]
                curves[m] = dict(mean=[float(v) for v in c], sd=[s * k for s, k in zip(src["sd"], scale)],
                                 n=src["n"])
        else:
            curves = _match_scalars(res, calls)
        recipes[name] = _entry(res, curves, N_MC[name])
        seconds[name] = time.time() - t0
        print(f"[{name}] n_mc {N_MC[name]}: {seconds[name]:.1f} s", flush=True)

    name = "error_vs_admmiters"
    t0 = time.time()
    res, calls = _record(name, n_mc=N_MC[name], seed=0)
    curves = {}
    for (conv, _), suffix in zip(calls, ("", "_angles")):  # (n_mc, Imax, 3), both algorithms
        for k, col in (("eps1", 0), ("eps2", 1)):
            mu, sd, n = _stats(conv[:, :, col])
            curves[k + suffix] = dict(mean=mu.tolist(), sd=sd.tolist(), n=[int(n)] * len(mu))
    recipes[name] = _entry(res, curves, N_MC[name])
    seconds[name] = time.time() - t0
    print(f"[{name}] n_mc {N_MC[name]}: {seconds[name]:.1f} s", flush=True)

    for name in ("rank_r", "rank_r_quirks"):
        t0 = time.time()
        res, calls = _record(name, n_mc=N_MC[name], seed=0)
        curves = {}
        for m, curve in res.curves.items():  # (n_mc, 32) singular values, matched by their mean
            sv = next(a for a, axis in calls if axis == 0 and np.array_equal(np.mean(a, axis=0), np.asarray(curve)))
            mu, sd, n = _stats(sv)
            curves[m] = dict(mean=mu.tolist(), sd=sd.tolist(), n=[int(n)] * len(mu))
        recipes[name] = _entry(res, curves, N_MC[name], rank_marker=res.extras["rank_marker"],
                               channel_quirks=res.extras["channel_quirks"])
        seconds[name] = time.time() - t0
        print(f"[{name}] n_mc {N_MC[name]}: {seconds[name]:.1f} s", flush=True)

    name = "error_vs_snr_nyuwireless"
    t0 = time.time()
    res = jexp.EXPERIMENTS[name](n_mc=N_MC[name], seed=0)
    curves = {}
    for m, points in res.extras["raw"].items():
        st = [_stats(p) for p in points]
        curves[m] = dict(mean=[float(s[0]) for s in st], sd=[float(s[1]) for s in st], n=[int(s[2]) for s in st])
    recipes[name] = _entry(res, curves, N_MC[name])
    seconds[name] = time.time() - t0
    print(f"[{name}] n_mc {N_MC[name]}: {seconds[name]:.1f} s", flush=True)

    for name in ("channel_correlation", "bar3_beamspace"):
        t0 = time.time()
        runs = [jexp.EXPERIMENTS[name](n_mc=1, seed=s) for s in range(SEEDS)]
        curves = {}
        for m in runs[0].curves:
            mu, sd, n = _stats(np.stack([np.asarray(r.curves[m]) for r in runs]))
            curves[m] = dict(mean=mu.tolist(), sd=sd.tolist(), n=[int(n)] * len(mu))
        recipes[name] = _entry(runs[0], curves, 1, seeds=SEEDS)
        seconds[name] = time.time() - t0
        print(f"[{name}] seeds 0..{SEEDS - 1}: {seconds[name]:.1f} s", flush=True)

    doc = dict(
        note=("JAX reference of the specialized recipes on the CPU, seed 0: for every curve point the mean, "
              "sd (ddof 1) and n of the per-realization values behind it; channel_correlation and "
              f"bar3_beamspace over seeds 0..{SEEDS - 1}, one channel each. capacity and energy_efficiency "
              f"at n_mc={N_MC['capacity']}, not the reference's 10000. Written by "
              "tools/torch_specialized_reference.py."),
        recipes=recipes, seconds=seconds, jax=jax.__version__, platform=platform.platform(),
        total_seconds=time.time() - t_all,
    )
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {out_path} in {time.time() - t_all:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
