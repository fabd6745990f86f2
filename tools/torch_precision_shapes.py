"""Decide ``track_precision='default'`` for the port's tracked chain on the card.

The counterpart of ``tools/tpu_precision_shapes.py:49-60``, with its eigh
oracle: at four shapes (the canonical point at 0 dB; delays L=10, T=25; nt
Nt=Gt=16, T=25, FFT combiner; nrf Mr=16, T=5, each at its recipe's noise
variance) the same draws go through 'eigh' and through 'tracked' at
'highest' (full float32), 'high' (as ``PRODUCTS`` maps it: float32 since
the truncating 3xTF32 split biased the mean) and 'tensorfloat32' (one TF32
pass, the candidate for 'default'), for proposed, proposed_angles, svt and
tssr (``realization_errors``) and the mc_admm family (``mc_admm`` on the
proposed observation, LS de-mixing).  The tracked solves run the chain at
every shape (:func:`chain_only`): on the card a float32 N > M one (nrf)
would otherwise run the fused kernel on the transpose, another algorithm.  For each shape, method and precision:
the mean NMSE, the mean and max per-realization |ΔNMSE| against eigh and the
paired z of the mean difference against 'highest'.

Decision: 'default' keeps one TF32 pass only if at every shape and method
the candidate's paired |z| against 'highest' is ≤ 4 and its max |Δ| against
eigh is ≤ max(2 × 'highest''s, 1e-3); otherwise 'default' runs float32.
``ops/tracked.py::PRODUCTS`` holds the decision the port ships.

On the card it also times the tracked route at the canonical point (B =
``--n-mc``, 5 CUDA-event reps after a warm-up) at each precision, and the
two products P = Uᴴ·W and U·(f∘P) at their canonical shapes under
``torch.profiler``: device time a call pair and the kernels' names (a TF32
GEMM names its type), with the max |Δ| of each form against float32.

    python tools/torch_precision_shapes.py [--n-mc 256] [--out results_torch/torch_precision_shapes.json]
    python tools/torch_precision_shapes.py --cpu --n-mc 4      # a rehearsal: every setting is float32 there
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO) if REPO not in sys.path else None

from jstsp19_torch.bench import REPS, card_line, cuda_event_times  # noqa: E402
from jstsp19_torch.core import prng  # noqa: E402
from jstsp19_torch.core.metrics import clamped_nmse  # noqa: E402
from jstsp19_torch.harness.pipeline import PointConfig, _proposed_frontend, realization_errors  # noqa: E402
from jstsp19_torch.ops.tracked import PRODUCTS, chain_product  # noqa: E402
from jstsp19_torch.solvers import admm_transposed  # noqa: E402
from jstsp19_torch.solvers.lowrank import mc_admm  # noqa: E402
from jstsp19_torch.solvers.lsq import ls_estimate  # noqa: E402

SHAPES = {  # name: (PointConfig fields, noise variance), as tools/tpu_precision_shapes.py has them
    "canonical_0db": (dict(), 1.0),
    "delays_L10_T25": (dict(L=10, T=25, num_nonzero=50), 10 ** (-5 / 10)),
    "nt_Nt16_T25": (dict(Nt=16, Gt=16, T=25, num_nonzero=50, beamformer="fft"), 10 ** (-15 / 10)),
    "nrf_Mr16_T5": (dict(Mr=16, T=5), 10 ** (-5 / 10)),
}
METHODS = ("proposed", "proposed_angles", "svt", "tssr")
FAMILIES = METHODS + ("mc_admm",)
PRECISIONS = ("highest", "high", "tensorfloat32")
CANDIDATE = "tensorfloat32"  # one TF32 pass: what 'default' runs if it passes


@contextlib.contextmanager
def chain_only():
    """Inside, ``proposed_admm`` sends no call to the fused kernel on the
    transpose (``solvers/admm_transposed.py``): every tracked solve runs the
    chain, whose precisions the protocol compares."""
    takes = admm_transposed.takes
    admm_transposed.takes = lambda inputs, options: False
    try:
        yield
    finally:
        admm_transposed.takes = takes


def point_errors(pc: PointConfig, noise_var: float, n: int, seed: int, device) -> dict:
    """{family: (n,) float64 NMSE} of one variant on the draws of (seed, 0)."""
    def gens():
        return prng.realization_generators(seed, 0, device)

    out = {m: e.double().cpu() for m, e in realization_errors(gens(), pc, noise_var, n).items()}
    ch, obs, A_p, B_p, tau_Y, _, rho = _proposed_frontend(gens(), pc, noise_var, n)
    X, _ = mc_admm(obs.Y_full, obs.Y, obs.Omega, pc.Imax, tau_Y, rho, svt_method=pc.svt_method,
                   track_precision=pc.track_precision)
    out["mc_admm"] = clamped_nmse(ls_estimate(X, A_p, B_p), ch.Zbar).double().cpu()
    return out


def paired_z(d: torch.Tensor) -> float:
    """Mean of the paired differences over its standard error; 0 where every
    difference is 0."""
    sd = float(d.std()) if d.numel() > 1 else 0.0
    mean = float(d.mean())
    if sd == 0.0:
        return 0.0 if mean == 0.0 else math.copysign(math.inf, mean)
    return mean / (sd / math.sqrt(d.numel()))


def protocol(n: int, seed: int, device) -> dict:
    rows = {}
    for shape, (fields, nv) in SHAPES.items():
        base = PointConfig(methods=METHODS, **fields)
        eigh = point_errors(dataclasses.replace(base, svt_method="eigh"), nv, n, seed, device)
        with chain_only():
            tracked = {p: point_errors(dataclasses.replace(base, svt_method="tracked", track_precision=p), nv, n,
                                       seed, device) for p in PRECISIONS}
        rows[shape] = {"noise_var": nv}
        for m in FAMILIES:
            stats = {"eigh": {"mean_nmse": float(eigh[m].mean())}}
            for p in PRECISIONS:
                d = (tracked[p][m] - eigh[m]).abs()
                stats[p] = dict(mean_nmse=float(tracked[p][m].mean()), mean_abs_diff_vs_eigh=float(d.mean()),
                                max_abs_diff_vs_eigh=float(d.max()),
                                paired_z_vs_highest=paired_z(tracked[p][m] - tracked["highest"][m]),
                                max_abs_diff_vs_highest=float((tracked[p][m] - tracked["highest"][m]).abs().max()))
            rows[shape][m] = stats
            for p in ("eigh",) + PRECISIONS:
                s = stats[p]
                extra = "" if p == "eigh" else (
                    f", |d| vs eigh mean {s['mean_abs_diff_vs_eigh']:.3e} max {s['max_abs_diff_vs_eigh']:.3e}, "
                    f"paired z vs highest {s['paired_z_vs_highest']:+.2f}")
                print(f"[precision] {shape} {m} {p}: mean NMSE {s['mean_nmse']:.6f}{extra}", flush=True)
    return rows


def decide(rows: dict, precision: str = CANDIDATE):
    """(passes, the (shape, method) pairs where it fails) under the rule in
    the module docstring."""
    failing = []
    for shape, row in rows.items():
        for m in FAMILIES:
            s, hi = row[m][precision], row[m]["highest"]
            limit = max(2 * hi["max_abs_diff_vs_eigh"], 1e-3)
            if not (abs(s["paired_z_vs_highest"]) <= 4 and s["max_abs_diff_vs_eigh"] <= limit):
                failing.append((shape, m))
    return not failing, failing


def _profiled(fn, calls: int = 50):
    """(device ms a call, device kernels a call, the GEMM kernels' names) of
    ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return (sum(e.self_device_time_total for e in kern) / 1e3 / calls, sum(e.count for e in kern) / calls,
            sorted({e.key for e in kern if "gemm" in e.key}))


def card_timings(n: int, device) -> dict:
    """The tracked route at the canonical point and the two products alone,
    at each precision."""
    out = {}
    gen = torch.Generator(device=device).manual_seed(0)
    U = torch.linalg.qr(torch.randn(n, 32, 32, dtype=torch.complex64, device=device, generator=gen))[0]
    W = torch.randn(n, 32, 140, dtype=torch.complex64, device=device, generator=gen)
    exact = (U.mH.to(torch.complex128) @ W.to(torch.complex128), U.to(torch.complex128) @ W.to(torch.complex128))
    for p in PRECISIONS:
        pc = PointConfig(methods=("proposed",), svt_method="tracked", track_precision=p)
        times, _ = cuda_event_times(
            lambda r: realization_errors(prng.realization_generators(r, 0, device), pc, 1.0, n), REPS)
        srt = sorted(times)
        mode = PRODUCTS[p]
        ms, count, names = _profiled(lambda: (chain_product(U.mH, W, mode), chain_product(U, W, mode)))
        err = max(float((chain_product(a, W, mode).to(torch.complex128) - e).abs().max())
                  for a, e in zip((U.mH, U), exact))
        out[p] = dict(route_best_ms=srt[0] * 1e3, route_median_ms=srt[len(srt) // 2] * 1e3,
                      products_device_ms=ms, products_device_kernels=count, products_gemm_kernels=names,
                      products_max_abs_err_vs_float64=err)
        print(f"[precision] tracked route, canonical point, B={n}, {p}: best {srt[0] * 1e3:.3f} ms, median "
              f"{srt[len(srt) // 2] * 1e3:.3f} ms; the two products: device {ms * 1e3:.2f} us a pair in {count:g} "
              f"kernels, max|d| vs float64 {err:.3e}, GEMM kernels {names}", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n-mc", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join("results_torch", "torch_precision_shapes.json"))
    p.add_argument("--cpu", action="store_true", help="rehearse on the CPU (every setting is float32 there)")
    ns = p.parse_args(argv)
    if ns.cpu:
        device, card = torch.device("cpu"), "cpu (no card)"
    elif torch.cuda.is_available():
        from jstsp19_torch.kernels.build import KERNELS, build_all

        build_all(KERNELS)
        device, card = torch.device("cuda"), card_line()
    else:
        print("torch_precision_shapes: no CUDA device; pass --cpu to rehearse on the CPU", file=sys.stderr)
        return 1
    print(f"[precision] n_mc {ns.n_mc}, seed {ns.seed}, card: {card}", flush=True)
    rows = protocol(ns.n_mc, ns.seed, device)
    keep, failing = decide(rows)
    high_ok, high_failing = decide(rows, "high")
    differs = max(rows[s][m][CANDIDATE]["max_abs_diff_vs_highest"] for s in SHAPES for m in FAMILIES)
    print(f"[precision] one TF32 pass differs from 'highest': max per-realization |dNMSE| {differs:.3e} "
          f"({'TF32 applied' if differs > 0 else 'no difference: TF32 did not change a result'})", flush=True)
    print(f"[precision] 'high' ({PRODUCTS['high']}) passes the same rule: {high_ok}"
          + (f" (fails at {high_failing})" if high_failing else ""), flush=True)
    print(f"[precision] decision: 'default' {'keeps one TF32 pass' if keep else 'runs float32'}"
          + (f" (fails at {failing})" if failing else "")
          + f"; the port ships 'default' -> {PRODUCTS['default']!r}", flush=True)
    result = dict(n_mc=ns.n_mc, seed=ns.seed, device=str(device), card=card, rows=rows,
                  decision=dict(default_keeps_tf32=keep, failing=failing, shipped=PRODUCTS["default"],
                                high_passes=high_ok, max_abs_diff_tf32_vs_highest=differs))
    if device.type == "cuda":
        result["timings"] = card_timings(ns.n_mc, device)
    out_dir = os.path.dirname(ns.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(ns.out, "w") as f:
        json.dump(result, f, indent=1)
    from jstsp19_torch.kernels import launch_counts

    print(f"[precision] wrote {ns.out}; launches " + ", ".join(f"{k} {v}" for k, v in launch_counts().items()),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
