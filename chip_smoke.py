#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code and no result):

0. the card's name and power limit (``nvidia-smi``);
1. build the CUDA kernel ``jstsp19_torch/kernels/csrc/admm_fused.cu`` from
   the checkout and print the build time and the compiler's report;
2. the kernel against its plain PyTorch version at the canonical shapes,
   B=8, Imax=25, with and without a support rank:
   max|ΔS| ≤ 2e-4·max|S| and a finite Y;
3. the main path, ``fused_point_errors`` at the canonical ``PointConfig``
   (proposed and proposed_angles, B=256, 0 dB, Imax=100): the kernel's
   launch count rose; every NMSE is finite and in [0, 1]; the per-realization
   NMSE agrees with the plain tracked route on the same problem at
   rtol 2e-3, atol 2e-4; the batch mean of 'proposed' lies within 4
   combined standard errors of the same-ensemble reference in
   ``results/error_vs_snr.json``;
4. both routes timed at B=256 with CUDA events (5 reps after a warm-up).

Then one JSON line with the kernel's launches, error and times, the card
line, and last ``{"ok": true, "device": {...}}``.  Needs a CUDA device; there
is no CPU fallback.
"""
from __future__ import annotations

import json
import math
import pathlib
import sys
import time

import torch

B_CHECK, IMAX_CHECK = 8, 25
B_MAIN, IMAX_MAIN = 256, 100


def _reference_0db(root: pathlib.Path):
    """(mean, sd, n) of 'proposed' at 0 dB in the same-ensemble reference run."""
    d = json.loads((root / "results" / "error_vs_snr.json").read_text())
    i = d["sweep"]["snr_db"].index(0.0)
    raw = d["raw"]["proposed"][i]
    n = len(raw)
    mean = sum(raw) / n
    sd = math.sqrt(sum((x - mean) ** 2 for x in raw) / (n - 1))
    return mean, sd, n


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the GPU", file=sys.stderr)
        return 1

    from jstsp19_torch.bench import NOISE_VAR_0DB, REPS, card_line, cuda_event_times, time_route
    from jstsp19_torch.core import prng
    from jstsp19_torch.core.metrics import clamped_nmse
    from jstsp19_torch.harness.pipeline import PointConfig, fused_point_errors, proposed_problem
    from jstsp19_torch.kernels import admm_fused
    from jstsp19_torch.kernels.admm_fused import fused_tracked_admm, fused_tracked_admm_plain
    from jstsp19_torch.kernels.build import library_path

    root = pathlib.Path(__file__).resolve().parent
    dev = torch.device("cuda")

    # ---- 0. the card -----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[0] device: {kind}; nvidia-smi: {card}")

    # ---- 1. build --------------------------------------------------------------
    t0 = time.time()
    admm_fused._library()
    print(f"[1] built {library_path('admm_fused').name} in {time.time() - t0:.3f} s")
    log = library_path("admm_fused").with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())

    # ---- 2. kernel against its plain version, B=8, Imax=25 ---------------------
    pc = PointConfig(methods=("proposed", "proposed_angles"), svt_method="fused")
    prob = proposed_problem(prng.realization_generators(11, 0, dev), pc, NOISE_VAR_0DB, B_CHECK)
    args = [prob[k] for k in ("subY", "Omega", "A", "B", "tau_Y", "tau_S", "rho")]
    for rank in (None, prob["rank"]):
        S_k, Y_k = fused_tracked_admm(*args, Imax=IMAX_CHECK, support_rank=rank)
        S_p, _ = fused_tracked_admm_plain(*args, Imax=IMAX_CHECK, support_rank=rank)
        torch.cuda.synchronize()
        err = float((S_k - S_p).abs().max())
        scale = float(S_p.abs().max())
        finite = bool(torch.isfinite(torch.view_as_real(Y_k)).all())
        print(
            f"[2] support={'rank' if rank is not None else 'none'}: max|dS|={err:.3e} "
            f"<= 2e-4*max|S|={2e-4 * scale:.3e}: {err <= 2e-4 * scale}; Y finite: {finite}"
        )
        if not (err <= 2e-4 * scale and finite):
            raise SystemExit("[2] kernel disagrees with its plain version")

    # ---- 3. the main path --------------------------------------------------------
    fused_tracked_admm.launches = 0
    out = fused_point_errors(prng.realization_generators(0, 0, dev), pc, NOISE_VAR_0DB, B_MAIN)
    torch.cuda.synchronize()
    launches = fused_tracked_admm.launches
    print(f"[3] main path: fused_tracked_admm launches = {launches}")
    if launches < 1:
        raise SystemExit("[3] the main path did not launch the kernel")

    prob = proposed_problem(prng.realization_generators(0, 0, dev), pc, NOISE_VAR_0DB, B_MAIN)
    args = [prob[k] for k in ("subY", "Omega", "A", "B", "tau_Y", "tau_S", "rho")]
    max_abs_err = 0.0
    for method, rank in (("proposed", None), ("proposed_angles", prob["rank"])):
        e = out[method]
        if not (bool(torch.isfinite(e).all()) and float(e.min()) >= 0.0 and float(e.max()) <= 1.0):
            raise SystemExit(f"[3] {method}: NMSE not finite or outside [0, 1]")
        S_k, _ = fused_tracked_admm(*args, Imax=IMAX_MAIN, support_rank=rank)
        S_p, _ = fused_tracked_admm_plain(*args, Imax=IMAX_MAIN, support_rank=rank)
        if not torch.allclose(clamped_nmse(S_k, prob["Zbar"]), e, rtol=1e-5, atol=1e-6):
            raise SystemExit(f"[3] {method}: the regenerated problem does not reproduce the main path")
        e_plain = clamped_nmse(S_p, prob["Zbar"])
        dev_max = float((e - e_plain).abs().max())
        ok = bool(torch.allclose(e, e_plain, rtol=2e-3, atol=2e-4))
        max_abs_err = max(max_abs_err, float((S_k - S_p).abs().max()))
        print(
            f"[3] {method}: mean NMSE {float(e.mean()):.6f} (plain tracked {float(e_plain.mean()):.6f}); "
            f"max per-realization |dNMSE| = {dev_max:.3e}; within rtol 2e-3, atol 2e-4: {ok}"
        )
        if not ok:
            raise SystemExit(f"[3] {method}: fused and plain tracked NMSE disagree")

    ref_mean, ref_sd, ref_n = _reference_0db(root)
    e = out["proposed"]
    mean, sd = float(e.mean()), float(e.std())
    se = math.sqrt(ref_sd**2 / ref_n + sd**2 / e.numel())
    inside = abs(mean - ref_mean) <= 4 * se
    print(
        f"[3] proposed NMSE@0dB batch mean {mean:.6f} (sd {sd:.4f}, n {e.numel()}) vs reference "
        f"{ref_mean:.6f} (sd {ref_sd:.4f}, n {ref_n}): band ±{4 * se:.4f}, inside: {inside}"
    )
    if not inside:
        raise SystemExit("[3] batch-mean NMSE outside the 4-sigma band of the reference")

    # ---- 4. timing -----------------------------------------------------------------
    ms = 1e3 * min(cuda_event_times(lambda r: fused_tracked_admm(*args, Imax=IMAX_MAIN), REPS)[0])
    plain_ms = 1e3 * min(
        cuda_event_times(lambda r: fused_tracked_admm_plain(*args, Imax=IMAX_MAIN), REPS)[0])
    print(f"[4] solve alone at B={B_MAIN}, Imax={IMAX_MAIN}: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms (best of {REPS}; card: {card})")
    for route in ("fused", "tracked"):
        times, means = time_route(route, B_MAIN, REPS)
        best, worst = min(times), max(times)
        median = sorted(times)[len(times) // 2]
        print(f"[4] route {route}: best {best * 1e3:.3f} ms, median {median * 1e3:.3f} ms, "
              f"spread {(worst - best) * 1e3:.3f} ms over {REPS} reps (card: {card})")
        print(f"[4] route {route}: {B_MAIN / best:.1f} est/s at B={B_MAIN} (card: {card}); "
              f"NMSE batch means {[round(m, 4) for m in means]}")

    print(json.dumps({"kernels": [{
        "name": "fused_tracked_admm",
        "route": "cuda",
        "source": "jstsp19_torch/kernels/csrc/admm_fused.cu",
        "replaces": "jstsp19_tpu/kernels/admm_fused.py:361",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
