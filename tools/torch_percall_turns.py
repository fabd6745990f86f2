"""Time the per-op kernels of the unfused route, ``dict_correlation`` and
``fused_soft_threshold``, of this checkout against another checkout's, in
turns, on one GPU.

    python tools/torch_percall_turns.py OTHER_ROOT

OTHER_ROOT is a second checkout of the repository (say, the parent commit
unpacked with ``git archive`` into a git-ignored directory).  Each turn is a
fresh process that imports ``jstsp19_torch`` from one root and builds that
root's ``csrc/*.cu`` into that root's ``kernels/build/``.  At every shape of
``chip_smoke.py`` phase [6] and at K (256, 32, 80) it measures each
wrapper, on the same inputs (drawn from one seed) in both roots:

- ``device_us``: the device time of the kernel a call under
  ``torch.profiler`` (this checkout's ``jstsp19_torch/bench.py::device_ms``
  for both roots, the other root may predate it);
- ``call_us``: the time a call over 200 back-to-back calls between two
  CUDA events, which holds the wrapper's host cost;
- ``host_us``: the host clock over the same 200 calls, without a
  synchronize inside, over 200: what a call costs the host to enqueue;

for this design's wrappers, where a call's host time goes (the wrapper,
its ``torch.empty``, its ctypes call, and one PyTorch elementwise launch
beside them) and the kernel's device time under other plans (1, 2 or 4
realizations a block, tiles of 8 to 64 columns); and then the unfused solve of ``chip_smoke.py`` phase [8] (errorVSnrf
Mr=16, T=5, B=256, Imax=100, kernels on): best and median of ``REPS``
CUDA-event reps.  Every kernel is first held against its plain version
(max|Δ| ≤ 1e-5·max|ref| and ≤ 1e-6).  The turns run other, this, this,
other, so that drift of the card's clocks shows as a difference between a
root's two turns.  The summary gives each shape's best device time of
either root, their ratio and the share of the bound (the larger of the
bytes over 3.35 TB/s and the float32 operations of Aᴴ·(K·Bᴴ) over
67 TFLOP/s).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 200
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# (label, A shape, K shape, B shape): chip_smoke.py phase [6] and K (256, 32, 80)
DICT_CASES = (
    ("errorVSnrf ADMM K (256, 32, 20)", (256, 32, 32), (256, 32, 20), (256, 16, 20)),
    ("errorVSnrf ADMM K (256, 32, 80)", (256, 32, 32), (256, 32, 80), (256, 16, 80)),
    *((f"VAMP adjoint Mr={mr} K (256, {mr}, 16)", (256, mr, 32), (256, mr, 16), (256, 16, 16))
      for mr in (4, 8, 12, 16)),
    ("canonical shared A, B K (256, 32, 140)", (32, 32), (256, 32, 140), (16, 140)),
    ("canonical per realization K (256, 32, 140)", (256, 32, 32), (256, 32, 140), (256, 16, 140)),
)
SOFT_CASES = (("v (256, 32, 16), shared tau", "shared"), ("v (256, 32, 16), per-matrix tau", "per"))


def dict_bound_us(a_shape, k_shape, b_shape) -> tuple:
    """(bound in µs, 'bytes' or 'operations') of Aᴴ·(K·Bᴴ): each input read
    once and the output written once, against 8·B·(N·M·Kd + Gr·N·Kd) float32
    operations."""
    import math

    batch, N, M = k_shape
    Gr, Kd = a_shape[-1], b_shape[-2]
    nbytes = 8 * (math.prod(a_shape) + math.prod(k_shape) + math.prod(b_shape) + batch * Gr * Kd)
    flops = 8.0 * batch * (N * M * Kd + Gr * N * Kd)
    t_bytes, t_ops = 1e6 * nbytes / HBM_BYTES_PER_S, 1e6 * flops / FP32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timed(fn, torch):
    """(µs a call between CUDA events, µs a call on the host clock) over
    CALLS back-to-back calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(end) / CALLS, 1e6 * host / CALLS


def _host_split(torch, dictionary, softthresh, crandn, v, tau) -> dict:
    """Host µs a call (CALLS back-to-back calls on the host clock, best of
    5) of the parts of the wrappers at K (256, 32, 20) and v (256, 32, 16)
    with a per-matrix τ: the whole wrapper, its ``torch.empty`` alone, its
    ctypes call alone (the kernel's launch, with the cached parameters), and
    one PyTorch elementwise launch (``torch.neg`` with ``out=``) beside them."""
    from jstsp19_torch.kernels.build import current_stream

    A, K, B = crandn(256, 32, 32), crandn(256, 32, 20), crandn(256, 16, 20)
    out = torch.empty(256, 32, 16, dtype=torch.complex64, device=K.device)
    _, args, _ = dictionary._call(K.shape, A.shape, B.shape)
    soft_args, _ = softthresh._call(v.numel(), 512)
    dlib, slib = dictionary._library(), softthresh._library()
    stream = current_stream(K.device)
    parts = {
        "dict_correlation": lambda: dictionary.dict_correlation(A, K, B),
        "dict_correlation torch.empty": lambda: torch.empty((256, 32, 16), dtype=torch.complex64, device=K.device),
        "dict_correlation launch": lambda: dlib.dict_correlation_launch(
            A.data_ptr(), K.data_ptr(), B.data_ptr(), out.data_ptr(), args, stream),
        "soft_threshold": lambda: softthresh.fused_soft_threshold(v, tau),
        "soft_threshold launch": lambda: slib.soft_threshold_launch(
            v.data_ptr(), out.data_ptr(), tau.data_ptr(), soft_args, 0.0, stream),
        "torch.neg(out=)": lambda: torch.neg(v, out=out.view(v.shape)),
    }
    best = {}
    for _ in range(5):
        for name, fn in parts.items():
            best[name] = min(best.get(name, float("inf")), _timed(fn, torch)[1])
    return best


def _plan_sweep(torch, dictionary, crandn, device_ms) -> dict:
    """{shape: {"rpb=…, mt=…": device µs a call}} of ``dict_correlation``'s
    kernel under other plans than ``dictionary.plan``'s: 1, 2 or 4
    realizations a block and tiles of 8 to 64 columns (those up to M's
    width), at the errorVSnrf ADMM's K (256, 32, 20) and (256, 32, 80), the
    canonical (256, 32, 140) and VAMP's adjoint at Mr = 4 and 16; each run
    held against the plain version (max|Δ| ≤ 1e-5·max|ref|)."""
    import ctypes

    lib, stream = dictionary._library(), torch.cuda.current_stream().cuda_stream
    sweep = {}
    for N, M in ((32, 20), (32, 80), (32, 140), (4, 16), (16, 16)):
        Gr, Kd = 32, 16
        A, K, B = crandn(256, N, Gr), crandn(256, N, M), crandn(256, Kd, M)
        ref = dictionary.dict_correlation_plain(A, K, B)
        out = torch.empty(256, Gr, Kd, dtype=torch.complex64, device=K.device)
        tk = dictionary.plan(N, M, Gr, Kd).tk
        row = sweep[f"K (256, {N}, {M})"] = {}
        for rpb in (1, 2, 4):
            for mt in (8, 12, 16, 20, 32, 48, 64):
                smem = dictionary.smem_bytes(N, Gr, rpb, tk, mt)
                if mt >= M + 4 or smem > dictionary.SMEM_LIMIT_BYTES:
                    continue
                args = dictionary.params(256, N, M, Gr, Kd, N * Gr, Kd * M, dictionary.DictPlan(rpb, tk, mt, smem))
                call = lambda: lib.dict_correlation_launch(  # noqa: E731
                    A.data_ptr(), K.data_ptr(), B.data_ptr(), out.data_ptr(), ctypes.addressof(args), stream)
                if call() != 0:
                    raise SystemExit(f"the library refused rpb={rpb}, mt={mt} at K (256, {N}, {M})")
                if not float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max()):
                    raise SystemExit(f"rpb={rpb}, mt={mt} disagrees with the plain version at K (256, {N}, {M})")
                row[f"rpb={rpb}, mt={mt}"] = 1e3 * device_ms(call, 100, match="dict_correlation")[0]
    return sweep


def _worker(root: str) -> int:
    sys.path.insert(0, root)
    import torch

    from jstsp19_torch.bench import REPS, card_line, cuda_event_times
    from jstsp19_torch.core import prng
    from jstsp19_torch.harness.pipeline import PointConfig, proposed_problem
    from jstsp19_torch.kernels import dictionary, softthresh
    from jstsp19_torch.solvers.admm import proposed_admm

    assert dictionary.__file__.startswith(os.path.abspath(root)), dictionary.__file__
    spec = importlib.util.spec_from_file_location(
        "this_bench", os.path.join(THIS_ROOT, "jstsp19_torch", "bench.py"))
    this_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(this_bench)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)

    def crandn(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.complex64)

    out = {"root": root, "card": card_line(), "cases": {}}
    for label, a_shape, k_shape, b_shape in DICT_CASES:
        A, K, B = crandn(*a_shape), crandn(*k_shape), crandn(*b_shape)
        ref = dictionary.dict_correlation_plain(A, K, B)
        err = float((dictionary.dict_correlation(A, K, B) - ref).abs().max())
        if not err <= 1e-5 * float(ref.abs().max()):
            raise SystemExit(f"{root}: dict_correlation disagrees with its plain version at {label}")
        call = lambda: dictionary.dict_correlation(A, K, B)  # noqa: E731
        dev_ms, kernels = this_bench.device_ms(call, 100, match="dict_correlation")
        call_us, host_us = _timed(call, torch)
        out["cases"][label] = {"device_us": 1e3 * dev_ms, "kernels": kernels, "call_us": call_us,
                               "host_us": host_us, "bound_us": dict_bound_us(a_shape, k_shape, b_shape)[0]}
    v = crandn(256, 32, 16) * 0.3
    taus = {"shared": 0.2, "per": torch.rand(256, 1, 1, generator=g, device=dev) * 0.4}
    for label, kind in SOFT_CASES:
        tau = taus[kind]
        err = float((softthresh.fused_soft_threshold(v, tau) - softthresh.fused_soft_threshold_plain(v, tau))
                    .abs().max())
        if not err <= 1e-6:
            raise SystemExit(f"{root}: soft_threshold disagrees with its plain version at {label}")
        call = lambda: softthresh.fused_soft_threshold(v, tau)  # noqa: E731
        dev_ms, kernels = this_bench.device_ms(call, 100, match="soft_threshold")
        call_us, host_us = _timed(call, torch)
        nbytes = 2 * v.numel() * 8 + (tau.numel() * 4 if kind == "per" else 0)
        out["cases"][label] = {"device_us": 1e3 * dev_ms, "kernels": kernels, "call_us": call_us,
                               "host_us": host_us, "bound_us": 1e6 * nbytes / HBM_BYTES_PER_S}

    if hasattr(dictionary, "_call"):  # this design: where a call's host time goes, and other plans
        out["host_split_us"] = _host_split(torch, dictionary, softthresh, crandn, v, taus["per"])
        out["plan_sweep_us"] = _plan_sweep(torch, dictionary, crandn, this_bench.device_ms)

    pc8 = PointConfig(Mr=16, T=5, methods=("proposed",))
    prob = proposed_problem(prng.realization_generators(0, 3, dev), pc8, 10 ** (-0.5), 256)
    args = [prob[k] for k in ("subY", "Omega", "A", "B")] + [100] + [prob[k] for k in ("tau_Y", "tau_S", "rho")]
    t, _ = cuda_event_times(lambda r: proposed_admm(*args, use_kernels=True).S, REPS)
    t = sorted(1e3 * x for x in t)
    out["solve_ms"] = {"best": t[0], "median": t[len(t) // 2], "reps": REPS}
    print(json.dumps(out))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other_root")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ns = ap.parse_args()
    if ns.worker:
        return _worker(ns.other_root)
    other = os.path.abspath(ns.other_root)
    results = []
    for label, root in (("other", other), ("this", THIS_ROOT), ("this", THIS_ROOT), ("other", other)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), root, "--worker"],
                              capture_output=True, text=True, cwd=root, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append((label, res))
        for case, v in res["cases"].items():
            print(f"{label:5s} {case}: device {v['device_us']:.2f} us in {v['kernels']:.0f} kernel(s) a call, "
                  f"per call {v['call_us']:.2f} us, host {v['host_us']:.2f} us ({res['card']}; {root})", flush=True)
        for shape, row in res.get("plan_sweep_us", {}).items():
            cells = ", ".join(f"{k} {us:.2f}" for k, us in row.items())
            print(f"{label:5s} other plans at {shape}, device us a call: {cells} ({res['card']})")
        for part, us in res.get("host_split_us", {}).items():
            print(f"{label:5s} host split, {part}: {us:.2f} us a call on the host clock, best of 5 ({res['card']})")
        s = res["solve_ms"]
        print(f"{label:5s} phase [8] unfused solve (Mr=16, B=256, Imax=100): best {s['best']:.3f} ms, "
              f"median {s['median']:.3f} ms of {s['reps']} ({res['card']})", flush=True)
    for case in results[0][1]["cases"]:
        best = {lab: {k: min(r["cases"][case][k] for l2, r in results if l2 == lab)
                      for k in ("device_us", "call_us", "host_us")} for lab in ("this", "other")}
        bound = results[0][1]["cases"][case]["bound_us"]
        t, o = best["this"], best["other"]
        print(f"{case}: device this {t['device_us']:.2f} us, other {o['device_us']:.2f} us, ratio other/this "
              f"{o['device_us'] / t['device_us']:.2f}; bound {bound:.3f} us, {100 * bound / t['device_us']:.1f}% "
              f"of this, {100 * bound / o['device_us']:.1f}% of other; per call this {t['call_us']:.2f} us, "
              f"other {o['call_us']:.2f} us; host this {t['host_us']:.2f} us, other {o['host_us']:.2f} us")
    for lab in ("this", "other"):
        s = [r["solve_ms"] for l2, r in results if l2 == lab]
        medians = ", ".join("%.3f" % x["median"] for x in s)
        print(f"phase [8] solve, {lab}: best {min(x['best'] for x in s):.3f} ms, medians {medians} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
