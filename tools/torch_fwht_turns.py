"""Time the FWHT kernel of this checkout against another checkout's, in
turns, on one GPU.

    python tools/torch_fwht_turns.py OTHER_ROOT

OTHER_ROOT is a second checkout of the repository (say, the parent commit
unpacked with ``git archive`` into a git-ignored directory).  Each turn is a
fresh process that imports ``jstsp19_torch`` from one root, builds that
root's ``csrc/fwht.cu`` into that root's ``kernels/build/``, and times
``fwht_kernel`` at each case of ``CASES``: the device time of its kernels a
call under ``torch.profiler`` (and how many kernels a call runs), and the
time a call of back-to-back calls between two CUDA events, which holds the
wrapper's host cost too.  Both roots are timed with this checkout's
``jstsp19_torch/bench.py::device_ms`` (the other root may predate it).  The
turns run other, this, this, other, so that drift of the card's clocks shows
as a difference between a root's two turns.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 100
# (rows, n, ordering, inverse): the GAMP slice's shape both ways, the row
# path, and the split
CASES = ((32, 65536, "sequency", False), (32, 65536, "sequency", True),
         (256, 4096, "sequency", False), (4, 1 << 20, "sequency", False))


def per_call_ms(fn, calls: int = CALLS) -> float:
    """Milliseconds a call over ``calls`` back-to-back calls between two
    CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _label(case) -> str:
    rows, n, ordering, inverse = case
    return f"({rows}, {n}) {ordering} {'inverse' if inverse else 'forward'}"


def _worker(root: str) -> int:
    sys.path.insert(0, root)
    import torch

    from jstsp19_torch.bench import card_line
    from jstsp19_torch.kernels import wht

    assert wht.__file__.startswith(os.path.abspath(root)), wht.__file__
    spec = importlib.util.spec_from_file_location(
        "this_bench", os.path.join(THIS_ROOT, "jstsp19_torch", "bench.py"))
    this_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(this_bench)
    device_ms = this_bench.device_ms
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"root": root, "card": card_line(), "cases": {}}
    for case in CASES:
        rows, n, ordering, inverse = case
        x = torch.randn(rows, n, generator=g, device=dev)
        ref = (wht.ifwht_plain if inverse else wht.fwht_plain)(x, ordering)
        if not torch.equal(wht.fwht_kernel(x, ordering, inverse=inverse), ref):
            raise SystemExit(f"{root}: the kernel is not bit-equal to its plain version at {_label(case)}")
        call = lambda: wht.fwht_kernel(x, ordering, inverse=inverse)  # noqa: E731
        dev_ms, kernels = device_ms(call, CALLS)
        out["cases"][_label(case)] = {"device_ms": dev_ms, "kernels": kernels, "call_ms": per_call_ms(call)}
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
            print(f"{label:5s} {case}: device {v['device_ms'] * 1e3:.2f} us in {v['kernels']:.0f} kernel(s) a call, "
                  f"per call {v['call_ms'] * 1e3:.2f} us ({res['card']}; {root})", flush=True)
    for case in CASES:
        key = _label(case)
        best = {lab: min(r["cases"][key]["device_ms"] for l2, r in results if l2 == lab) for lab in ("this", "other")}
        print(f"{key}: device this {best['this'] * 1e3:.2f} us, other {best['other'] * 1e3:.2f} us, "
              f"ratio other/this {best['other'] / best['this']:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
