"""Where the time goes at one errorVSnrf point of the PyTorch port on a GPU.

At Mr=16, T=5, B=256 and noise 10^(-5/10), each method alone through
``realization_errors`` (eigh SVT unless named), then the whole five-method
point: best, median and spread of ``bench.REPS`` CUDA-event reps.  Then
``torch.profiler`` over two whole points: wall time, device self time, the
device's busy share, the device event count and the 15 largest device items.

Usage: ``python tools/torch_nrf_profile.py`` (needs a CUDA device).
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO) if REPO not in sys.path else None

from jstsp19_torch.bench import REPS, card_line, cuda_event_times  # noqa: E402
from jstsp19_torch.core import prng  # noqa: E402
from jstsp19_torch.harness.pipeline import PointConfig, realization_errors  # noqa: E402
from jstsp19_torch.kernels import dictionary, softthresh  # noqa: E402
from jstsp19_torch.kernels.build import KERNELS, build_all  # noqa: E402

NV_5DB = 10 ** -0.5
B = 256
CASES = [  # (label, methods, svt_method)
    ("frontend only", (), "eigh"),
    ("ls", ("ls",), "eigh"),
    ("omp_mmv", ("omp_mmv",), "eigh"),
    ("vamp", ("vamp",), "eigh"),
    ("proposed (eigh)", ("proposed",), "eigh"),
    ("proposed (tracked)", ("proposed",), "tracked"),
    ("proposed_angles (eigh)", ("proposed_angles",), "eigh"),
    ("whole point, 5 methods", None, "eigh"),
]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    build_all(KERNELS)
    dictionary._library()
    softthresh._library()
    dev, card = torch.device("cuda"), card_line()
    base = PointConfig(Mr=16, T=5)

    def point(methods, svt):
        pc = dataclasses.replace(base, methods=base.methods if methods is None else methods, svt_method=svt)
        return lambda r: realization_errors(prng.realization_generators(r, 3, dev), pc, NV_5DB, B)

    for label, methods, svt in CASES:
        t, _ = cuda_event_times(point(methods, svt), REPS)
        best, median = min(t), sorted(t)[len(t) // 2]
        print(f"{label}: best {best * 1e3:.3f} ms, median {median * 1e3:.3f} ms, "
              f"spread {(max(t) - best) * 1e3:.3f} ms ({REPS} reps; {card})", flush=True)

    from torch.profiler import ProfilerActivity, profile

    f = point(None, "eigh")
    f(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for r in range(1, 3):
            f(r)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kern = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"profile, 2 whole points: wall {wall_ms:.3f} ms, device self time {dev_ms:.3f} ms, "
          f"busy share {dev_ms / wall_ms:.3f}, device events {sum(e.count for e in kern)} ({card})")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.key[:90]:90s} count {e.count:6d} device {e.self_device_time_total / 1e3:9.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
