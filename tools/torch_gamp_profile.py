"""Where the time goes in the port's partial-Hadamard GAMP slice on a GPU.

On the problems of ``jstsp19_torch/harness/hadamard_cs.py`` (B=32,
n=65536, m=16384), ``torch.profiler`` over one ``gamp_est`` solve
(``GampOptions()``), one with mean removal (``GampOptions(remove_mean=True)``)
and one lean ``gamp`` solve (100 iterations, step 0.9), each with the FWHT
kernel: wall time, device self time, the device's busy share, the device
event count per iteration and the 12 largest device items.

Usage: ``python tools/torch_gamp_profile.py`` (needs a CUDA device).
"""
from __future__ import annotations

import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO) if REPO not in sys.path else None

from jstsp19_torch.bench import card_line  # noqa: E402
from jstsp19_torch.harness import hadamard_cs as hcs  # noqa: E402
from jstsp19_torch.kernels import wht  # noqa: E402
from jstsp19_torch.solvers.gamp import gamp  # noqa: E402
from jstsp19_torch.solvers.gamp_full import GampOptions, gamp_est  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    wht._library()
    dev, card = torch.device("cuda"), card_line()
    prior, like, op = hcs.hadamard_cs_torch(hcs.hadamard_cs_problem(), dev)
    solvers = {
        "gamp_est": lambda: int(gamp_est(prior, like, op)[0].nit.max()),
        "gamp_est(remove_mean=True)": lambda: int(gamp_est(prior, like, op, GampOptions(remove_mean=True))[0].nit.max()),
        "gamp": lambda: gamp(prior, like, op, nit=hcs.GAMP_NIT, step=hcs.GAMP_STEP) and hcs.GAMP_NIT,
    }
    from torch.profiler import ProfilerActivity, profile

    for name, solve in solvers.items():
        solve()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            its = solve()
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
        kern = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
        dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
        events = sum(e.count for e in kern)
        print(f"{name}, {its} iterations, B={hcs.BATCH}, n={hcs.N}: wall {wall_ms:.3f} ms under the profiler, "
              f"device self time {dev_ms:.3f} ms, busy share {dev_ms / wall_ms:.3f}, device events {events} "
              f"({events / its:.1f} per iteration; {card})", flush=True)
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"  {e.key[:90]:90s} count {e.count:6d} device {e.self_device_time_total / 1e3:9.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
