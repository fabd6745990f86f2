"""Per-phase split of the FWHT kernel on a GPU.

Builds ``jstsp19_torch/kernels/csrc/fwht.cu`` once more with
``-DFWHT_PHASES`` (a library of its own, named by its own hash beside the
normal one in ``kernels/build/``): thread 0 of every block then adds the
``clock64()`` cycles of each phase of the row or cluster kernel to a device
array, up to the barrier that ends the phase, or up to the end of its own
part where none follows.  The normal build has no stamps.

First it compares cluster sizes at (32, 65536) float32, sequency order:
for each size of ``CLUSTER_SIZES`` (the normal build's ``wht.CLUSTER``, and
builds with ``-DFWHT_CLUSTER=2`` or ``4``) it prints how many such clusters
the card holds at once (32 rows need 32), and the device time a call
forward and inverse, each checked bit-equal to the plain version.  For
each case of ``CASES`` it then prints the kernel's device time a call
(``torch.profiler``, normal library), then a block's mean cycles in each
phase, its share, and that share of the device time.

Usage: ``python tools/torch_fwht_phases.py`` (needs a CUDA device).
"""
from __future__ import annotations

import ctypes
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO) if REPO not in sys.path else None

from jstsp19_torch.bench import card_line, device_ms  # noqa: E402
from jstsp19_torch.kernels import wht  # noqa: E402

PHASE_FLAGS = ("-DFWHT_PHASES",)
CASES = (  # (rows, n, ordering, inverse)
    (32, 65536, "sequency", False),
    (32, 65536, "sequency", True),
    (32, 65536, "natural", False),
    (128, 16384, "natural", False),
    (256, 4096, "sequency", False),
)
CLUSTER_SIZES = (2, 4, 8)


def cluster_plan(n: int, cluster: int) -> wht.FwhtPlan:
    """The cluster path's plan for float32 rows of n in clusters of
    ``cluster`` blocks (``plan_fwht``'s rule with another cluster size)."""
    part = n * 4 // cluster
    return wht.FwhtPlan("cluster", cluster, min(wht.MAX_THREADS, part // (2 * wht.REG_BYTES)), part)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev, card = torch.device("cuda"), card_line()
    normal, staged = wht._library(), wht._library(PHASE_FLAGS)
    names = staged.fwht_phase_names().decode().split(",")
    cycles = (ctypes.c_longlong * (len(names) + 1))()
    g = torch.Generator(device=dev).manual_seed(0)
    print(f"card: {card}")
    x = torch.randn(32, 65536, generator=g, device=dev)
    assert wht.plan_fwht(65536, 4) == cluster_plan(65536, wht.CLUSTER)
    for cluster in CLUSTER_SIZES:
        lib = normal if cluster == wht.CLUSTER else wht._library((f"-DFWHT_CLUSTER={cluster}",))
        plan = cluster_plan(65536, cluster)
        times = []
        for inverse in (False, True):
            if not torch.equal(wht._launch(lib, x, "sequency", inverse, plan),
                               (wht.ifwht_plain if inverse else wht.fwht_plain)(x)):
                raise SystemExit(f"clusters of {cluster}: not bit-equal to the plain version")
            times.append(device_ms(lambda: wht._launch(lib, x, "sequency", inverse, plan))[0])
        print(f"(32, 65536) float32 sequency, clusters of {cluster} blocks of {plan.smem_bytes // 1024} KB and "
              f"{plan.threads} threads ({32 * cluster} blocks; the card holds "
              f"{lib.fwht_cluster_capacity(0, plan.threads, plan.smem_bytes)} such clusters at once): device "
              f"{times[0] * 1e3:.2f} us forward, {times[1] * 1e3:.2f} us inverse a call, bit-equal ({card})")
    for rows, n, ordering, inverse in CASES:
        x = torch.randn(rows, n, generator=g, device=dev)
        plan = wht.plan_fwht(n, 4)
        d_ms, _ = device_ms(lambda: wht._launch(normal, x, ordering, inverse, plan))
        wht._launch(staged, x, ordering, inverse, plan)  # warm-up
        torch.cuda.synchronize()
        staged.fwht_phase_cycles(None, 1)
        wht._launch(staged, x, ordering, inverse, plan)
        torch.cuda.synchronize()
        if staged.fwht_phase_cycles(cycles, 0) != 0:
            raise RuntimeError("reading the phase cycles failed")
        blocks = cycles[len(names)]
        per_block = [c / blocks for c in cycles[:len(names)]]
        total = sum(per_block)
        print(f"\n({rows}, {n}) float32 {ordering} {'inverse' if inverse else 'forward'}, {plan}: device "
              f"{d_ms * 1e3:.2f} us a call ({card}); {blocks} blocks, {total:.0f} cycles a block")
        for name, c in zip(names, per_block):
            share = c / total if total else 0.0
            print(f"  {name:72s} {c:9.0f} cycles  {100 * share:5.1f}%  {1e3 * d_ms * share:7.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
