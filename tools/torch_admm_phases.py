"""Per-phase split of the fused tracked-SVT ADMM kernel's iteration on a GPU.

Builds ``jstsp19_torch/kernels/csrc/admm_fused.cu`` once more with
``-DADMM_PHASES`` (a library of its own, named by its own hash beside the
normal one in ``kernels/build/``): block 0's thread 0 then stamps
``clock64()`` after the barrier that ends each phase, or after its own part
of a product for the phases marked "(thread 0)", and sums the cycles per
phase.  The normal build leaves the define off and has no stamps.

For each case (by default the canonical errorVSsnr problem, 0 dB,
Imax=100, at B = 1, 132 and 256, and the errorVSnt Nt=12 shape M=420, K=48
at B=256; or the one point that ``--point`` and ``--batch`` name) it
prints the kernel's time (best of 5 CUDA-event reps of the normal
library), then block 0's cycles per iteration in each phase, its share, and
that share of the kernel's time per iteration.  A point with N > M (say
errorVSnrf's, ``--point Mr=16 T=5``) runs on the transposed problem, as
``solvers/admm_transposed.py`` hands it to the kernel.

Usage: ``python tools/torch_admm_phases.py [--one-block-per-sm]
[--point FIELD=VALUE ... --batch B]`` (needs a CUDA device); the option
launches with more than half an SM's shared memory, so that one block runs
on an SM where the plan would put two.  The point's fields are
``harness.pipeline.PointConfig``'s, at 0 dB.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO) if REPO not in sys.path else None

from jstsp19_torch.bench import NOISE_VAR_0DB, REPS, card_line, cuda_event_times  # noqa: E402
from jstsp19_torch.core import prng  # noqa: E402
from jstsp19_torch.harness.pipeline import PointConfig, proposed_problem  # noqa: E402
from jstsp19_torch.kernels import admm_fused  # noqa: E402
from jstsp19_torch.solvers import admm_transposed  # noqa: E402

PHASE_FLAGS = ("-DADMM_PHASES",)
IMAX = 100
CASES = (  # (label, PointConfig changes, batch)
    ("canonical B=1", {}, 1),
    ("canonical B=132", {}, 132),
    ("canonical B=256", {}, 256),
    ("errorVSnt Nt=12 (M=420, K=48) B=256", dict(Nt=12, Gt=12, T=35, beamformer="fft"), 256),
)


def _args(changes, batch, dev):
    pc = PointConfig(methods=("proposed",), svt_method="fused", **changes)
    prob = proposed_problem(prng.realization_generators(0, 0, dev), pc, NOISE_VAR_0DB, batch)
    if prob["subY"].shape[-2] > prob["subY"].shape[-1]:  # N > M: the transposed problem
        prob = admm_transposed.operands(dict(prob, support_rank=None))
    return [prob[k] for k in ("subY", "Omega", "A", "B", "tau_Y", "tau_S", "rho")]


def _field(item):
    """``FIELD=VALUE`` as a (field, int or str) pair."""
    field, _, value = item.partition("=")
    return field, int(value) if value.lstrip("-").isdigit() else value


def _solve(lib, smem, args):
    """The solve on ``lib``'s kernel with ``smem`` bytes of shared memory."""
    return admm_fused._launch(lib, smem, *args, IMAX, None, 1, 10, 5)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--one-block-per-sm", action="store_true")
    ap.add_argument("--point", nargs="+", metavar="FIELD=VALUE", help="one point's PointConfig fields")
    ap.add_argument("--batch", type=int, default=256, help="the point's realizations")
    ns = ap.parse_args()
    cases = CASES
    if ns.point:
        cases = ((" ".join(ns.point) + f" B={ns.batch}", dict(map(_field, ns.point)), ns.batch),)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev, card = torch.device("cuda"), card_line()
    normal, staged = admm_fused._library(), admm_fused._library(PHASE_FLAGS)
    names = staged.fused_tracked_admm_phase_names().decode().split(",")
    cycles = (ctypes.c_longlong * len(names))()
    print(f"card: {card}")
    for label, changes, batch in cases:
        args = _args(changes, batch, dev)
        Bt, N, M = args[0].shape
        Gr, K = args[2].shape[-1], args[3].shape[-2]
        try:
            plan = admm_fused.plan(N, M, Gr, K)
        except ValueError as e:  # a shape the kernel refuses
            print(f"\n{label} (N={N}, M={M}, K={K}): refused: {e}")
            continue
        smem = plan.smem_bytes
        if ns.one_block_per_sm:
            smem = max(smem, admm_fused.SM_SMEM_BYTES // 2 - admm_fused.BLOCK_RESERVED_BYTES + 4)
        blocks = admm_fused.blocks_per_sm(N, Gr, K, smem)
        ms = 1e3 * min(cuda_event_times(lambda r: _solve(normal, smem, args), REPS)[0])
        _solve(staged, smem, args)  # warm-up
        torch.cuda.synchronize()
        staged.fused_tracked_admm_phase_cycles(None, 1)
        _solve(staged, smem, args)
        torch.cuda.synchronize()
        if staged.fused_tracked_admm_phase_cycles(cycles, 0) != 0:
            raise RuntimeError("reading the phase cycles failed")
        total = sum(cycles)
        print(f"\n{label} (N={N}, M={M}, K={K}, Imax={IMAX}): kernel {ms:.3f} ms, best of {REPS} "
              f"({card}); block 0: {total / IMAX:.0f} cycles per iteration; {admm_fused.instance(N, Gr, K)}, "
              f"{blocks} block(s) an SM, "
              f"{smem} B shared")
        for name, c in zip(names, cycles):
            share = c / total if total else 0.0
            print(f"  {name:32s} {c / IMAX:10.0f} cycles/it  {100 * share:5.1f}%  "
                  f"{1e3 * ms * share / IMAX:8.3f} us/it of the kernel's time")
    return 0


if __name__ == "__main__":
    sys.exit(main())
