#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code and no result):

0. the card's name and power limit (``nvidia-smi``);
1. build every CUDA kernel of ``jstsp19_torch/kernels/csrc/`` from the
   checkout, one ``nvcc`` per source, all started together, and print
   ``admm_fused``'s build time and the compiler's report;
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
4. both routes timed at B=256 with CUDA events (5 reps after a warm-up);
5. the build time and compiler report of ``dict_correlation.cu`` and
   ``soft_threshold.cu`` (built in phase 1);
6. each of those kernels against its plain version at every shape the
   second slice launches (B=256): ``dict_correlation`` for the errorVSnrf
   ADMM (K 32x20 and, at Mr=16, 32x80), VAMP's adjoint (K Mrx16, A Mrx32,
   Mr in 4, 8, 12, 16) and the canonical K 32x140, shared and per
   realization, max|Δ| ≤ 1e-5·max|ref|; ``soft_threshold`` with a shared
   and a per-matrix τ, max|Δ| ≤ 1e-6; at each shape the plan
   (``kernels/dictionary.py::plan``), the device time a call under
   ``torch.profiler``, the time a call of back-to-back calls (with the
   wrapper's host cost) and the bound; both timed against their plain
   versions;
7. the second slice, ``python -m jstsp19_torch run error_vs_nrf --n-mc 256
   --no-plot``, in-process: exit 0; both kernels' launch counts rose by at
   least 4 points x 2 proposed methods x Imax; every curve value finite and
   in [0, 1]; each method at each Mr within 4 combined standard errors of
   ``results/error_vs_nrf.json``; the wall time of each point;
8. one errorVSnrf point (Mr=16, T=5, B=256, Imax=100) on the unfused route
   with the kernels on and off: per-realization NMSE within rtol 2e-3,
   atol 2e-4; both timed with CUDA events (5 reps after a warm-up);
9. the build time of ``fwht.cu`` (built in phase 1) and the compiler's
   line (registers, stack, spills) of each of its kernel instances;
10. the FWHT kernel against its plain version at every boundary of
    ``kernels/wht.py::plan_fwht`` (n in 2, 64, 4096 and 2^14 to 2^20, so the
    row, cluster and split paths of float32 and complex64), natural and
    sequency order, forward and inverse: bit-equal (max|Δ| = 0); its time
    per call at (32, 65536) and (256, 4096) against the plain version and
    against one ``torch.matmul`` with the dense sequency Walsh matrix; its
    device time a call under ``torch.profiler`` and the device kernels a
    call at (32, 65536) forward and inverse, (256, 4096) and (4, 2^20);
11. the third slice, partial Walsh–Hadamard compressive sensing
    (``harness/hadamard_cs.py``: B=32, n=65536, m=16384, ε=0.05, 40 dB)
    through ``gamp_est`` (``GampOptions()``) and the lean ``gamp`` (100
    iterations, step 0.9): ``fwht_kernel.launches`` rose by at least 2 × the
    iterations run; every NMSE finite; the per-realization NMSE within 1%
    of the same solve with the kernel off; each solver's batch mean NMSE (dB)
    within 4 combined standard errors of ``results/torch_gamp_fwht_jax.json``;
12. both solvers timed with CUDA events (5 reps after a warm-up), the
    kernel on and off in turns;
13. the fused ADMM kernel against its plain version at each of the 12
    distinct shapes the fused route reaches in the seven sweep recipes
    (N = Gr = 32, (M, K) from (40, 16) to (420, 48) and (400, 64); the
    problems of those sweep points), B=8, and at errorVSnrf's N > M problem
    on the transpose (Mr=16, T=5: N = 20, M = 32, Gr = 16, K = 32, as
    ``solvers/admm_transposed.py`` hands it over), B=8 and 10^4; Imax=25,
    with and without a support rank: max|ΔS| ≤ 2e-4·max|S| and a finite Y;
    each shape's plan (tile width, blocks per SM by shared memory, shared
    memory), the kernel instance it runs (``admm_fused.instance``), the
    blocks an SM holds on the card and the compiler's line for the instance;
14. the kernel timed at the canonical shape for B = 1, 132 and 256, at
    (M, K) = (420, 48) for B=256 and at errorVSnrf's transposed shape for
    B=10^4, Imax=100: best, median and spread of 5 CUDA-event reps, each
    beside its bound;
15. the fourth slice, the specialized recipes: ``dict_correlation`` and
    ``soft_threshold`` against their plain versions at every shape these
    recipes give them (max|Δ| ≤ 1e-5·max|ref| and ≤ 1e-6), each with its
    plan, its device time a call under ``torch.profiler`` and its bound; then every recipe
    through the CLI (``python -m jstsp19_torch run <recipe> --n-mc N
    --no-plot``, in-process) at the reference's size (capacity and energy
    efficiency at n_mc=10000 over all their geometries; rate, the
    approximate front end and the other ADMM recipes at 256;
    ``channel_correlation`` and ``bar3_beamspace``, one channel a run, over
    seeds 0-63): exit 0; the JSON has the keys, sweep and curve names of
    ``results/<recipe>.json``; every value finite; every point within 4
    combined standard errors of ``results/torch_specialized_jax.json``; both
    kernels' launch counts rose in each ADMM recipe; each recipe's wall
    time; and the approximate front end's 0 dB point (Imax=50, approximate
    mode, B=256) with the kernels on and off on the same generators:
    per-realization NMSE within rtol 2e-3, atol 2e-4;
16. the fifth slice, the remaining errorVSsnr families: (a) ``python -m
    jstsp19_torch run error_vs_snr --methods omp_td,svt,tssr --n-mc 256
    --no-plot``, in-process: exit 0, every value finite and in [0, 1], each
    method at each of the 11 SNR points within 4 combined standard errors of
    ``results/torch_families_jax.json``, the wall time of each point; (b)
    the ``mc_admm`` family (``bench_all.mc_admm_errors``) at the canonical
    point, B=256, 0 dB, held the same way; (c) the proposed ADMM with
    ``svt_method='jacobi'`` at the canonical point, B=256, Imax=100, 0 dB:
    both per-op kernels' launch counts rose, per-realization |ΔNMSE| ≤ 0.02
    against ``svt_method='eigh'`` on the same problem, the batch mean
    within 4 SE of ``results/error_vs_snr.json``'s 0 dB point, its wall
    time; (d) ``time_comparisons`` through the CLI (n_mc 8) and
    ``python -m jstsp19_torch.bench_all``'s table at B=256 with the latency
    table at B = 1, 4 and 32, in-process, with the launches of the fused
    ADMM and the per-op kernels on each.
17. the sixth slice: (a) the precision protocol of the tracked chain
    (``tools/torch_precision_shapes.py --n-mc 256``, its own process): the
    four shapes, 'eigh' against 'tracked' at 'highest', 'high' and one TF32
    pass, the decision for 'default' and whether TF32 changed a result;
    (b) ``python -m jstsp19_torch run error_vs_nrf --distributed 2 --n-mc
    256 --no-plot``: exit 0, each rank's backend and device, each rank's
    ``dict_correlation`` and ``soft_threshold`` launches > 0, every method's
    per-realization NMSE at every Mr equal to phase [7]'s single-process run
    within rtol 2e-3, atol 2e-4, the wall time of each point beside phase
    [7]'s; (c) ``distributed_run_point`` at the canonical point on the fused
    route over 2 ranks (``parallel/distributed.py``'s worker): each rank's
    fused-kernel launches > 0, equal to ``run_point`` within the same
    tolerance; (d) ``python -m jstsp19_torch.parallel.dryrun`` with 1 rank
    (NCCL) and 2 ranks (gloo, one card): max|ΔS| against the unsharded
    reference within its tolerance, ``soft_threshold`` launched on each
    rank; (e) ``panel --batch --n-mc 16 --set methods=ls,proposed``: its
    means equal ``run_point``'s; (f) ``run error_vs_nrf --checkpoint-backend
    orbax`` and its resume from the ``.npz`` checkpoints: means bit-equal.
18. the seventh slice, mean removal and the estimator library: (a) phase
    11's problems through ``gamp_est(..., GampOptions(remove_mean=True))``
    (``DemeanRCOp`` around ``SubsetOp(FWHTOp)``: 6 FWHT launches an
    iteration, and 2 to build it): ``fwht_kernel.launches`` rose by at least
    6 × the iterations run + 2; every NMSE finite; the per-realization NMSE
    within 1% of the same solve with the kernel off; the batch mean NMSE
    (dB) within 4 combined standard errors of
    ``results/torch_gamp_demean_jax.json``; (b) that solve and phase 11's
    ``GampOptions()`` solve timed with CUDA events (5 reps after a warm-up),
    the kernel on and off in turns; (c) every one of the 45 estimators
    (``harness/estim_check.py``) at (32, 65536): ``estim`` and whichever of
    ``estim_map``, ``loglike`` and ``logscale`` it has, on the card against
    the CPU on the same inputs, max|Δ| ≤ 1e-5·max|ref| for the closed forms
    and 1e-4 for the tails, quadrature and particle forms.
19. the eighth slice (``harness/amp_sparse.py``, ``harness/op_check.py``):
    (a) ``amp_est`` with ``rvar_method`` 'mean' and 'median' (50 iterations)
    on phase 11's problems through ``ScaledOp(SubsetOp(FWHTOp), 2)``:
    exactly 2 FWHT launches an iteration, per-realization NMSE within 1% of
    the kernel off, the batch mean within 4 SE of
    ``results/torch_amp_sparse_jax.json``, both timed in turns; (a') S-AMP
    on 16 condition-10 log-spectrum problems (200 iterations, damp 0.5):
    every NMSE < 1e-3, the batch mean within 4 SE, its time and device
    kernels an iteration; (b) ``dict_correlation`` and ``soft_threshold``
    against their plain versions at the shapes of ``sparse_admm`` and
    ``vamp_slm``, then ``sparse_admm`` at the canonical point's shapes
    (B=256, Imax 100): 101 and 100 launches, per-realization NMSE within
    1e-3 of the kernels off, the batch mean within 4 SE, timed in turns;
    (c) ``vamp_slm`` on the canonical VAMP problem (B=256, 50 iterations):
    one ``dict_correlation`` launch, the batch mean within 4 SE, realization
    0's ``mse_track`` beside ``vamp_slm_se``; (d) the card against the CPU:
    every new operator (max|Δ| ≤ 1e-5·max|ref|, adjoint identity to 1e-4),
    the four state evolutions on the same draws (1e-4) and the random
    constructors' structure.
20. the ninth slice, EM learning and the turbo solvers
    (``harness/em_turbo.py``): (a) ``em_bg_vamp`` and ``em_gm_vamp`` (JAX
    defaults) on phase 19c's problem (B=256, ``KronDictOp``): exactly
    n_em + 1 ``dict_correlation`` launches a solve (9 and 11), the
    per-realization NMSE within 1e-3 (relative) of a ``KronDictOp`` whose
    ``rmv`` is the plain version, the batch mean NMSE and the learned noise
    variance (dB) and activity within 4 combined SE of
    ``results/torch_em_turbo_jax.json``, best and median of 3 reps of each
    route; (b) the five turbo solvers (``turbo_markov_vamp``,
    ``turbo_mrf_vamp``, ``em_turbo_markov_vamp``,
    ``turbo_gauss_markov_vamp``, ``em_turbo_gauss_markov_vamp``) on the same
    problem, the chains along the Gr = 32 axis: exactly one launch a round
    (5, 5, 8, 6, 10), the same gates, and the learned p01, λ, alpha and
    sigma2 within 4 SE; (c) ``em_nngm_gamp`` on phase 11's problems with
    the non-negative signal |x|: exactly 2 × 40 × 11 + 10 = 890 FWHT
    launches, the same gates against the kernel off; (d)
    ``turbo_mrf3d_vamp`` and ``turbo_mrf_arb_vamp`` on 256 seeds of the
    JAX tests' problems (``MatrixOp``): the batch mean NMSE within 4 SE;
    realizations 0-31 re-solved on the CPU and, in float64, on the card and
    the CPU: the float64 card within 1e-6 of max|x| of the CPU, the float32
    distances printed (two float32 runs of this ill-conditioned solve
    differ by up to a few 1e-3).
21. the tenth slice, the bilinear solvers (``harness/bilinear.py``, B=256
    realizations a problem set, the repo's documented sizes): (a)
    ``bigamp_mc``, ``em_bigamp_mc`` (max rank 8), ``bigamp_lite``,
    ``bigamp_pev`` and its X2 branch, ``em_bigamp_dl`` and ``bigamp_rpca``;
    (b) ``hutamp``; (c) ``pbigamp`` and ``em_pbigamp`` on the
    self-calibration problems (A one (96, 96, 128) tensor a realization);
    (d) ``rank_one_fit`` at 0, 5 and 10 dB with ``rank_one_se`` on
    ``mc_prior_mse`` (8192 samples): the share of realizations lost (NMSE
    of Z not finite or ≥ 0 dB; JAX loses 43 of 256 with ``hutamp``, 8 with
    ``em_pbigamp``) at most JAX's + 4 SE, the batch mean NMSE (dB) of the
    kept realizations within 4 combined standard errors of JAX's in
    ``results/torch_bilinear_jax.json``, and so the learned noise variance
    (dB), ``em_bigamp_mc``'s share of rank 4, ``em_bigamp_dl``'s sparsity,
    ``em_pbigamp``'s p1 and the rank-one squared correlations, the latter
    also within 0.1 of the SE's last value at 5 and 10 dB (at 0 dB, below
    the transition, JAX's own fit lies 0.11 and 0.18 from it: printed); the share of realizations that
    meet the JAX test's own threshold; realizations 0-31 of each problem
    solved in complex128/float64 on the card and on the CPU (the CPU's
    solves in a process started after [1], beside the card's phases),
    max|ΔZ| ≤ 1e-6·max|Z| over the
    realizations the CPU keeps finite (the card's non-finite on exactly the
    others) and the same selected ranks, the float32 card's distance from the
    float64 CPU printed; best and median of 3
    reps of each solver; the four kernels' launch counts unchanged (no
    kernel is on this path).
22. the eleventh slice, the 21 worked examples (``jstsp19_torch/examples/``,
    each the problem and printout of a JAX ``examples/*.py`` script, at its
    documented sizes): (a) ``python -m jstsp19_torch demo`` lists the 21, and
    ``python -m jstsp19_torch demo <name>`` runs each on the card in a
    process of its own: exit 0, every printed number finite, the printed
    labels those of ``results/torch_examples_jax.json`` (the JAX scripts'
    printout; ``large_array_sharded``'s header names its ranks where JAX
    names its mesh); (b) each example's ``solve`` on the card and on the CPU
    (in the process of [21]'s CPU solves, after them) on the port's own
    draws, drawn on the CPU: every number within the example's
    ``TOLERANCE`` (``CARD_TOLERANCE`` where float32 roundoff moves a number
    further, with its measured reason; in float64 on both, the float32
    distance printed, where the example has ``FLOAT64``); (c) the routes of
    ``KronDictOp.rmv``: ``sparse_recovery`` and ``s_amp`` take
    ``torch.matmul`` (their operators are a real one and one whose A the
    kernel's shared memory cannot hold), a VAMP-shape operator the kernel
    (equal to the plain version); every example's kernel launches, read
    across its first solve, are exactly those the routes give: none but
    ``channel_estimation``'s pipeline (each ADMM method's two per-op
    kernels once an iteration, VAMP's adjoint once an iteration); (d)
    ``large_array_sharded`` over 2 ranks sharing the card (gloo) equals one
    process to rtol 1e-6; (e) each example's ``solve`` time on the card, best
    of 3, and the phase's wall time.
23. the twelfth slice, the host library and the kernel routes by dtype and
    shape: (a) ``fwht_kernel`` at (32, 65536) float32, sequency and natural
    order, against ``jstsp19_torch/utils/native.py::native_fwht`` (the g++
    host library, built on this machine) of the same rows in float64,
    max|Δ| ≤ 1e-5·max|ref|; (b) on the card, a float64 ``gamp_est`` (mean
    removal off) and ``amp_est`` on partial-Hadamard problems (B=8,
    n=4096), a complex128 ``sparse_admm`` ([19b]'s problems), a complex128
    ``proposed_admm(use_kernels=True)`` (an errorVSnrf Mr=16 point, B=16)
    and the float64 FWHT of one row of 2^25: no kernel launched (the four
    kernels' counts, and every route counter on the plain route), each
    within 1e-8 of the same solve on the CPU (made in the process of [21]'s
    and [22]'s CPU halves, first) per realization; (a) and (b) run in a
    process of their own beside [21] and [22], which leave the card and the
    host room, and print their lines after [22]; (c) the soft threshold
    at one τ against ``F.softshrink`` on the real view, (256, 32, 16):
    equal, both timed (device time under ``torch.profiler`` from a trace
    that recorded one kernel a call, and time a call of 200, in turns), the
    softshrink's better time a call the kernels line's ``library_ms``.

Then one JSON line with each kernel's launches, error, times and bound (the
larger of its bytes over 3.35 TB/s and its float32 operations over
67 TFLOP/s, the H100 SXM's published peaks), the card line, and last
``{"ok": true, "device": {...}}``.  Needs a CUDA device; there is no CPU
fallback.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import pathlib
import re
import sys
import tempfile
import time

import numpy as np
import torch

B_CHECK, IMAX_CHECK = 8, 25
B_MAIN, IMAX_MAIN = 256, 100
NRF_MR = (4, 8, 12, 16)
NV_5DB = 10 ** (-0.5)
NOISE_VAR = 1.0  # 0 dB
TIMED_CALLS = 200
BILINEAR_CPU_REALIZATIONS = 32  # [21]'s float64 card-against-CPU check, realizations 0-31
ROUTES_BATCH, ROUTES_N = 8, 4096  # [23b]'s float64 partial-Hadamard problems
ROUTES_ADMM_BATCH = 16  # [23b]'s complex128 proposed_admm
ROUTES_FWHT_N = 1 << 25  # [23b]'s float64 row, over the FWHT kernel's 2^24
ROUTES_RTOL = 1e-8  # [23b]: float64 card against CPU, max|d|/max|ref| per realization
ROUTES_ORACLE_RTOL = 1e-5  # [23a]: the float32 kernel against the float64 oracle, max|d|/max|ref|
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 bandwidth, published
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, published
FWHT_NS = (2, 64, 4096, *(1 << k for k in range(14, 21)))  # every boundary of plan_fwht
# the fused route's 12 distinct (M, K) shapes in the seven recipes, each from
# one sweep point that reaches it (PointConfig fields; N = Gr = 32)
SWEEP_SHAPES = (
    ("errorVSsnr (M=140, K=16)", {}),
    ("errorVSframelength T=5 (M=40, K=32)", dict(Nt=8, Gt=8, T=5, beamformer="fft")),
    ("errorVSframelength T=15 (M=120, K=32)", dict(Nt=8, Gt=8, T=15, beamformer="fft")),
    ("errorVSframelength T=25 (M=200, K=32)", dict(Nt=8, Gt=8, T=25, beamformer="fft")),
    ("errorVSframelength T=35 (M=280, K=32)", dict(Nt=8, Gt=8, T=35, beamformer="fft")),
    ("errorVSdelays L=4 (M=40, K=16)", dict(L=4, T=10)),
    ("errorVSdelays L=6 (M=60, K=24)", dict(L=6, T=15)),
    ("errorVSdelays L=8 (M=80, K=32)", dict(L=8, T=20)),
    ("errorVSdelays L=10 (M=100, K=40)", dict(L=10, T=25)),
    ("errorVSnt Nt=6 (M=210, K=24)", dict(Nt=6, Gt=6, beamformer="fft")),
    ("errorVSnt Nt=12 (M=420, K=48)", dict(Nt=12, Gt=12, beamformer="fft")),
    ("errorVSnt Nt=16 (M=400, K=64)", dict(Nt=16, Gt=16, T=25, beamformer="fft")),
)


# errorVSnrf's N > M problem (plot_errorVSnrf.m:20-23 at Mr=16: N = 32 > M = 20, -5 dB), which the kernel runs on
# the transpose (solvers/admm_transposed.py: N' = 20, M' = 32, Gr' = 16, K' = 32), at [13]'s batch and at the
# realizations a point of the benchmark's nrf_tracked_b10000
NRF_KERNEL = ("errorVSnrf Mr=16 T=5 on the transpose (M=32, K=32)", dict(Mr=16, T=5), NV_5DB)
B_NRF = 10_000


def _kernel_problem(changes, noise_var, batch, seed, dev):
    """The fused kernel's seven operands and the oracle support rank of one
    point's problem (``proposed_problem``); an N > M problem on the
    transpose, as ``solvers/admm_transposed.py`` hands it to the kernel."""
    from jstsp19_torch.core import prng
    from jstsp19_torch.harness.pipeline import PointConfig, proposed_problem
    from jstsp19_torch.solvers import admm_transposed

    pc = PointConfig(methods=("proposed", "proposed_angles"), svt_method="fused", **changes)
    prob = proposed_problem(prng.realization_generators(seed, 0, dev), pc, noise_var, batch)
    if prob["subY"].shape[-2] > prob["subY"].shape[-1]:
        prob = admm_transposed.operands(dict(prob, support_rank=prob["rank"]))
        prob["rank"] = prob["support_rank"]
    return [prob[k] for k in ("subY", "Omega", "A", "B", "tau_Y", "tau_S", "rho")], prob["rank"]


def _mangled(instance: str) -> str:
    """The template arguments of ``admm_fused.instance``'s answer as they
    appear in the kernel's symbol (``<32, 32, 1, 0, 2>`` -> ``ILi32E...E``)."""
    args = instance[instance.index("<") + 1:-1].split(", ")
    return "I" + "".join(f"Li{a}E" for a in args) + "E"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the float32 operations over the peak rate."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _admm_flops(B: int, N: int, M: int, Gr: int, K: int, Imax: int) -> float:
    """Real float32 operations of the fused ADMM's complex products (8 per
    complex multiply-add) over Imax iterations, each counted at its cheapest
    association, so that no way of computing the same function needs fewer:
    - the SVT, the cheaper of the P form (P = UᴴW; one round of N/2
      rotations on P's rows with their 2×2 Grams and on U's columns;
      Y = U(f∘P)) and the Gram form (G = WWᴴ, T = Uᴴ(GU), the rotations on
      T's rows and columns and on U's columns, Z = U f Uᴴ, Y = ZW; G, T and
      Z are Hermitian, so only half of each is counted);
    - A·S, then (A·S)·B;
    - Aᴴ·K·Bᴴ as the cheaper of Aᴴ(KBᴴ) and (AᴴK)Bᴴ;
    - (AᴴA)·v·(BBᴴ) for the gradient and again for the exact step.
    The elementwise work is left out, so the count is a lower bound."""
    half = N * (N + 1) // 2
    svt_p = 2 * N * N * M + (N // 2) * (7 * M + 4 * N)
    svt_gram = half * M + N ** 3 + 2 * half * N + (N // 2) * 12 * N + N * N * M
    macs = (min(svt_p, svt_gram) + N * Gr * K + N * K * M
            + min(N * K * M + Gr * N * K, Gr * N * M + Gr * M * K) + 2 * (Gr * Gr * K + Gr * K * K))
    return 8.0 * macs * Imax * B


def _walsh_t(n: int, device) -> torch.Tensor:
    """The dense (n, n) float32 matrix Wᵀ with ``fwht(x) = x @ Wᵀ``
    (sequency order): Wᵀ[j, k] = (−1)^popcount(j & perm(k)) / √n, built in
    row chunks on the device."""
    from jstsp19_torch.kernels.wht import _sequency_perm

    perm = torch.as_tensor(_sequency_perm(n), dtype=torch.int32, device=device)
    out = torch.empty((n, n), dtype=torch.float32, device=device)
    step = max(1, (1 << 27) // n)
    for j0 in range(0, n, step):
        v = torch.arange(j0, min(n, j0 + step), dtype=torch.int32, device=device)[:, None] & perm[None, :]
        for s in (16, 8, 4, 2, 1):
            v = v ^ (v >> s)
        out[j0:j0 + v.shape[0]] = (1 - 2 * (v & 1)).to(torch.float32) / math.sqrt(n)
    return out


def _stats(raw):
    """(mean, sd, n) of per-realization errors."""
    n = len(raw)
    mean = sum(raw) / n
    return mean, math.sqrt(sum((x - mean) ** 2 for x in raw) / (n - 1)), n


def _reference_0db(root: pathlib.Path):
    """(mean, sd, n) of 'proposed' at 0 dB in the same-ensemble reference run."""
    d = json.loads((root / "results" / "error_vs_snr.json").read_text())
    return _stats(d["raw"]["proposed"][d["sweep"]["snr_db"].index(0.0)])


def _sweep_reference(root: pathlib.Path, name: str):
    """{method: [(mean, sd, n) per sweep point]} of a committed JAX sweep's raw errors."""
    d = json.loads((root / "results" / f"{name}.json").read_text())
    return {m: [_stats(raw) for raw in points] for m, points in d["raw"].items()}


def _print_build(phase: str, name: str, seconds) -> None:
    from jstsp19_torch.kernels.build import library_path

    print(f"{phase} built {library_path(name).name} in {seconds[name]:.3f} s "
          "(all kernels built together)")
    log = library_path(name).with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())


def _ptxas_report(log: str) -> dict:
    """{kernel symbol: its ``-Xptxas -v`` lines (stack, spills, registers) on
    one line} from a build log."""
    out, name = {}, None
    for line in log.splitlines():
        if "Function properties for " in line:
            name, out[line.split("Function properties for ")[1].strip()] = line.split()[-1], ""
        elif name is not None:
            out[name] = (out[name] + " " + line.replace("ptxas info    :", "").strip()).strip()
            if "Used " in line:
                name = None
    return out


def _per_call_ms(fn, calls: int = TIMED_CALLS) -> float:
    """Milliseconds per call of ``fn()`` over ``calls`` back-to-back calls
    between two CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


# the fourth slice's recipes and the n_mc each runs at in phase 15: the
# reference's 10000 for capacity and energy efficiency, 256 for the rest
# (at or above their JAX artifacts' 8 to 50)
SPECIAL_RECIPES = (
    ("capacity", 10000), ("energy_efficiency", 10000), ("rate_vs_framelength", B_MAIN),
    ("error_vs_snr_approx", B_MAIN), ("error_vs_zy", B_MAIN), ("error_vs_admmiters", B_MAIN),
    ("error_vs_snr_nyuwireless", B_MAIN), ("rank_r", B_MAIN), ("rank_r_quirks", B_MAIN),
)
SPECIAL_ADMM = ("rate_vs_framelength", "error_vs_snr_approx", "error_vs_zy", "error_vs_admmiters",
                "error_vs_snr_nyuwireless")
SINGLE_CHANNEL = ("channel_correlation", "bar3_beamspace")  # one channel a run
SINGLE_SEEDS = 64  # the maxima are heavy-tailed: a normal z needs many seeds


def _resolution(name: str, ref_mean) -> float:
    """The numerical resolution of a recipe's curve, added in quadrature to
    its standard error: a float32 Gram's eigenvalues are resolved to about
    Mr_e·eps of the largest, so the rank recipes' singular values to
    sqrt(Mr_e·eps) of the largest (the null space's values are roundoff in
    both packages); 0 for the other recipes."""
    if name.startswith("rank_r"):
        return math.sqrt(len(ref_mean) * float(np.finfo(np.float32).eps)) * max(ref_mean)
    return 0.0


def _special_shapes(B: int):
    """(what, A, K, B) shapes the specialized recipes give the two per-op
    kernels (the soft threshold takes the output's): A shared (the FFT and
    'ps' combiners) or per realization (the pipeline's), B per realization."""
    return (
        ("approximate front end (Kd 16, M 70)", (32, 32), (B, 32, 70), (B, 16, 70)),
        *((f"rate T={T} (Kd 32, M {8 * T})", (B, 32, 32), (B, 32, 8 * T), (B, 32, 8 * T)) for T in (5, 10, 15)),
        ("Z vs Y (Kd 64, M 80)", (32, 32), (B, 32, 80), (B, 64, 80)),
        ("ADMM iterations (Kd 16, M 40)", (32, 32), (B, 32, 40), (B, 16, 40)),
    )


def _special_recipes(root, dev, card, cli, dict_correlation, dict_correlation_plain, dictionary,
                     fused_soft_threshold, fused_soft_threshold_plain) -> dict:
    """Phase 15; returns the two kernels' launches on the recipes' runs and
    their largest error against the plain versions."""
    import time

    from jstsp19_torch.bench import device_ms
    from jstsp19_torch.core import prng
    from jstsp19_torch.harness import experiments

    g = torch.Generator(device=dev).manual_seed(15)
    dict_err = soft_err = 0.0
    for what, a_shape, k_shape, b_shape in _special_shapes(B_MAIN):
        A_, K_, B_ = (torch.randn(*sh, generator=g, device=dev, dtype=torch.complex64)
                      for sh in (a_shape, k_shape, b_shape))
        out_k, ref = dict_correlation(A_, K_, B_), dict_correlation_plain(A_, K_, B_)
        torch.cuda.synchronize()
        err, scale = float((out_k - ref).abs().max()), float(ref.abs().max())
        dict_err = max(dict_err, err)
        plan = dictionary.plan(k_shape[-2], k_shape[-1], a_shape[-1], b_shape[-2])
        v = (ref * 0.3 / scale).contiguous()  # the einsum may leave ref strided
        tau = torch.rand(B_MAIN, 1, 1, generator=g, device=dev) * 0.2
        s_err = float((fused_soft_threshold(v, tau) - fused_soft_threshold_plain(v, tau)).abs().max())
        soft_err = max(soft_err, s_err)
        print(f"[15] {what}: dict_correlation K {k_shape}, A {a_shape}, B {b_shape}: max|d|={err:.3e} <= "
              f"1e-5*max|ref|={1e-5 * scale:.3e}: {err <= 1e-5 * scale} (plan {plan.rpb} a block, tk {plan.tk}, "
              f"tiles of {plan.mt}, {plan.smem_bytes} B shared); soft_threshold v {tuple(v.shape)}, a tau per "
              f"matrix: max|d|={s_err:.3e} <= 1e-6: {s_err <= 1e-6}")
        if not (err <= 1e-5 * scale and s_err <= 1e-6):
            raise SystemExit(f"[15] {what}: a kernel disagrees with its plain version")
        N, M, Gr, Kd = k_shape[-2], k_shape[-1], a_shape[-1], b_shape[-2]
        d_bound = _bound(_nbytes(A_, K_, B_, ref), 8.0 * B_MAIN * (N * M * Kd + Gr * N * Kd))
        s_bound = _bound(_nbytes(v, tau, v), 6.0 * v.numel())
        d_ms, _ = device_ms(lambda: dict_correlation(A_, K_, B_), match="dict_correlation")
        s_ms, _ = device_ms(lambda: fused_soft_threshold(v, tau), match="soft_threshold")
        print(f"[15]   device a call: dict_correlation {d_ms * 1e3:.2f} us (bound {d_bound[0] * 1e3:.3f} us, "
              f"{d_bound[1]}, {100 * d_bound[0] / d_ms:.1f}% of it), soft_threshold {s_ms * 1e3:.2f} us (bound "
              f"{s_bound[0] * 1e3:.3f} us, {s_bound[1]}) (card: {card})")

    reference = json.loads((root / "results" / "torch_specialized_jax.json").read_text())["recipes"]
    launches = {"dict_correlation": 0, "soft_threshold": 0}
    worst_all = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        runs = [(name, n_mc, 0) for name, n_mc in SPECIAL_RECIPES]
        runs += [(name, 1, seed) for name in SINGLE_CHANNEL for seed in range(SINGLE_SEEDS)]
        single = {name: [] for name in SINGLE_CHANNEL}
        for name, n_mc, seed in runs:
            out_dir = pathlib.Path(tmp) / f"{name}.{seed}"
            dict_correlation.launches = 0
            fused_soft_threshold.launches = 0
            kept = {}
            recipe = experiments.EXPERIMENTS[name]
            # the CLI calls the registry's recipe: keep its SweepResult, whose
            # per-point sd the JSON (the JAX schema) leaves out
            experiments.EXPERIMENTS[name] = lambda **kw: kept.setdefault("res", recipe(**kw))
            t0 = time.time()
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = cli.main(["run", name, "--n-mc", str(n_mc), "--seed", str(seed), "--no-plot",
                                   "--out", str(out_dir)])
                torch.cuda.synchronize()
            finally:
                experiments.EXPERIMENTS[name] = recipe
            wall = time.time() - t0
            n_dict, n_soft = dict_correlation.launches, fused_soft_threshold.launches
            launches["dict_correlation"] += n_dict
            launches["soft_threshold"] += n_soft
            if rc != 0:
                raise SystemExit(f"[15] {name}: the CLI exited {rc}")
            got = json.loads((out_dir / f"{name}.json").read_text())
            art = json.loads((root / "results" / f"{name}.json").read_text())
            schema = (set(got) == set(art) and got["sweep"] == art["sweep"]
                      and set(got["curves"]) == set(art["curves"]) == set(reference[name]["curves"]))
            finite = all(math.isfinite(x) for c in got["curves"].values() for x in c)
            if not (schema and finite):
                raise SystemExit(f"[15] {name}: the JSON lacks the JAX artifact's schema or holds a non-finite value")
            if name in SINGLE_CHANNEL:
                single[name].append((got["curves"], wall))
                continue
            worst, where = 0.0, ""
            for m, curve in got["curves"].items():
                ref = reference[name]["curves"][m]
                floor = _resolution(name, ref["mean"])
                for i, x in enumerate(curve):
                    sd = kept["res"].sd[m][i]
                    se = math.sqrt(ref["sd"][i] ** 2 / ref["n"][i] + sd**2 / n_mc + floor**2)
                    z = (x - ref["mean"][i]) / se if se > 0 else (0.0 if x == ref["mean"][i] else math.inf)
                    if abs(z) >= abs(worst):
                        worst, where = z, f"{m}[{i}]"
            worst_all = max(worst_all, abs(worst))
            kernels_ok = name not in SPECIAL_ADMM or (n_dict > 0 and n_soft > 0)
            print(f"[15] {name}: n_mc {n_mc}, wall {wall:.3f} s (card: {card}); launches dict_correlation {n_dict}, "
                  f"soft_threshold {n_soft}; schema of results/{name}.json; largest |z| against the JAX reference "
                  f"(n {reference[name]['n_mc']}) {abs(worst):.2f} at {where}: within 4 SE: {abs(worst) <= 4}")
            if abs(worst) > 4:
                raise SystemExit(f"[15] {name}: {where} outside 4 SE of the JAX reference")
            if not kernels_ok:
                raise SystemExit(f"[15] {name}: the ADMM recipe did not go through both kernels")
        for name, runs in single.items():
            curves = [c for c, _ in runs]
            worst, where = 0.0, ""
            for m in curves[0]:
                v = np.asarray([c[m] for c in curves])
                ref = reference[name]["curves"][m]
                se = np.sqrt(v.var(axis=0, ddof=1) / len(v) + np.asarray(ref["sd"]) ** 2 / np.asarray(ref["n"]))
                z = (v.mean(axis=0) - np.asarray(ref["mean"])) / se
                i = int(np.argmax(np.abs(z)))
                if abs(z[i]) >= abs(worst):
                    worst, where = float(z[i]), f"{m}[{i}]"
            worst_all = max(worst_all, abs(worst))
            print(f"[15] {name}: seeds 0-{SINGLE_SEEDS - 1}, one channel each, wall {sum(w for _, w in runs):.3f} s in "
                  f"all (card: {card}); largest |z| against the JAX "
                  f"reference over {reference[name]['seeds']} seeds {abs(worst):.2f} at {where}: within 4 SE: "
                  f"{abs(worst) <= 4}")
            if abs(worst) > 4:
                raise SystemExit(f"[15] {name}: {where} outside 4 SE of the JAX reference")
    print(f"[15] launches on the recipes: dict_correlation {launches['dict_correlation']}, soft_threshold "
          f"{launches['soft_threshold']}; largest |z| {worst_all:.2f}")

    # the approximate front end's 0 dB point with the kernels on and off
    nv0, i0 = 1.0, 3  # snr_db -15:5:15, index 3 is 0 dB
    errs = [experiments._approx_realization(prng.realization_generators(0, i0, dev), nv0, B_MAIN, T=70,
                                            sub_ratio=0.75, Imax=50, mode="approximate", use_kernels=flag)
            for flag in (True, False)]
    ok = bool(torch.allclose(errs[0], errs[1], rtol=2e-3, atol=2e-4))
    print(f"[15] approximate front end 0 dB, Imax=50, B={B_MAIN}: mean NMSE kernels on {float(errs[0].mean()):.6f}, "
          f"off {float(errs[1].mean()):.6f}; max per-realization |dNMSE| = "
          f"{float((errs[0] - errs[1]).abs().max()):.3e}; within rtol 2e-3, atol 2e-4: {ok}")
    if not ok:
        raise SystemExit("[15] kernels on and off disagree at the approximate front end's 0 dB point")
    return dict(launches, dict_err=dict_err, soft_err=soft_err)


def _families(root, dev, card, cli, counters) -> dict:
    """Phase 16; returns {kernel name: {path: launches}} of this slice's
    paths. ``counters``: {kernel name: its wrapper}, whose ``launches`` each
    path sets to 0 just before it runs and reads just after."""
    import time

    from jstsp19_torch import bench_all
    from jstsp19_torch.core import prng
    from jstsp19_torch.core.metrics import clamped_nmse
    from jstsp19_torch.harness.pipeline import PointConfig, proposed_problem
    from jstsp19_torch.solvers.admm import proposed_admm

    ref = json.loads((root / "results" / "torch_families_jax.json").read_text())
    by_path = {name: {} for name in counters}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def read(path):
        for name, fn in counters.items():
            by_path[name][path] = fn.launches

    # (a) the three families through the CLI
    snr = ref["error_vs_snr"]["sweep"]["snr_db"]
    with tempfile.TemporaryDirectory() as tmp:
        tee = _Tee()
        with contextlib.redirect_stdout(tee):
            rc = cli.main(["run", "error_vs_snr", "--methods", "omp_td,svt,tssr", "--n-mc", str(B_MAIN),
                           "--no-plot", "--out", tmp])
        torch.cuda.synchronize()
        if rc != 0:
            raise SystemExit(f"[16] error_vs_snr: the CLI exited {rc}")
        res = json.loads((pathlib.Path(tmp) / "error_vs_snr.json").read_text())
    walls = dict(re.findall(r"snr_db=(-?\d+): .* \[([0-9.]+) s\]", tee.getvalue()))
    print(f"[16] error_vs_snr omp_td,svt,tssr n_mc {B_MAIN}: wall per point "
          + ", ".join(f"{s_:g} dB {float(walls[str(int(s_))]):.3f} s" for s_ in snr) + f" (card: {card})")
    if res["sweep"]["snr_db"] != snr or set(res["curves"]) != set(ref["error_vs_snr"]["curves"]):
        raise SystemExit("[16] error_vs_snr: the JSON does not hold the reference's sweep and methods")
    worst = 0.0
    for m, r in ref["error_vs_snr"]["curves"].items():
        zs = []
        for i in range(len(snr)):
            mean, sd, n = _stats(res["raw"][m][i])
            se = math.sqrt(r["sd"][i] ** 2 / r["n"][i] + sd**2 / n)
            val = res["curves"][m][i]
            z = (mean - r["mean"][i]) / se
            zs.append(z)
            if not (math.isfinite(val) and 0.0 <= val <= 1.0 and all(0.0 <= x <= 1.0 for x in res["raw"][m][i])
                    and abs(z) <= 4):
                raise SystemExit(f"[16] {m} at {snr[i]} dB: outside [0, 1] or 4 SE of the JAX reference "
                                 f"(mean {mean:.6f}, JAX {r['mean'][i]:.6f}, z {z:+.2f})")
        worst = max(worst, max(abs(z) for z in zs))
        print(f"[16] {m}: means {[round(x, 4) for x in res['curves'][m]]} vs JAX "
              f"{[round(x, 4) for x in r['mean']]} (n {r['n'][0]}); z {[round(z, 2) for z in zs]}: all within 4 SE")

    # (b) the mc_admm family
    t0 = time.time()
    e = bench_all.mc_admm_errors(prng.realization_generators(0, 0, dev), NOISE_VAR, B_MAIN)
    torch.cuda.synchronize()
    wall = time.time() - t0
    r = ref["mc_admm"]
    mean, sd, n = _stats(e.double().cpu().tolist())
    z = (mean - r["mean"]) / math.sqrt(r["sd"] ** 2 / r["n"] + sd**2 / n)
    ok = bool(torch.isfinite(e).all()) and float(e.min()) >= 0.0 and float(e.max()) <= 1.0 and abs(z) <= 4
    print(f"[16] mc_admm 0 dB, B={B_MAIN}: mean {mean:.6f} (sd {sd:.4f}) vs JAX {r['mean']:.6f} (sd {r['sd']:.4f}, "
          f"n {r['n']}): z {z:+.2f}, in [0, 1] and within 4 SE: {ok}; wall {wall:.3f} s (card: {card})")
    if not ok:
        raise SystemExit("[16] mc_admm outside [0, 1] or 4 SE of the JAX reference")

    # (c) the proposed ADMM on the Jacobi eigensolver
    pc = PointConfig(methods=("proposed",))
    prob = proposed_problem(prng.realization_generators(0, 0, dev), pc, NOISE_VAR, B_MAIN)
    args = [prob[k] for k in ("subY", "Omega", "A", "B")]
    hp = [prob[k] for k in ("tau_Y", "tau_S", "rho")]
    reset()
    t0 = time.time()
    S_j = proposed_admm(*args, IMAX_MAIN, *hp, svt_method="jacobi").S
    torch.cuda.synchronize()
    wall = time.time() - t0
    read("proposed_admm svt_method='jacobi'")
    t0 = time.time()
    S_e = proposed_admm(*args, IMAX_MAIN, *hp, svt_method="eigh").S
    torch.cuda.synchronize()
    wall_e = time.time() - t0
    e_j, e_e = clamped_nmse(S_j, prob["Zbar"]), clamped_nmse(S_e, prob["Zbar"])
    dev_max = float((e_j - e_e).abs().max())
    n_dict = by_path["dict_correlation"]["proposed_admm svt_method='jacobi'"]
    n_soft = by_path["soft_threshold"]["proposed_admm svt_method='jacobi'"]
    ref_mean, ref_sd, ref_n = _reference_0db(root)
    mean, sd, n = _stats(e_j.double().cpu().tolist())
    z = (mean - ref_mean) / math.sqrt(ref_sd**2 / ref_n + sd**2 / n)
    ok = (n_dict >= IMAX_MAIN and n_soft >= IMAX_MAIN and dev_max <= 0.02 and bool(torch.isfinite(e_j).all())
          and abs(z) <= 4)
    print(f"[16] proposed, svt_method='jacobi', B={B_MAIN}, Imax={IMAX_MAIN}: launches dict_correlation {n_dict}, "
          f"soft_threshold {n_soft}; max per-realization |dNMSE| against 'eigh' {dev_max:.3e} <= 0.02; mean "
          f"{mean:.6f} vs results/error_vs_snr.json {ref_mean:.6f} (n {ref_n}): z {z:+.2f}; all held: {ok}; wall "
          f"{wall:.3f} s ('eigh' {wall_e:.3f} s) (card: {card})")
    if not ok:
        raise SystemExit("[16] the Jacobi solve: kernels not launched, or NMSE off 'eigh' or the reference")

    # (d) time_comparisons and bench_all
    with tempfile.TemporaryDirectory() as tmp:
        reset()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["run", "time_comparisons", "--n-mc", "8", "--no-plot", "--out", tmp])
        torch.cuda.synchronize()
        read("time_comparisons")
        if rc != 0:
            raise SystemExit(f"[16] time_comparisons: the CLI exited {rc}")
        tc = json.loads((pathlib.Path(tmp) / "time_comparisons.json").read_text())
        if not all(math.isfinite(v[0]) and v[0] > 0 for v in tc["curves"].values()):
            raise SystemExit("[16] time_comparisons: a time is not finite and positive")
        print(f"[16] time_comparisons (n_mc 8, best of 3 after a warm-up), s a realization: "
              + ", ".join(f"{m} {v[0]:.6f}" for m, v in tc["curves"].items())
              + f"; device {tc['device']}; card {tc.get('card')}")
        reset()
        out = pathlib.Path(tmp) / "bench_all.json"
        rc = bench_all.main(["--batch", str(B_MAIN), "--batches", "1,4,32", "--out", str(out)])
        torch.cuda.synchronize()
        read("bench_all")
        if rc != 0:
            raise SystemExit(f"[16] bench_all exited {rc}")
        rows = json.loads(out.read_text())["methods"]
    if set(rows) != set(bench_all.METHODS) or not all(
            0.0 <= row["mean_nmse_0db"] <= 1.0 and row["est_per_sec"] > 0 for row in rows.values()):
        raise SystemExit("[16] bench_all: a family is missing, or its NMSE or rate is out of range")
    for path in ("time_comparisons", "bench_all"):
        print(f"[16] launches on {path}: " + ", ".join(f"{k} {v[path]}" for k, v in by_path.items()))
    if by_path["fused_tracked_admm"]["bench_all"] < 1 or by_path["dict_correlation"]["bench_all"] < 1:
        raise SystemExit("[16] bench_all's proposed and vamp families did not go through their kernels")
    return by_path


def _subprocess(args, timeout: float) -> str:
    """Run ``python <args>`` from the checkout, echo its output, and raise on
    a non-zero exit."""
    import subprocess

    root = pathlib.Path(__file__).resolve().parent
    proc = subprocess.run([sys.executable, *args], cwd=root, capture_output=True, text=True, timeout=timeout)
    out = "".join(ln + "\n" for ln in (proc.stdout + proc.stderr).splitlines() if "hostname of the client" not in ln)
    sys.stdout.write(out)
    if proc.returncode != 0:
        raise SystemExit(f"[17] python {' '.join(args)} exited {proc.returncode}")
    return out


def _rank_launches(out: str) -> list:
    """Each process's {kernel: launches} from the lines the ranks (and the
    precision tool) print."""
    return [{k: int(v) for k, v in re.findall(r"(fused_tracked_admm|dict_correlation|soft_threshold|fwht) (\d+)", ln)}
            for ln in out.splitlines() if re.match(r"\[(rank|dist worker) \d+\].* launches|\[precision\] wrote", ln)]


def _distributed(root, dev, card, cli, nrf_res, nrf_times, counters) -> dict:
    """Phase 17; returns {kernel name: {path: launches}} of this slice's
    paths (the ranks' counts summed over the ranks).  ``counters`` as in
    :func:`_families`."""
    from jstsp19_torch.harness.pipeline import PointConfig
    from jstsp19_torch.harness.runner import run_point

    by_path = {name: {} for name in counters}

    def add(path, ranks):
        for name in counters:
            by_path[name][path] = sum(r.get(name, 0) for r in ranks)

    def close(a, b) -> bool:
        return bool(np.allclose(np.asarray(a), np.asarray(b), rtol=2e-3, atol=2e-4))

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        # (a) the precision protocol of the tracked chain
        out = _subprocess(["tools/torch_precision_shapes.py", "--n-mc", str(B_MAIN), "--out", str(tmp / "prec.json")],
                          900)
        add("precision protocol [17a]", _rank_launches(out))
        prec = json.loads((tmp / "prec.json").read_text())
        dec = prec["decision"]
        keeps = "keeps one TF32 pass" if dec["default_keeps_tf32"] else "runs float32"
        moved = dec["max_abs_diff_tf32_vs_highest"]
        print(f"[17a] decision in this run: 'default' {keeps}; the port ships 'default' -> {dec['shipped']!r}; "
              f"one TF32 pass against 'highest': max per-realization |dNMSE| {moved:.3e} (TF32 "
              f"{'changed' if moved > 0 else 'did not change'} a result); the shipped 'default' is 'highest' "
              f"on the card: {dec['shipped'] == 'fp32'} (card: {card})")

        # (b) the errorVSnrf sweep over 2 ranks sharing the card
        out = _subprocess(["-m", "jstsp19_torch", "run", "error_vs_nrf", "--distributed", "2", "--n-mc", str(B_MAIN),
                           "--no-plot", "--out", str(tmp / "nrf")], 900)
        ranks = _rank_launches(out)
        backends = re.findall(r"\[rank (\d+)\] backend (\w+), device (\S+?)[;\s]", out)
        print(f"[17b] ranks: " + ", ".join(f"rank {r} {b} on {d}" for r, b, d in dict.fromkeys(backends))
              + f"; launches by rank {ranks}")
        if len(ranks) != 2 or not all(r["dict_correlation"] > 0 and r["soft_threshold"] > 0 for r in ranks):
            raise SystemExit("[17b] a rank did not launch both per-op kernels")
        add("error_vs_nrf --distributed 2 [17b]", ranks)
        res = json.loads((tmp / "nrf" / "error_vs_nrf.json").read_text())
        walls = dict(re.findall(r"Mr=(\d+): .* \[([0-9.]+) s\]", out))
        worst = 0.0
        for m in sorted(nrf_res["raw"]):
            for i, mr in enumerate(NRF_MR):
                a, b = np.asarray(res["raw"][m][i]), np.asarray(nrf_res["raw"][m][i])
                worst = max(worst, float(np.abs(a - b).max()))
                if a.shape != b.shape or not close(a, b):
                    raise SystemExit(f"[17b] {m} at Mr={mr}: the 2-rank run differs from phase [7]'s "
                                     f"(max|d| {float(np.abs(a - b).max()):.3e})")
        print(f"[17b] every method at every Mr equals phase [7]'s single-process run per realization within "
              f"rtol 2e-3, atol 2e-4 (max|dNMSE| {worst:.3e}); wall per point, 2 ranks vs one process: "
              + ", ".join(f"Mr={mr} {float(walls[str(mr)]):.3f} s vs {float(nrf_times[str(mr)]):.3f} s"
                          for mr in NRF_MR)
              + f" (card: {card})")

        # (c) a distributed fused point
        out = _subprocess(["-m", "jstsp19_torch.parallel.launch", "-n", "2", "--timeout", "600", "--",
                           "-m", "jstsp19_torch.parallel.distributed", "--methods", "proposed,proposed_angles",
                           "--svt-method", "fused", "--imax", str(IMAX_MAIN), "--n-mc", str(B_MAIN),
                           "--noise-vars", str(NOISE_VAR), "--out", str(tmp / "fused.json")], 900)
        ranks = _rank_launches(out)
        if len(ranks) != 2 or not all(r["fused_tracked_admm"] > 0 for r in ranks):
            raise SystemExit("[17c] a rank did not launch the fused ADMM kernel")
        add("distributed fused point [17c]", ranks)
        res = json.loads((tmp / "fused.json").read_text())
        pc = PointConfig(methods=("proposed", "proposed_angles"), svt_method="fused")
        ref = run_point(pc, NOISE_VAR, B_MAIN, seed=0, sweep_index=0, device=dev)
        for m in pc.methods:
            a = np.asarray(res["raw"][m][0])
            if not close(a, ref[m]):
                raise SystemExit(f"[17c] {m}: the 2-rank fused point differs from run_point")
            print(f"[17c] {m}: 2 ranks, fused route, B={B_MAIN}: mean {a.mean():.6f} vs run_point "
                  f"{float(ref[m].mean()):.6f}, max per-realization |dNMSE| {float(np.abs(a - ref[m]).max()):.3e} "
                  f"within rtol 2e-3, atol 2e-4; point {res['point_seconds'][0]:.3f} s; launches by rank {ranks}")

        # (d) the dryrun: 1 rank on NCCL, 2 ranks on gloo sharing the card
        for n, backend in ((1, "nccl"), (2, "gloo")):
            out = _subprocess(["-m", "jstsp19_torch.parallel.dryrun", str(n), "--timeout", "300"], 600)
            line = next(ln for ln in out.splitlines() if ln.startswith("dryrun "))
            max_ds = float(line.split("max|dS|=")[1].split()[0])
            tol = float(line.split("(tolerance ")[1].split()[0])
            ranks = _rank_launches(out)
            taken = set(re.findall(r"backend (\w+), device", out))
            ok = (line.startswith("dryrun ok") and max_ds <= tol and taken == {backend} and len(ranks) == n
                  and all(r["soft_threshold"] > 0 for r in ranks))
            print(f"[17d] dryrun {n} rank(s), backend {sorted(taken)}: max|dS| {max_ds:.3e} <= {tol:.3e}; "
                  f"soft_threshold launches by rank {[r['soft_threshold'] for r in ranks]}; held: {ok}")
            if not ok:
                raise SystemExit(f"[17d] the dryrun over {n} rank(s) failed its check")
            add(f"dryrun {n} rank(s) [17d]", ranks)

        # (e) panel, in-process
        for fn in counters.values():
            fn.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["panel", "--batch", "--n-mc", "16", "--set", "methods=ls,proposed"])
        for name, fn in counters.items():
            by_path[name]["panel [17e]"] = fn.launches
        means = {ln.split()[0]: float(ln.split("mean NMSE ")[1].split()[0]) for ln in buf.getvalue().splitlines()
                 if "mean NMSE" in ln}
        ref = run_point(PointConfig(methods=("ls", "proposed")), NOISE_VAR, 16, device=dev)
        want = {m: float(np.mean(v)) for m, v in ref.items()}
        print(f"[17e] panel --batch --n-mc 16 --set methods=ls,proposed: means {means}, run_point {want}; "
              f"equal: {means == want}")
        if rc != 0 or means != want:
            raise SystemExit("[17e] panel's means differ from run_point's")

        # (f) the orbax (npz) checkpoint round trip, in-process
        from jstsp19_torch.harness.runner import set_default_checkpoint

        args = ["run", "error_vs_nrf", "--n-mc", "32", "--no-plot", "--checkpoint-dir", str(tmp / "ck"),
                "--checkpoint-backend", "orbax"]
        for fn in counters.values():
            fn.launches = 0
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                rcs = [cli.main(args + ["--out", str(tmp / o)]) for o in ("a", "b")]
        finally:
            set_default_checkpoint(None)
        for name, fn in counters.items():
            by_path[name]["npz checkpoint round trip [17f]"] = fn.launches
        first, second = (json.loads((tmp / o / "error_vs_nrf.json").read_text()) for o in ("a", "b"))
        n_ckpt = len(list((tmp / "ck").glob("error_vs_nrf.Mr.*.npz")))
        ok = rcs == [0, 0] and n_ckpt == len(NRF_MR) and second["curves"] == first["curves"] and "raw" not in second
        print(f"[17f] run error_vs_nrf --checkpoint-backend orbax, then resumed from {n_ckpt} .npz checkpoints: "
              f"means bit-equal: {second['curves'] == first['curves']}; held: {ok}")
        if not ok:
            raise SystemExit("[17f] the npz checkpoint resume did not give the same means")
    return by_path


class _Tee(io.StringIO):
    """Keeps what is printed and passes it on to the real stdout."""

    def write(self, s):
        sys.__stdout__.write(s)
        return super().write(s)


def _mean_removal(root, dev, card, prob_cs, routes) -> int:
    """Phase 18; returns the FWHT launches of the mean-removal solve."""
    from jstsp19_torch.bench import REPS, cuda_event_times
    from jstsp19_torch.harness import hadamard_cs as hcs
    from jstsp19_torch.harness.estim_check import compare_devices, estimator_cases
    from jstsp19_torch.kernels.wht import fwht_kernel
    from jstsp19_torch.solvers.gamp_full import GampOptions, gamp_est

    def solve(flag, remove_mean=True):
        prior, like, op = routes[flag]
        fin, _, _ = gamp_est(prior, like, op, GampOptions(remove_mean=remove_mean))
        return fin.xhat, int(fin.nit.max())

    # (a) the solve through the kernel, against the kernel off and JAX
    fwht_kernel.launches = 0
    xhat, its = solve(True)
    torch.cuda.synchronize()
    launches = fwht_kernel.launches
    need = 6 * its + 2
    print(f"[18a] gamp_est(remove_mean=True): fwht_kernel launches = {launches} over {its} iterations "
          f"(need >= 6 x {its} + 2 = {need})")
    if launches < need:
        raise SystemExit("[18a] mean removal did not go through the FWHT kernel")
    xhat_off, its_off = solve(False)
    e_on = hcs.nmse_db(xhat.cpu().numpy(), prob_cs["x"])
    e_off = hcs.nmse_db(xhat_off.cpu().numpy(), prob_cs["x"])
    lin_on, lin_off = 10 ** (e_on / 10), 10 ** (e_off / 10)
    rel = float(np.max(np.abs(lin_on - lin_off) / lin_off))
    ok = bool(np.all(np.isfinite(e_on)) and rel <= 0.01)
    print(f"[18a] NMSE kernel on {e_on.mean():.4f} dB ({its} iterations), off {e_off.mean():.4f} dB ({its_off}); "
          f"max per-realization relative |dNMSE| = {rel:.3e}; finite and within 1%: {ok}")
    if not ok:
        raise SystemExit("[18a] NMSE not finite or kernel on and off disagree")
    r = json.loads((root / "results" / "torch_gamp_demean_jax.json").read_text())["gamp_est"]
    mean, sd, n = float(e_on.mean()), float(e_on.std(ddof=1)), e_on.size
    se = math.sqrt(r["sd_db"] ** 2 / len(r["nmse_db"]) + sd**2 / n)
    inside = abs(mean - r["mean_db"]) <= 4 * se
    worst = float(np.max(np.abs(e_on - np.asarray(r["nmse_db"]))))
    print(f"[18a] batch mean {mean:.4f} dB (sd {sd:.4f}, n {n}) vs JAX {r['mean_db']:.4f} dB (sd {r['sd_db']:.4f}, "
          f"{min(r['nit'])}-{max(r['nit'])} iterations): z {(mean - r['mean_db']) / se:+.2f}, within 4 SE: "
          f"{inside}; largest per-realization |d dB| against JAX {worst:.4f}")
    if not inside:
        raise SystemExit("[18a] batch mean NMSE outside 4 SE of the JAX reference")

    # (b) the cost of mean removal: both solves, the kernel on and off in turns
    for label, flag in (("kernel on", True), ("kernel off", False), ("kernel on", True), ("kernel off", False)):
        for rm in (False, True):
            t, outs = cuda_event_times(lambda _: solve(flag, rm), REPS)
            best, median = min(t), sorted(t)[len(t) // 2]
            print(f"[18b] gamp_est {'GampOptions(remove_mean=True)' if rm else 'GampOptions()'} "
                  f"({outs[0][1]} iterations), {label}: best {best * 1e3:.3f} ms, median {median * 1e3:.3f} ms, "
                  f"spread {(max(t) - best) * 1e3:.3f} ms over {REPS} reps (card: {card})")

    # (c) the 45 estimators on the card against the CPU
    misses = []
    for case in estimator_cases(hcs.BATCH, hcs.N):
        c = compare_devices(case, dev)
        print(f"[18c] {c.name}: {'/'.join(c.hooks)}: max|d| {c.max_abs_err:.3e} <= {c.tol:g}*max|ref| "
              f"{c.tol * c.scale:.3e}: {c.ok}")
        if not c.ok:
            misses.append(c.name)
    if misses:
        raise SystemExit(f"[18c] the card and the CPU disagree: {misses}")
    print(f"[18c] all 45 estimators agree between the card and the CPU at (32, 65536) (card: {card})")
    return launches


def _nmse_gate(phase: str, what: str, e_db: np.ndarray, ref: dict) -> None:
    """Print the batch mean NMSE (dB) beside the JAX reference's and stop the
    run unless it lies within 4 combined standard errors."""
    mean, sd, n = float(e_db.mean()), float(e_db.std(ddof=1)), e_db.size
    se = math.sqrt(ref["sd_db"] ** 2 / ref["n"] + sd**2 / n)
    inside = abs(mean - ref["mean_db"]) <= 4 * se
    print(f"{phase} {what}: batch mean {mean:.4f} dB (sd {sd:.4f}, n {n}) vs JAX {ref['mean_db']:.4f} dB "
          f"(sd {ref['sd_db']:.4f}, n {ref['n']}): z {(mean - ref['mean_db']) / se:+.2f}, within 4 SE: {inside}")
    if not inside:
        raise SystemExit(f"{phase} {what}: batch mean NMSE outside 4 SE of the JAX reference")


def _timed(phase: str, what: str, fn, card: str, reps: int = 5) -> None:
    """Best, median and spread of ``reps`` CUDA-event timings of ``fn()``."""
    from jstsp19_torch.bench import cuda_event_times

    t, _ = cuda_event_times(lambda _: fn(), reps)
    best, median = min(t), sorted(t)[len(t) // 2]
    print(f"{phase} {what}: best {best * 1e3:.3f} ms, median {median * 1e3:.3f} ms, spread "
          f"{(max(t) - best) * 1e3:.3f} ms over {reps} reps (card: {card})")


def _amp_sparse(root, dev, card, prob_cs) -> dict:
    """Phase 19; returns {kernel: {path: launches}} and each per-op kernel's
    largest |Δ| against its plain version at the slice's shapes."""
    from jstsp19_torch.bench import device_ms
    from jstsp19_torch.core import prng
    from jstsp19_torch.harness import amp_sparse as aps
    from jstsp19_torch.harness import op_check
    from jstsp19_torch.kernels import dictionary
    from jstsp19_torch.kernels.dictionary import dict_correlation, dict_correlation_plain
    from jstsp19_torch.kernels.softthresh import fused_soft_threshold, fused_soft_threshold_plain
    from jstsp19_torch.kernels.wht import fwht_kernel
    from jstsp19_torch.ops.base import MatrixOp
    from jstsp19_torch.ops.kron import KronDictOp
    from jstsp19_torch.solvers.gamp import amp_est
    from jstsp19_torch.solvers.sparse import sparse_admm
    from jstsp19_torch.solvers.vamp_slm import vamp_slm, vamp_slm_se

    ref = json.loads((root / "results" / "torch_amp_sparse_jax.json").read_text())
    paths = {"fwht": {}, "dict_correlation": {}, "soft_threshold": {}}

    # (a) amp_est on the partial-Hadamard problems, 'mean' and 'median'
    routes = {flag: aps.hadamard_amp_torch(prob_cs, dev, use_kernel=flag) for flag in (True, False)}
    for method in ("mean", "median"):
        def solve(flag):
            y, op, prior, _ = routes[flag]
            return amp_est(y, op, prior, nit=aps.AMP_NIT, rvar_method=method, damp=aps.AMP_DAMP)

        fwht_kernel.launches = 0
        x_on = solve(True)
        torch.cuda.synchronize()
        launches = fwht_kernel.launches
        paths["fwht"][f"amp_est {method} [19a]"] = launches
        print(f"[19a] amp_est rvar_method={method!r} (B, n = {prob_cs['x'].shape}, nit {aps.AMP_NIT}, damp "
              f"{aps.AMP_DAMP}): fwht_kernel launches = {launches} (need exactly 2 x {aps.AMP_NIT})")
        if launches != 2 * aps.AMP_NIT:
            raise SystemExit("[19a] amp_est did not launch the FWHT kernel twice an iteration")
        e_on = aps.nmse_db(x_on.cpu().numpy(), prob_cs["x"])
        e_off = aps.nmse_db(solve(False).cpu().numpy(), prob_cs["x"])
        rel = float(np.max(np.abs(10 ** (e_on / 10) - 10 ** (e_off / 10)) / 10 ** (e_off / 10)))
        ok = bool(np.all(np.isfinite(e_on)) and rel <= 0.01)
        print(f"[19a] {method}: NMSE kernel on {e_on.mean():.4f} dB, off {e_off.mean():.4f} dB; max per-realization "
              f"relative |dNMSE| = {rel:.3e}; finite and within 1%: {ok}")
        if not ok:
            raise SystemExit("[19a] NMSE not finite or kernel on and off disagree")
        _nmse_gate("[19a]", f"amp_est {method}", e_on, ref[f"amp_est_{method}"])
        for label, flag in (("kernel on", True), ("kernel off", False), ("kernel on", True), ("kernel off", False)):
            _timed("[19a]", f"amp_est {method}, {label}", lambda: solve(flag), card)

    # (a') S-AMP on the condition-10 log-spectrum ensemble
    sp = aps.spectrum_problems()
    y, A, ev = (torch.from_numpy(sp[k]).to(dev) for k in ("y", "A", "evals"))

    def s_amp(nit):
        return amp_est(y, MatrixOp(A), aps.spectrum_prior(), nit=nit, wvar=aps.SPEC_WVAR, evals_aah=ev,
                       damp=aps.SAMP_DAMP)

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    xs = s_amp(aps.SAMP_NIT)
    end.record()
    torch.cuda.synchronize()
    seconds = start.elapsed_time(end) / 1e3
    lin = ((xs.cpu().numpy().astype(np.float64) - sp["x"]) ** 2).sum(-1) / (sp["x"] ** 2).sum(-1)
    counts = [device_ms(lambda: s_amp(k), calls=1, match="")[1] for k in (2, 3)]
    print(f"[19a'] S-AMP (B={len(sp['y'])}, n {aps.SPEC_N}, m {aps.SPEC_M}, condition {aps.SPEC_COND:g}, nit "
          f"{aps.SAMP_NIT}, damp {aps.SAMP_DAMP}): {seconds:.3f} s, {1e3 * seconds / aps.SAMP_NIT:.3f} ms an iteration; "
          f"{counts[1] - counts[0]:.0f} device kernels an iteration (55 s_transform bisections of 60 steps) "
          f"(card: {card})")
    print(f"[19a'] S-AMP NMSE per realization: max {lin.max():.3e} (every one < 1e-3: {bool((lin < 1e-3).all())})")
    if not (lin < 1e-3).all():
        raise SystemExit("[19a'] an S-AMP realization did not reach NMSE < 1e-3")
    _nmse_gate("[19a']", "S-AMP", 10 * np.log10(lin), ref["s_amp"])

    # (b) sparse_admm at the canonical point's shapes: the kernels against
    # their plain versions there, then the solve
    bp = aps.to_device(aps.beamspace_problem(), dev)
    g = torch.Generator(device=dev).manual_seed(19)
    errs = {"dict_correlation": 0.0, "soft_threshold": 0.0}
    vp = aps.to_device(aps.vamp_slm_problem(), dev)
    for what, A_, K_, B_ in (
            ("sparse_admm, A^H OH Dt", bp["Dr"], bp["OH"], bp["Dt"].mH.contiguous()),
            ("sparse_admm's solve, Ur^H K Ut (a unitary A)", bp["Dr"] / math.sqrt(32),
             torch.randn(aps.ADMM_BATCH, 32, 4, generator=g, device=dev, dtype=torch.complex64),
             bp["Dt"].mH.contiguous() / 2),
            ("vamp_slm, A^H y B^H", vp["A"], vp["y"], vp["B"])):
        out_k, ref_k = dict_correlation(A_, K_, B_), dict_correlation_plain(A_, K_, B_)
        torch.cuda.synchronize()
        err, scale = float((out_k - ref_k).abs().max()), float(ref_k.abs().max())
        errs["dict_correlation"] = max(errs["dict_correlation"], err)
        N_, M_ = K_.shape[-2:]
        plan = dictionary.plan(N_, M_, A_.shape[-1], B_.shape[-2])
        d_ms, launched = device_ms(lambda: dict_correlation(A_, K_, B_), match="dict_correlation")
        print(f"[19b] dict_correlation {what}: K {tuple(K_.shape)}, A {tuple(A_.shape)}, B {tuple(B_.shape)}: "
              f"max|d|={err:.3e} <= 1e-5*max|ref|={1e-5 * scale:.3e}: {err <= 1e-5 * scale}; plan {plan.rpb} "
              f"realization(s) a block, tk {plan.tk}, tiles of {plan.mt}, {plan.smem_bytes} B shared; device "
              f"{d_ms * 1e3:.2f} us in {launched:.0f} kernel(s) a call (card: {card})")
        if not err <= 1e-5 * scale:
            raise SystemExit("[19b] dict_correlation disagrees with its plain version")
    v = torch.randn(aps.ADMM_BATCH, 32, 4, generator=g, device=dev, dtype=torch.complex64) * 0.02
    out_k, ref_k = fused_soft_threshold(v, aps.ADMM_TAU_S / aps.ADMM_RHO), \
        fused_soft_threshold_plain(v, aps.ADMM_TAU_S / aps.ADMM_RHO)
    torch.cuda.synchronize()
    errs["soft_threshold"] = float((out_k - ref_k).abs().max())
    print(f"[19b] soft_threshold v {tuple(v.shape)}, tau {aps.ADMM_TAU_S / aps.ADMM_RHO:g}: max|d|="
          f"{errs['soft_threshold']:.3e} <= 1e-6: {errs['soft_threshold'] <= 1e-6}")
    if not errs["soft_threshold"] <= 1e-6:
        raise SystemExit("[19b] soft_threshold disagrees with its plain version")

    def admm(flag):
        return sparse_admm(bp["H"], bp["OH"], bp["Dr"], bp["Dt"], aps.ADMM_IMAX, aps.ADMM_RHO, aps.ADMM_TAU_S,
                           use_kernels=flag)

    dict_correlation.launches = fused_soft_threshold.launches = 0
    _, e_on = admm(True)
    torch.cuda.synchronize()
    n_dict, n_soft = dict_correlation.launches, fused_soft_threshold.launches
    paths["dict_correlation"]["sparse_admm [19b]"] = n_dict
    paths["soft_threshold"]["sparse_admm [19b]"] = n_soft
    print(f"[19b] sparse_admm (B={aps.ADMM_BATCH}, 32x4, Imax {aps.ADMM_IMAX}): launches dict_correlation {n_dict} "
          f"(need {aps.ADMM_IMAX + 1}), soft_threshold {n_soft} (need {aps.ADMM_IMAX})")
    if (n_dict, n_soft) != (aps.ADMM_IMAX + 1, aps.ADMM_IMAX):
        raise SystemExit("[19b] sparse_admm did not go through both kernels as often as it should")
    _, e_off = admm(False)
    lin_on, lin_off = e_on[:, -1].cpu().numpy(), e_off[:, -1].cpu().numpy()
    rel = float(np.max(np.abs(lin_on - lin_off) / lin_off))
    ok = bool(np.all(np.isfinite(lin_on)) and rel <= 1e-3)
    print(f"[19b] sparse_admm final NMSE kernels on {10 * np.log10(lin_on).mean():.4f} dB, off "
          f"{10 * np.log10(lin_off).mean():.4f} dB; max per-realization relative |dNMSE| = {rel:.3e}; within 1e-3: {ok}")
    if not ok:
        raise SystemExit("[19b] NMSE not finite or kernels on and off disagree")
    _nmse_gate("[19b]", "sparse_admm", 10 * np.log10(lin_on), ref["sparse_admm"])
    for label, flag in (("kernels on", True), ("kernels off", False), ("kernels on", True), ("kernels off", False)):
        _timed("[19b]", f"sparse_admm, {label}", lambda: admm(flag), card)

    # (c) vamp_slm on the canonical VAMP problem
    op = KronDictOp(vp["A"], vp["B"])
    prior = aps.vamp_slm_prior(vp["beta"])
    gamw = vp["gamw"][:, None, None]
    dict_correlation.launches = 0
    res = vamp_slm(prior, vp["y"], op, gamw, nit=aps.VAMP_NIT, damp=aps.VAMP_DAMP)
    torch.cuda.synchronize()
    paths["dict_correlation"]["vamp_slm [19c]"] = n = dict_correlation.launches
    print(f"[19c] vamp_slm (B={aps.VAMP_BATCH}, nit {aps.VAMP_NIT}, damp {aps.VAMP_DAMP}): dict_correlation "
          f"launches = {n} (need 1)")
    if n != 1:
        raise SystemExit("[19c] vamp_slm did not take A^H y through the kernel once")
    _nmse_gate("[19c]", "vamp_slm", aps.nmse_db(res.x.cpu().numpy(), vp["x"].cpu().numpy()), ref["vamp_slm"])
    _timed("[19c]", "vamp_slm", lambda: vamp_slm(prior, vp["y"], op, gamw, nit=aps.VAMP_NIT, damp=aps.VAMP_DAMP), card)
    beta = float(vp["beta"])

    def sampler(gen, n_):
        act = torch.rand(n_, generator=gen, device=gen.device) < beta
        return torch.where(act, prng.complex_normal(gen, (n_,), var=1 / beta), 0)

    d0 = op.gram_in_eig()[2][0].reshape(-1)
    se = vamp_slm_se(sampler, prior, d0, float(vp["gamw"][0]), nit=aps.VAMP_NIT).cpu().numpy()
    track = res.mse_track[0].cpu().numpy()
    print("[19c] realization 0, E[xvar1] by iteration (mse_track) beside vamp_slm_se's prediction: "
          + ", ".join(f"{i + 1}: {track[i]:.4g} / {se[i]:.4g}" for i in (0, 1, 4, 9, 24, aps.VAMP_NIT - 1)))

    # (d) the card against the CPU: the operators, the state evolutions, the constructors
    fwht_kernel.launches = 0
    misses = []
    for name, factory in op_check.operator_cases():
        c = op_check.compare_operator(name, factory, dev)
        print(f"[19d] {c.name}: max|d| over max|ref| {c.max_rel:.3e} <= {c.tol:g}; adjoint identity "
              f"{c.adjoint_rel:.3e} <= {op_check.ADJ_TOL:g}: {c.ok}")
        if not c.ok:
            misses.append(c.name)
    torch.cuda.synchronize()
    paths["fwht"]["ConcatOp [19d]"] = fwht_kernel.launches
    for c in op_check.compare_state_evolutions(dev):
        print(f"[19d] {c.name} on the same draws: max|d| over max|ref| {c.max_rel:.3e} <= {c.tol:g}: {c.ok}")
        if not c.ok:
            misses.append(c.name)
    for what, (value, ok) in op_check.random_op_structure(dev).items():
        print(f"[19d] {what}: {value}: {ok}")
        if not ok:
            misses.append(what)
    if misses:
        raise SystemExit(f"[19d] the card and the CPU disagree: {misses}")
    return {"paths": paths, "errs": errs}


def _mean_gate(phase: str, what: str, v: np.ndarray, ref: dict) -> None:
    """Print a learned hyperparameter's batch mean beside the JAX reference's
    (``ref``: mean, sd, n) and stop the run unless it lies within 4 combined
    standard errors."""
    mean, sd, n = float(v.mean()), float(v.std(ddof=1)), v.size
    se = math.sqrt(ref["sd"] ** 2 / ref["n"] + sd**2 / n)
    inside = abs(mean - ref["mean"]) <= 4 * se
    print(f"{phase} {what}: batch mean {mean:.5g} (sd {sd:.4g}, n {n}) vs JAX {ref['mean']:.5g} (sd {ref['sd']:.4g}, "
          f"n {ref['n']}): z {(mean - ref['mean']) / max(se, 1e-30):+.2f}, within 4 SE: {inside}")
    if not inside:
        raise SystemExit(f"{phase} {what}: batch mean outside 4 SE of the JAX reference")


def _em_turbo(root, dev, card) -> dict:
    """Phase 20; returns {kernel: {path: launches}}."""
    from jstsp19_torch.harness import amp_sparse as aps
    from jstsp19_torch.harness import em_turbo as et
    from jstsp19_torch.harness import hadamard_cs as hcs
    from jstsp19_torch.kernels.dictionary import dict_correlation, dict_correlation_plain
    from jstsp19_torch.kernels.wht import fwht_kernel
    from jstsp19_torch.ops.base import MatrixOp
    from jstsp19_torch.ops.kron import KronDictOp
    from jstsp19_torch.solvers import em, turbo, turbo_em

    class PlainKronDictOp(KronDictOp):
        """A check only: ``rmv`` through the dictionary correlation's plain version."""

        def rmv(self, Y):
            return dict_correlation_plain(self.A, Y, self.B)

    ref = json.loads((root / "results" / "torch_em_turbo_jax.json").read_text())
    paths = {"dict_correlation": {"em/turbo [20a]": 0, "em/turbo [20b]": 0}, "fwht": {}}
    t0 = time.perf_counter()

    def gated(phase, name, solve, rounds, counter, x_true, nmse_db, path):
        """One solve through the kernel (exactly ``rounds`` launches), one on
        the plain route (per-realization relative |dNMSE| <= 1e-3), the batch
        mean NMSE within 4 SE of JAX's, and 3 timed reps of each route."""
        counter.launches = 0
        res = solve(True)
        torch.cuda.synchronize()
        n = counter.launches
        print(f"{phase} {name}: {counter.__name__} launches = {n} (need exactly {rounds})")
        if n != rounds:
            raise SystemExit(f"{phase} {name} did not go through the kernel once a round")
        kind, path_n = path
        paths[kind][path_n] = paths[kind].get(path_n, 0) + n
        e_on = nmse_db(res.x.cpu().numpy(), x_true)
        e_off = nmse_db(solve(False).x.cpu().numpy(), x_true)
        rel = float(np.max(np.abs(10 ** (e_on / 10) - 10 ** (e_off / 10)) / 10 ** (e_off / 10)))
        ok = bool(np.all(np.isfinite(e_on)) and rel <= 1e-3)
        print(f"{phase} {name}: NMSE kernel on {e_on.mean():.4f} dB, plain route {e_off.mean():.4f} dB; max "
              f"per-realization relative |dNMSE| = {rel:.3e}; finite and within 1e-3: {ok}")
        if not ok:
            raise SystemExit(f"{phase} {name}: NMSE not finite or the kernel and the plain route disagree")
        _nmse_gate(phase, name, e_on, ref[name])
        for label, flag in (("kernel", True), ("plain route", False)):
            _timed(phase, f"{name}, {label}", lambda: solve(flag), card, reps=3)
        return res

    # (a) and (b): the EM and turbo solvers on the canonical VAMP problem
    vp = aps.to_device(aps.vamp_slm_problem(), dev)
    ops = {True: KronDictOp(vp["A"], vp["B"]), False: PlainKronDictOp(vp["A"], vp["B"])}
    x_true, beta, gamw = vp["x"].cpu().numpy(), float(vp["beta"]), vp["gamw"][:, None, None]
    print(f"[20a] the canonical VAMP problem: y {tuple(vp['y'].shape)}, A {tuple(vp['A'].shape)}, "
          f"B {tuple(vp['B'].shape)} (KronDictOp, one pair a realization), 0 dB")
    for name, (kw, rounds) in et.EM_SOLVERS.items():
        res = gated("[20a]", name, lambda flag: getattr(em, name)(vp["y"], ops[flag], **kw), rounds,
                    dict_correlation, x_true, aps.nmse_db, ("dict_correlation", "em/turbo [20a]"))
        _mean_gate("[20a]", f"{name} learned noise_var (dB)", 10 * np.log10(res.noise_var.cpu().numpy().ravel()),
                   ref[name]["params"]["noise_var_db"])
        _mean_gate("[20a]", f"{name} learned p1", res.prior.p1.cpu().numpy().ravel(), ref[name]["params"]["p1"])
    for name, (_, rounds) in et.TURBO_SOLVERS.items():
        args, kw = et.turbo_arguments(name, beta, gamw)
        fn = getattr(turbo, name, None) or getattr(turbo_em, name)
        res = gated("[20b]", name, lambda flag: fn(vp["y"], ops[flag], *args, **kw), rounds, dict_correlation,
                    x_true, aps.nmse_db, ("dict_correlation", "em/turbo [20b]"))
        for p, stats in ref[name]["params"].items():
            _mean_gate("[20b]", f"{name} learned {p}", getattr(res, p).cpu().numpy().ravel(), stats)

    # (c) em_nngm_gamp through the FWHT kernel on the non-negative partial-Hadamard problems
    prob = hcs.hadamard_cs_problem(nonneg=True)
    routes = {flag: hcs.hadamard_cs_torch(prob, dev, use_kernel=flag) for flag in (True, False)}
    kw = et.NNGM_KW
    # 2 transforms a GAMP iteration (op.mv, op.rmv; sq_mv and sq_rmv are means)
    # over n_em + 1 solves, and one op.mv(xhat) an EM round
    need = 2 * kw["nit"] * (kw["n_em"] + 1) + kw["n_em"]
    print(f"[20c] em_nngm_gamp (B, n = {prob['x'].shape}, m {prob['idx'].shape[-1]}, |x| of the Bernoulli-Gaussian "
          f"draw, {hcs.SNR_DB:g} dB; n_em {kw['n_em']}, nit {kw['nit']})")
    res = gated("[20c]", "em_nngm_gamp", lambda flag: em.em_nngm_gamp(routes[flag][1].y, routes[flag][2], **kw),
                need, fwht_kernel, prob["x"], hcs.nmse_db, ("fwht", "em_nngm_gamp [20c]"))
    _mean_gate("[20c]", "em_nngm_gamp learned noise_var (dB)", 10 * np.log10(res.noise_var.cpu().numpy().ravel()),
               ref["em_nngm_gamp"]["params"]["noise_var_db"])
    print(f"[20c] em_nngm_gamp: min x {float(res.x.min()):.3e} (non-negative within 1e-3: "
          f"{float(res.x.min()) > -1e-3})")

    # (d) the 3-D and arbitrary-adjacency MRF supports: the card against the CPU
    adj = torch.from_numpy(et.ring_adjacency())
    cases = (("turbo_mrf3d_vamp", et.clustered_3d_problems(),
              lambda y, A, d: turbo_em.turbo_mrf3d_vamp(y, MatrixOp(A), et.MRF_SLAB_VAR, et.MRF_GAMW,
                                                        shape3d=et.SHAPE3D)),
             ("turbo_mrf_arb_vamp", et.markov_support_problems(),
              lambda y, A, d: turbo_em.turbo_mrf_arb_vamp(y, MatrixOp(A), et.MRF_SLAB_VAR, et.MRF_GAMW, adj.to(d),
                                                          coupling=et.ARB_COUPLING, field=et.ARB_FIELD)))
    # Realizations 0-31 are solved again on the CPU (each realization is solved on its own). In float32 the
    # solve is ill-conditioned (m < n, gamw 1e3: the Gram's null-space eigenvalues are float32 noise that
    # gamw scales), so two float32 runs differ by up to a few 1e-3 of max|x| (JAX against the port on the
    # CPU too); the card is held against the CPU in float64, where that noise is 1e-9 times smaller, and
    # the float32 distances are printed beside it.
    n_cpu = 32

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for name, p, solve in cases:
        y, A = (torch.from_numpy(p[k]) for k in ("y", "A"))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        x_card = solve(y.to(dev), A.to(dev), dev).x
        end.record()
        torch.cuda.synchronize()
        x_card = x_card.cpu()
        e = aps.nmse_db(x_card.numpy(), p["x"])
        print(f"[20d] {name} (B={len(p['y'])}, A {tuple(A.shape[1:])}, MatrixOp): {start.elapsed_time(end) / 1e3:.3f} s "
              f"on the card (card: {card}); every NMSE finite: {bool(np.all(np.isfinite(e)))}")
        if not np.all(np.isfinite(e)):
            raise SystemExit(f"[20d] {name}: an NMSE is not finite")
        _nmse_gate("[20d]", name, e, ref[name])
        y64, A64 = y[:n_cpu].to(torch.complex128), A[:n_cpu].to(torch.complex128)
        x_cpu = solve(y[:n_cpu], A[:n_cpu], "cpu").x
        x64_cpu = solve(y64, A64, "cpu").x
        x64_card = solve(y64.to(dev), A64.to(dev), dev).x.cpu()
        worst = int(((x_card[:n_cpu] - x_cpu).abs().amax(-1)).argmax())
        r64 = rel(x64_card, x64_cpu)
        print(f"[20d] {name}, realizations 0-{n_cpu - 1}, max|dx| over max|x|: float32 card against CPU "
              f"{rel(x_card[:n_cpu], x_cpu):.3e} (largest at realization {worst}), each against float64 on the CPU: "
              f"card {rel(x_card[:n_cpu], x64_cpu):.3e}, CPU {rel(x_cpu, x64_cpu):.3e}; float64 card against CPU "
              f"{r64:.3e} <= 1e-6: {r64 <= 1e-6}")
        if not r64 <= 1e-6:
            raise SystemExit(f"[20d] {name}: the card and the CPU disagree")
    print(f"[20] {time.perf_counter() - t0:.1f} s (host clock)")
    return paths


def _bilinear_cases(batch: int):
    """Phase 21's cases, at the first ``batch`` realizations of each problem:
    (phase, name, numpy arrays (realizations leading), truth, solve), where
    ``solve(arrays as tensors, generator)`` gives (the estimate, the learned
    quantities as numpy, what the card and the CPU are compared on)."""
    from jstsp19_torch.harness import bilinear as bl
    from jstsp19_torch.solvers.bigamp import bigamp_mc, bigamp_rpca, em_bigamp_dl, em_bigamp_mc
    from jstsp19_torch.solvers.bigamp_full import BigAmpOptions, bigamp_lite, bigamp_pev
    from jstsp19_torch.solvers.estim import AwgnPrior, CAwgnPrior, DiscretePrior, SparsePrior
    from jstsp19_torch.solvers.hutamp import hutamp
    from jstsp19_torch.solvers.pbigamp import em_pbigamp, pbigamp
    from jstsp19_torch.solvers.rank_one import rank_one_fit

    def db(v):
        return 10 * np.log10(v.double().cpu().numpy().ravel())

    gauss = CAwgnPrior(0j, 1.0)
    beta = bl.CALIB["k"] / bl.CALIB["Nc"]
    calib_b, calib_c = CAwgnPrior(1.0 + 0j, bl.CALIB["gain_var"]), SparsePrior(CAwgnPrior(0j, 1.0 / beta), beta)
    atoms, weights = bl.v_prior_grid()

    def mc(d, g):
        z = bigamp_mc(d["Y"], d["mask"], bl.MC["R"], bl.MC["nv"], g, **bl.MC_KW).Z
        return z, {}, z

    def em_mc(d, g):
        r = em_bigamp_mc(d["Y"], d["mask"], key=g, **bl.EM_MC_KW)
        return r.Z, dict(noise_var_db=db(r.noise_var), rank4=(r.rank == bl.DL_MC["R"]).double().cpu().numpy()), \
            (r.Z, r.rank)

    def lite(d, g):
        r, hist = bigamp_lite(d["Y"], d["mask"], bl.DL_MC["R"], 1.0, 1.0, bl.DL_MC["nv"], g, **bl.LITE_KW)
        return r.Z, dict(pass_rate=hist["passed"].double().mean(-1).cpu().numpy()), r.Z

    def pev(d, g):
        z = bigamp_pev(d["Y"], d["mask"], bl.DL_MC["R"], gauss, gauss, bl.DL_MC["nv"], g,
                       BigAmpOptions(nit=bl.PEV_NIT)).Z
        return z, {}, z

    def x2(d, g):
        r = bigamp_pev(d["Y"], torch.ones(d["Y"].shape, dtype=d["Y"].real.dtype, device=d["Y"].device), bl.X2["R"],
                       gauss, gauss, bl.X2["nv"], g, BigAmpOptions(nit=bl.X2_NIT), A2=d["A2"],
                       prior_x2=SparsePrior(CAwgnPrior(0j, 1.0), bl.X2["frac"]))
        return r.Z, dict(x2_nmse_db=bl.nmse_db(r.X2.cpu().numpy(), p_x2["X2"][:len(r.X2)])), r.Z

    def dl(d, g):
        r = em_bigamp_dl(d["Y"], bl.DL["R"], g)
        return r.Z, dict(noise_var_db=db(r.noise_var), sparsity=r.sparsity.double().cpu().numpy()), r.Z

    def rpca(d, g):
        z = bigamp_rpca(d["Y"], bl.RPCA["R"], bl.RPCA["nv"], bl.RPCA["outlier_var"], bl.RPCA["frac"], g,
                        nit=bl.RPCA_NIT).Z
        return z, {}, z

    def hsi(d, g):
        z = hutamp(d["Y"], bl.HSI["R"], g, **bl.HUTAMP_KW).Z
        return z, {}, z

    def calib(d, g):
        z = pbigamp(d["y"], bl.calib_tensor(d["Phi"]), calib_b, calib_c, d["nv"], g, **bl.PBIGAMP_KW).z
        return z, {}, z

    def em_calib(d, g):
        r = em_pbigamp(d["y"], bl.calib_tensor(d["Phi"]), g)
        return r.z, dict(noise_var_db=db(r.noise_var), p1=r.prior_c.p1.double().cpu().numpy().ravel()), r.z

    def rank_one(snr):
        def solve(d, g):
            A = bl.rank_one_matrix(d, snr)
            grid = DiscretePrior(*(torch.from_numpy(v).to(A.device, A.dtype) for v in (atoms, weights)))
            r = rank_one_fit(A, AwgnPrior(0.0, 1.0), grid, bl.rank_one_wvar(snr), key=g, nit=bl.RANK_ONE["nit"])
            corr = dict(corr_u=bl.sq_corr(r.u.cpu().numpy(), d["u0"].cpu().numpy()),
                        corr_v=bl.sq_corr(r.v.cpu().numpy(), d["v0"].cpu().numpy()))
            return None, corr, (r.u, r.v)
        return solve

    p_mc, p_dlmc, p_x2 = bl.mc_problems(batch), bl.dl_mc_problems(batch), bl.x2_problems(batch)
    p_dl, p_rpca, p_hsi, p_cal = (bl.dl_problems(batch), bl.rpca_problems(batch), bl.hsi_problems(batch),
                                  bl.calib_problems(batch))
    p_cal["nv"] = (10 ** (-bl.CALIB["snr_db"] / 10) * (np.abs(p_cal["z"]) ** 2).mean(-1)).astype(np.float32)
    p_r1 = bl.rank_one_problems(batch)
    r1_arrays = dict(u0=p_r1["u0"], v0=p_r1["v0"], W=p_r1["W"])
    return [
        ("[21a]", "bigamp_mc", {k: p_mc[k] for k in ("Y", "mask")}, p_mc["Z"], mc),
        ("[21a]", "em_bigamp_mc", {k: p_dlmc[k] for k in ("Y", "mask")}, p_dlmc["Z"], em_mc),
        ("[21a]", "bigamp_lite", {k: p_dlmc[k] for k in ("Y", "mask")}, p_dlmc["Z"], lite),
        ("[21a]", "bigamp_pev", {k: p_dlmc[k] for k in ("Y", "mask")}, p_dlmc["Z"], pev),
        ("[21a]", "bigamp_pev_x2", dict(Y=p_x2["Y"], A2=p_x2["A2"]), p_x2["Z"], x2),
        ("[21a]", "em_bigamp_dl", dict(Y=p_dl["Y"]), p_dl["Z"], dl),
        ("[21a]", "bigamp_rpca", dict(Y=p_rpca["Y"]), p_rpca["Z"], rpca),
        ("[21b]", "hutamp", dict(Y=p_hsi["Y"]), p_hsi["Z"], hsi),
        ("[21c]", "pbigamp", {k: p_cal[k] for k in ("y", "Phi", "nv")}, p_cal["z"], calib),
        ("[21c]", "em_pbigamp", {k: p_cal[k] for k in ("y", "Phi")}, p_cal["z"], em_calib),
        *(("[21d]", f"rank_one_{snr:g}db", r1_arrays, None, rank_one(snr)) for snr in bl.RANK_ONE["snrs_db"]),
    ]


def _on(arrays, device, wide=False):
    """The arrays as tensors on ``device``, complex64/float32 widened to
    complex128/float64 if ``wide``."""
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if wide:
            t = t.to({torch.complex64: torch.complex128, torch.float32: torch.float64}.get(t.dtype, t.dtype))
        out[k] = t.to(device)
    return out


def _cpu_gen():
    """Every run of the card-against-CPU check, on either device, draws from a
    new CPU generator seeded 0, so that both start from the same numbers."""
    return torch.Generator().manual_seed(0)


def _bilinear_cpu_half(n_cpu: int, queue, threads=None) -> None:
    """The CPU's half of phase 21's card-against-CPU check, in a process of
    its own (a thread would share the interpreter lock with the card's launch
    loop): each case's first ``n_cpu`` realizations in float64, put on
    ``queue`` with the seconds it took."""
    threads = threads or max(1, (os.cpu_count() or 2) - 2)  # a core for the card's launch loop
    torch.set_num_threads(threads)
    t = time.perf_counter()

    def numpy(v):  # tensors would cross the queue as file descriptors, which die with this process
        return tuple(numpy(e) for e in v) if isinstance(v, tuple) else v.numpy()

    out = {name: numpy(fn(_on(arrays, "cpu", True), _cpu_gen())[2])
           for _, name, arrays, _, fn in _bilinear_cases(n_cpu)}
    queue.put((out, time.perf_counter() - t, threads))


def _bilinear(root, dev, card, counters, cpu=None) -> None:
    """Phase 21: the bilinear solvers.  No kernel is on their path, so the
    four kernels' launch counts must not move.  ``cpu``: the (process,
    queue) of :func:`_start_cpu_halves`, else the CPU's half starts here."""
    import multiprocessing
    import queue as queue_module

    from jstsp19_torch.harness import bilinear as bl
    from jstsp19_torch.solvers.estim import AwgnPrior, DiscretePrior
    from jstsp19_torch.solvers.rank_one import mc_prior_mse, prior_moments, rank_one_se

    ref = json.loads((root / "results" / "torch_bilinear_jax.json").read_text())
    before = {name: fn.launches for name, fn in counters.items()}
    t0 = time.perf_counter()
    n_cpu = BILINEAR_CPU_REALIZATIONS
    if cpu is None:
        ctx = multiprocessing.get_context("spawn")
        queue = ctx.Queue()
        cpu_half = ctx.Process(target=_bilinear_cpu_half, args=(n_cpu, queue), daemon=True)
        cpu_half.start()
    else:
        cpu_half, queue = cpu
    try:
        # the card's side: every case at B=256 and its gates, then its first 32 realizations in float64 and
        # float32 from the CPU's draws, while the CPU's half runs; then the comparison and the timed reps
        cases = _bilinear_cases(bl.BATCH)
        atoms, weights = bl.v_prior_grid()
        prior_u, prior_v = AwgnPrior(0.0, 1.0), DiscretePrior(torch.from_numpy(atoms).to(dev),
                                                              torch.from_numpy(weights).to(dev))
        um, uv = prior_moments(prior_u)
        vm, vv = prior_moments(prior_v)
        w_v = torch.from_numpy(weights / weights.sum()).to(dev)
        mse_u = mc_prior_mse(lambda g, n: torch.randn(n, generator=g, device=g.device), prior_u,
                             n_samples=bl.RANK_ONE["n_samples"], device=dev)
        mse_v = mc_prior_mse(lambda g, n: prior_v.atoms[torch.multinomial(w_v, n, True, generator=g)], prior_v,
                             n_samples=bl.RANK_ONE["n_samples"], device=dev)

        card_cmp = {}
        for phase, name, arrays, truth, fn in cases:
            d = _on(arrays, dev)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            est, learned, _ = fn(d, torch.Generator(device=dev).manual_seed(0))
            end.record()
            torch.cuda.synchronize()
            r = ref[name]
            keep = keep_ref = slice(None)
            if truth is not None:
                e = bl.nmse_db(est.cpu().numpy(), truth)
                print(f"{phase} {name} (B={len(e)}): {start.elapsed_time(end) / 1e3:.3f} s on the card (card: {card})")
                # A realization is lost where its NMSE is not finite or ≥ 0 dB. JAX loses some: hutamp 43 of 256
                # (its float32 truncated-normal moments past ~1e4 σ turn a diverging step's estimates negative;
                # the port's far-tail series keeps them, ROADMAP Queue 3), em_pbigamp 8 (its first inner solve
                # diverges from the draw at the wrapper's defaults, in the port too). So the lost share may not
                # exceed JAX's by 4 SE, and the batch means are of the realizations each package kept.
                e_ref = np.asarray(r["nmse_db"], np.float64)
                keep, keep_ref = np.isfinite(e) & (e < 0), np.isfinite(e_ref) & (e_ref < 0)
                lost, lost_ref = 1.0 - keep.mean(), 1.0 - keep_ref.mean()
                se = math.sqrt(lost * (1 - lost) / len(e) + lost_ref * (1 - lost_ref) / len(e_ref))
                ok = lost <= lost_ref + 4 * se
                print(f"{phase} {name}: lost {int((~keep).sum())} of {len(e)} (JAX {int((~keep_ref).sum())} of "
                      f"{len(e_ref)}); the port's share at most JAX's + 4 SE: {ok}")
                if not ok:
                    raise SystemExit(f"{phase} {name}: more realizations lost than the JAX reference")
                kept = e_ref[keep_ref]
                _nmse_gate(phase, f"{name} (kept realizations)", e[keep],
                           dict(mean_db=float(kept.mean()), sd_db=float(kept.std(ddof=1)), n=kept.size))
                thr = bl.THRESHOLDS_DB[name]
                meets = e < thr if name != "em_bigamp_mc" else (e < thr) & (learned["rank4"] > 0)
                print(f"{phase} {name}: share meeting the JAX test's threshold (NMSE < {thr:.2f} dB"
                      f"{' and rank 4' if name == 'em_bigamp_mc' else ''}): {meets.mean():.4f}; JAX's "
                      f"{np.mean(np.asarray(r['nmse_db']) < thr):.4f} (NMSE only)")
            else:
                print(f"{phase} {name} (B={bl.BATCH}, m, n = {bl.RANK_ONE['m']}, {bl.RANK_ONE['n']}): "
                      f"{start.elapsed_time(end) / 1e3:.3f} s on the card (card: {card})")
            for k, v in learned.items():
                v, v_ref = v[keep], np.asarray(r["params"][k]["values"], np.float64)[keep_ref]
                if not np.all(np.isfinite(v)):
                    raise SystemExit(f"{phase} {name}: a learned {k} of a kept realization is not finite")
                if k in ("pass_rate", "x2_nmse_db"):
                    print(f"{phase} {name} {k}: batch mean {v.mean():.5g} vs JAX {v_ref.mean():.5g} (printed)")
                else:
                    _mean_gate(phase, f"{name} {k}", v, dict(mean=float(v_ref.mean()), sd=float(v_ref.std(ddof=1)),
                                                              n=v_ref.size))
            if truth is None:
                # rank_one_se on mc_prior_mse, as the example runs it
                cu, cv = rank_one_se(mse_u, mse_v, bl.RANK_ONE["n"] / bl.RANK_ONE["m"], um, uv, vm, vv, r["wvar"],
                                     nit=bl.RANK_ONE["nit"])
                for k, se, last in (("corr_u", r["se_corr_u"], float(cu[-1])),
                                    ("corr_v", r["se_corr_v"], float(cv[-1]))):
                    v = learned[k]
                    gap = abs(float(v.mean()) - last)
                    # the JAX test holds the fit to its SE at 5 dB; at 0 dB, below the transition, the SE is ≈ 0
                    # and JAX's own fit lies 0.11 (u) and 0.18 (v) from it, so there the gap is printed
                    gated = r["snr_db"] >= 5.0
                    print(f"{phase} {name} {k}: batch mean {v.mean():.4f} vs the port's SE {last:.4f} "
                          f"(JAX's {se:.4f}): |gap| {gap:.4f} <= 0.1: {gap <= 0.1}{'' if gated else ' (printed)'}; "
                          f"share of realizations within 0.1: {np.mean(np.abs(v - last) <= 0.1):.4f}")
                    if gated and not gap <= 0.1:
                        raise SystemExit(f"{phase} {name}: the fit's {k} is not within 0.1 of its state evolution")
            first = {k: v[:n_cpu] for k, v in arrays.items()}
            card_cmp[name] = tuple(fn(_on(first, dev, wide), _cpu_gen())[2] for wide in (True, False))

        t_wait = time.perf_counter()
        while True:
            try:
                cpu_cmp, t_cpu, threads = queue.get(timeout=5)
                break
            except queue_module.Empty:
                if not cpu_half.is_alive():
                    raise SystemExit(f"[21] the CPU's half ended with code {cpu_half.exitcode} and no result")
        print(f"[21] the CPU's half of the check took {t_cpu:.1f} s in its process ({threads} intra-op threads); the "
              f"card's side then waited {time.perf_counter() - t_wait:.1f} s for it (host clock)")

        def rel(a, b, strict=True):
            """max|a − b| over max|b| on the realizations whose CPU result is
            finite; the card's must be non-finite on exactly the others (if
            not ``strict``, on the realizations finite in both)."""
            a, b = a.cpu(), torch.from_numpy(b)
            fin_a, fin = (torch.isfinite(v.reshape(len(v), -1)).all(-1) for v in (a, b))
            if strict and not torch.equal(fin_a, fin):
                return math.inf
            fin = fin & fin_a
            return float((a[fin] - b[fin]).abs().max() / b[fin].abs().max())

        for phase, name, _, _, _ in cases:
            (c64, c32), p64 = card_cmp[name], cpu_cmp[name]
            if name == "em_bigamp_mc":
                (c64, rank_c), (p64, rank_p), c32 = c64, p64, c32[0]
                same = bool(np.array_equal(rank_c.cpu().numpy(), rank_p))
                print(f"{phase} {name}: float64 selected ranks on the card and the CPU equal: {same}")
                if not same:
                    raise SystemExit(f"{phase} {name}: the card and the CPU select different ranks")
            pairs = list(zip(c64, p64)) if isinstance(c64, tuple) else [(c64, p64)]
            r64 = max(rel(a, b) for a, b in pairs)
            pairs32 = list(zip(c32, p64)) if isinstance(c32, tuple) else [(c32, p64)]
            r32 = max(rel(a, b, strict=False) for a, b in pairs32)
            print(f"{phase} {name}, realizations 0-{n_cpu - 1}, max|dZ| over max|Z|: float64 card against CPU "
                  f"{r64:.3e} <= 1e-6: {r64 <= 1e-6}; float32 card against the float64 CPU {r32:.3e} (printed)")
            if not r64 <= 1e-6:
                raise SystemExit(f"{phase} {name}: the card and the CPU disagree")

        for phase, name, arrays, _, fn in cases:
            d = _on(arrays, dev)
            _timed(phase, name, lambda: fn(d, torch.Generator(device=dev).manual_seed(0)), card, reps=3)
    finally:
        if cpu is None:
            if cpu_half.is_alive():
                cpu_half.terminate()
            cpu_half.join()
    moved = {name: fn.launches - before[name] for name, fn in counters.items()}
    print(f"[21] kernel launches across [21]: {moved}; none moved: {not any(moved.values())}")
    if any(moved.values()):
        raise SystemExit("[21] a kernel launched on the bilinear solvers' path")
    print(f"[21] {time.perf_counter() - t0:.1f} s (host clock)")


def _widened(problem: dict) -> dict:
    """The problem's float32 and complex64 tensors as float64 and complex128."""
    wide = {torch.float32: torch.float64, torch.complex64: torch.complex128}
    return {k: v.to(wide[v.dtype]) if isinstance(v, torch.Tensor) and v.dtype in wide else v
            for k, v in problem.items()}


def _examples_half(names, device: str, queue, wide=(), threads=3) -> None:
    """One part of phase 22's solves, in a process of its own: each example
    of ``names`` on the port's draws (drawn on the CPU) on ``device``; on
    the card three timed solves, the four kernels' launches and
    ``KronDictOp.rmv``'s routes read across the first.  Then one solve of
    each example of ``wide`` on its problem in float64.  Puts ``(name,
    result)`` on ``queue`` as each ends, then ``(None, seconds)``."""
    from jstsp19_torch.examples import _common
    from jstsp19_torch.kernels import admm_fused, dictionary, softthresh, wht
    from jstsp19_torch.ops import KronDictOp

    t0 = time.perf_counter()
    card = device == "cuda"
    torch.set_num_threads(1 if card else threads)  # the card's launch loops and the launcher's processes keep the rest
    counters = {"fused_tracked_admm": admm_fused.fused_tracked_admm, "dict_correlation": dictionary.dict_correlation,
                "soft_threshold": softthresh.fused_soft_threshold, "fwht": wht.fwht_kernel}
    for name in names:
        mod = __import__(f"jstsp19_torch.examples.{name}", fromlist=["solve"])
        p = mod.build(torch.device(device), _common.generator(mod.SEED))
        if not card:
            queue.put((name, {"got": mod.solve(p)}))
            continue
        before = {k: fn.launches for k, fn in counters.items()}
        routes = (KronDictOp.kernel_rmvs, KronDictOp.matmul_rmvs)
        times = []
        for rep in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = mod.solve(p)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            if rep == 0:
                first = got
                moved = {k: fn.launches - before[k] for k, fn in counters.items()}
                rmvs = (KronDictOp.kernel_rmvs - routes[0], KronDictOp.matmul_rmvs - routes[1])
        queue.put((name, {"got": first, "times": times, "moved": moved, "rmvs": rmvs}))
    for name in wide:
        mod = __import__(f"jstsp19_torch.examples.{name}", fromlist=["solve"])
        p = _widened(mod.build(torch.device(device), _common.generator(mod.SEED)))
        queue.put((name, {"got64": mod.solve(p), "device": device}))
    queue.put((None, time.perf_counter() - t0))


def _wide_examples():
    """The examples held in float64 on both sides ([22]b)."""
    from jstsp19_torch.examples import NAMES

    return tuple(n for n in NAMES
                 if getattr(__import__(f"jstsp19_torch.examples.{n}", fromlist=["solve"]), "FLOAT64", False))


def _cpu_halves(q21, q22, q23, threads: int) -> None:
    """The CPU's halves of phases 23's, 21's and 22's card-against-CPU
    checks, one after the other in one process."""
    from jstsp19_torch.examples import NAMES

    _routes_cpu_half(q23, threads)
    _bilinear_cpu_half(BILINEAR_CPU_REALIZATIONS, q21, threads)
    _examples_half(NAMES, "cpu", q22, _wide_examples(), threads)


def _start_cpu_halves(threads: int = 3):
    """Start :func:`_cpu_halves` in a process of its own, so that the CPU's
    work of phases 21, 22 and 23 runs beside the card's phases before them
    and no phase waits for it (``threads`` intra-op threads leave the other
    cores to the card's launch loop).  Returns ``(process, phase 21's queue),
    (process, phase 22's queue), (process, phase 23's queue)``."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    q21, q22, q23 = ctx.Queue(), ctx.Queue(), ctx.Queue()
    proc = ctx.Process(target=_cpu_halves, args=(q21, q22, q23, threads), daemon=True)
    proc.start()
    return (proc, q21), (proc, q22), (proc, q23)


def _demo_process(args, timeout: float = 600):
    """(exit code, output, errors, seconds) of ``python <args>`` from the checkout."""
    import subprocess

    root = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, OMP_NUM_THREADS="2")  # beside the solves' processes, on the host's few cores
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=root, capture_output=True, text=True, timeout=timeout,
                          env=env)
    return proc.returncode, proc.stdout, proc.stderr, time.perf_counter() - t


def _examples(root, dev, card, cpu=None) -> dict:
    """Phase 22: the worked examples.  Returns each kernel's launches across
    the examples' first solves on the card.  ``cpu``: the (process, queue)
    of :func:`_start_cpu_halves`, else the CPU's half starts here."""
    import multiprocessing
    import queue as queue_module
    from concurrent.futures import ThreadPoolExecutor

    from jstsp19_torch.examples import NAMES, _common
    from jstsp19_torch.examples import channel_estimation as ce
    from jstsp19_torch.kernels.dictionary import dict_correlation, dict_correlation_plain
    from jstsp19_torch.ops import KronDictOp

    t0 = time.perf_counter()
    ref = json.loads((root / "results" / "torch_examples_jax.json").read_text())["examples"]
    # the solves in processes beside this one, all started together: S-AMP (launch-bound, ~25,000 kernels an
    # iteration) alone on the card; the other 20, then the FLOAT64 examples in float64, on the card; all 21, then
    # the FLOAT64 ones in float64, on the CPU (unless that process started before); and every example through
    # the launcher, three at a time
    ctx = multiprocessing.get_context("spawn")
    slow = ("s_amp",)
    wide = _wide_examples()
    parts = [(slow, "cuda", ()), (tuple(n for n in NAMES if n not in slow), "cuda", wide)]
    if cpu is None:
        queue = ctx.Queue()
        parts.append((NAMES, "cpu", wide))
        cpu_half = None
    else:
        cpu_half, queue = cpu
    halves = [ctx.Process(target=_examples_half, args=(names, device, queue, w), daemon=True)
              for names, device, w in parts]
    for h in halves:
        h.start()
    ends = len(halves) + (cpu_half is not None)
    pool = ThreadPoolExecutor(max_workers=3)
    runs = {name: pool.submit(_demo_process, ["-m", "jstsp19_torch", "demo", name])
            for name in slow + tuple(n for n in NAMES if n not in slow)}  # the slowest first
    runs["listing"] = pool.submit(_demo_process, ["-m", "jstsp19_torch", "demo"])
    runs["ranks 2"] = pool.submit(_demo_process, ["-m", "jstsp19_torch.examples.large_array_sharded", "--ranks", "2",
                                                  "--labels"])
    launches_total = {name: 0 for name in ("fused_tracked_admm", "dict_correlation", "soft_threshold", "fwht")}
    try:
        # (a) the listing
        rc, out, err, _ = runs["listing"].result()
        listed = [ln.split()[0] for ln in out.splitlines()[1:]]
        print(f"[22] demo lists {len(listed)} examples; they are the JAX scripts' ({len(ref)}): "
              f"{rc == 0 and listed == list(NAMES) == sorted(ref)}")
        if not (rc == 0 and listed == list(NAMES) == sorted(ref)):
            raise SystemExit(f"[22] demo's listing is not the JAX scripts': {listed}\n{err}")
        # (c) a VAMP-shape operator ([19c]: K (256, 4, 16), A (256, 4, 32), B (256, 16, 16)) takes the kernel
        g = torch.Generator(device=dev).manual_seed(22)
        A, B, K = (torch.randn(*sh, generator=g, device=dev, dtype=torch.complex64)
                   for sh in ((256, 4, 32), (256, 16, 16), (256, 4, 16)))
        n0, r0 = dict_correlation.launches, KronDictOp.kernel_rmvs
        got_k = KronDictOp(A, B).rmv(K)
        want_k = dict_correlation_plain(A, K, B)
        err_k = float((got_k - want_k).abs().max() / want_k.abs().max())
        ok = dict_correlation.launches == n0 + 1 and KronDictOp.kernel_rmvs == r0 + 1 and err_k <= 1e-5
        print(f"[22] KronDictOp.rmv at [19c]'s shapes: the kernel's route, one launch, max|d|/max|ref| {err_k:.2e} "
              f"<= 1e-5: {ok}")
        if not ok:
            raise SystemExit("[22] a VAMP-shape KronDictOp did not take the kernel's route")

        # (b, c, e) the halves' results as they come
        on_card, on_cpu, wide_got, ended = {}, {}, {"cuda": {}, "cpu": {}}, 0
        while ended < ends:
            try:
                name, res = queue.get(timeout=5)
            except queue_module.Empty:
                dead = [h.exitcode for h in halves + [cpu_half] if h and not h.is_alive() and h.exitcode != 0]
                if dead:
                    raise SystemExit(f"[22] a process of the solves ended with code {dead[0]}")
                continue
            if name is None:
                ended += 1
                print(f"[22] a process of the solves ended after {res:.1f} s (host clock)")
                continue
            if "got64" in res:
                wide_got[res["device"]][name] = res["got64"]
                continue
            if "times" not in res:
                on_cpu[name] = res["got"]
                continue
            on_card[name] = res["got"]
            moved, (kernel_rmvs, matmul_rmvs), times = res["moved"], res["rmvs"], res["times"]
            for k, n in moved.items():
                launches_total[k] += n
            # only channel_estimation's pipeline launches: each ADMM method ('eigh', unfused) one dict_correlation
            # and one soft_threshold an iteration, VAMP's adjoint one kernel-route rmv an iteration
            want = dict(fused_tracked_admm=0, dict_correlation=0, soft_threshold=0, fwht=0)
            want_rmvs = 0
            if name == "channel_estimation":
                pc = ce.PC
                admm = sum(m in ("proposed", "proposed_angles") for m in pc.methods) * pc.Imax
                want_rmvs = pc.vamp_nit if "vamp" in pc.methods else 0
                want.update(dict_correlation=admm + want_rmvs, soft_threshold=admm)
            ok = moved == want and kernel_rmvs == want_rmvs
            if name in ("sparse_recovery", "s_amp"):
                ok = ok and matmul_rmvs > 0 and kernel_rmvs == 0
            print(f"[22] {name}: solve best of 3 {min(times):.3f} s (first {times[0]:.3f} s; card: {card}); "
                  f"launches {moved}; KronDictOp.rmv kernel route {kernel_rmvs}, matmul route {matmul_rmvs}; "
                  f"as the routes say ({want}, kernel-route rmvs {want_rmvs}): {ok}")
            if not ok:
                raise SystemExit(f"[22] {name}: kernel launches or routes not as the routes say")

        # (a) the launcher's processes
        for name in NAMES:
            rc, out, err, secs = runs[name].result()
            lines = out.splitlines()
            nums = _common.parse(lines)
            want = {k for k in ref[name]["numbers"] if not (name == "large_array_sharded" and k.startswith("00 "))}
            have = {k for k in nums if not (name == "large_array_sharded" and k.startswith("00 "))}
            finite = all(math.isfinite(v) for v in nums.values())
            header = name != "large_array_sharded" or (lines[:1] and lines[0].startswith("ranks 1, "))
            ok = rc == 0 and finite and have == want and len(lines) == len(ref[name]["lines"]) and header
            print(f"[22] demo {name}: exit {rc} in {secs:.1f} s (host clock); {len(lines)} lines, numbers finite: "
                  f"{finite}; labels those of the JAX script: {have == want}")
            if not ok:
                raise SystemExit(f"[22] demo {name} failed or printed other lines\n{out}\n{err[-2000:]}")
        # (d) 2 ranks sharing the card against one process
        rc, out, err, secs = runs["ranks 2"].result()
        if rc != 0:
            raise SystemExit(f"[22] large_array_sharded --ranks 2 exited {rc}\n{err[-2000:]}")
        two = json.loads(next(ln for ln in out.splitlines() if ln.startswith("{")))
        one = on_card["large_array_sharded"]
        bad = [k for k in one if not k.startswith("00 ") and not abs(two[k] - one[k]) <= 1e-6 * abs(one[k])]
        print(f"[22] large_array_sharded over 2 ranks sharing the card (gloo), {secs:.1f} s: every number but the "
              f"header's within rtol 1e-6 of one process: {not bad}; ranks {two[next(iter(two))]:.0f}")
        if bad:
            raise SystemExit(f"[22] 2 ranks differ from one process at {bad}")

        # (b) the card against the CPU (in float64 where the example says float32 cannot show it)
        def worst(got, ref, table):
            """The largest relative |d| but on the Monte-Carlo labels (the SEs the card's generator draws)."""
            return max((abs(got[k] - v) / max(abs(v), 1e-30) for k, v in ref.items() if k in got and math.isfinite(v)
                        and _common.tolerance(k, table, False)[0] != "mc"), default=0.0)

        disagree = []
        for name in NAMES:
            mod = __import__(f"jstsp19_torch.examples.{name}", fromlist=["solve"])
            table = getattr(mod, "CARD_TOLERANCE", mod.TOLERANCE)
            if name in wide:
                card64, cpu64 = wide_got["cuda"][name], wide_got["cpu"][name]
                bad = _common.mismatches(card64, cpu64, table)
                print(f"[22] {name}: card against CPU in float64, {len(cpu64)} numbers, largest relative |d| (the "
                      f"Monte-Carlo SEs aside) {worst(card64, cpu64, table):.2e}, all within the example's tolerance: "
                      f"{not bad}; in float32 {worst(on_card[name], on_cpu[name], table):.2e} (printed)")
            else:
                bad = _common.mismatches(on_card[name], on_cpu[name], table)
                print(f"[22] {name}: card against CPU, {len(on_cpu[name])} numbers, largest relative |d| (the "
                      f"Monte-Carlo SEs aside) {worst(on_card[name], on_cpu[name], table):.2e}; all within the "
                      f"example's tolerance: {not bad}")
            if bad:
                print(f"[22] {name}: the card and the CPU disagree: {bad}")
                disagree.append(name)
        if disagree:
            raise SystemExit(f"[22] the card and the CPU disagree on {disagree}")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        for h in halves:
            if h.is_alive():
                h.terminate()
            h.join()
    print(f"[22] kernel launches across the examples' first solves: {launches_total}")
    print(f"[22] {time.perf_counter() - t0:.1f} s (host clock)")
    return launches_total


def _route_problems():
    """[23b]'s inputs, made on the CPU alike in either process: float64
    partial-Hadamard problems (the slice's B=32, n=65536 cut to ROUTES_BATCH
    rows of ROUTES_N), [19b]'s beamspace problems in complex128, an errorVSnrf
    Mr=16 point's ADMM problem in complex128, and one float64 row of
    ROUTES_FWHT_N, over the FWHT kernel's 2^24."""
    from jstsp19_torch.core import prng
    from jstsp19_torch.harness import amp_sparse as aps
    from jstsp19_torch.harness import hadamard_cs as hcs
    from jstsp19_torch.harness.pipeline import PointConfig, proposed_problem

    cs = hcs.hadamard_cs_problem(seed=23, batch=ROUTES_BATCH, n=ROUTES_N)
    cs = dict(cs, y=cs["y"].astype(np.float64), wvar=cs["wvar"].astype(np.float64))
    beam = {k: v.astype(np.complex128) for k, v in aps.beamspace_problem(batch=B_MAIN).items()}
    prob = proposed_problem(prng.realization_generators(23, 3, "cpu"), PointConfig(Mr=16, T=5, methods=("proposed",)),
                            NV_5DB, ROUTES_ADMM_BATCH)
    wide = {torch.float32: torch.float64, torch.complex64: torch.complex128}
    admm = [prob[k].to(wide[prob[k].dtype]).numpy() for k in ("subY", "Omega", "A", "B", "tau_Y", "tau_S", "rho")]
    row = np.random.default_rng(23).standard_normal((1, ROUTES_FWHT_N))
    return cs, beam, admm, row


def _route_solves(problems, device) -> dict:
    """[23b]'s solves on ``device``, each on the route its dtype takes:
    ``gamp_est`` (mean removal off) and ``amp_est`` on ``SubsetOp(FWHTOp)``,
    ``sparse_admm``, ``proposed_admm(use_kernels=True)`` and the FWHT of the
    oversize row.  Returns each result on ``device``."""
    from jstsp19_torch.harness import amp_sparse as aps
    from jstsp19_torch.harness import hadamard_cs as hcs
    from jstsp19_torch.ops.fourier import fwht
    from jstsp19_torch.solvers.admm import proposed_admm
    from jstsp19_torch.solvers.gamp import amp_est
    from jstsp19_torch.solvers.gamp_full import gamp_est
    from jstsp19_torch.solvers.sparse import sparse_admm

    cs, beam, admm, row = problems
    out = {"gamp_est float64": gamp_est(*hcs.hadamard_cs_torch(cs, device))[0].xhat}
    y, op, prior, _ = aps.hadamard_amp_torch(cs, device)
    out["amp_est float64"] = amp_est(y, op, prior, nit=aps.AMP_NIT)
    d = aps.to_device(beam, device)
    out["sparse_admm complex128"] = sparse_admm(d["H"], d["OH"], d["Dr"], d["Dt"], aps.ADMM_IMAX)[0]
    a = [torch.from_numpy(v).to(device) for v in admm]
    out["proposed_admm complex128"] = proposed_admm(*a[:4], IMAX_MAIN, *a[4:], use_kernels=True).S
    out[f"fwht float64 n=2^{ROUTES_FWHT_N.bit_length() - 1}"] = fwht(torch.from_numpy(row).to(device))
    return out


def _routes_cpu_half(queue, threads: int) -> None:
    """The CPU's half of phase 23: builds the host library (so that the
    card's side finds it built) and runs [23b]'s solves on the CPU; puts
    ``(results as numpy, seconds)`` on ``queue``."""
    from jstsp19_torch.utils import native_available

    torch.set_num_threads(threads)
    t = time.perf_counter()
    native_available()
    out = {k: v.numpy() for k, v in _route_solves(_route_problems(), "cpu").items()}
    queue.put((out, time.perf_counter() - t))


def _routes_checks(dev, cpu_queue) -> float:
    """Phase 23's checks: (a) the FWHT kernel against the float64 host
    library, (b) the routes that float64 and complex128 take on the card,
    against the CPU (the results of :func:`_routes_cpu_half`, read from
    ``cpu_queue``), with no kernel launched.  Returns (a)'s max|Δ|."""
    from jstsp19_torch.kernels import admm_fused, dictionary, softthresh, wht
    from jstsp19_torch.ops import fourier
    from jstsp19_torch.utils import native_available, native_fwht

    t0 = time.perf_counter()
    # (a) the float64 host oracle of the FWHT
    if not native_available():
        raise SystemExit("[23a] the host library (jstsp19_torch/utils/csrc, g++) did not build")
    g = torch.Generator(device=dev).manual_seed(23)
    x = torch.randn(32, 65536, generator=g, device=dev)
    x64 = x.double().cpu().numpy()
    fwht_oracle_err = 0.0
    for ordering in ("sequency", "natural"):
        out_k = wht.fwht_kernel(x, ordering)
        ref = native_fwht(x64, ordering)
        err, scale = float(np.abs(out_k.double().cpu().numpy() - ref).max()), float(np.abs(ref).max())
        fwht_oracle_err = max(fwht_oracle_err, err)
        ok = err <= ROUTES_ORACLE_RTOL * scale
        print(f"[23a] fwht_kernel {tuple(x.shape)} float32 {ordering} against native_fwht in float64: max|d|="
              f"{err:.3e} <= {ROUTES_ORACLE_RTOL:g}*max|ref|={ROUTES_ORACLE_RTOL * scale:.3e}: {ok}")
        if not ok:
            raise SystemExit("[23a] the FWHT kernel disagrees with the float64 host library")

    # (b) float64 and complex128 on the card: the plain routes, no kernel launched, against the CPU
    counters = (admm_fused.fused_tracked_admm, dictionary.dict_correlation, softthresh.fused_soft_threshold,
                wht.fwht_kernel)
    routed = (fourier.fwht, fourier.ifwht, dictionary.dict_correlation_routed,
              softthresh.fused_soft_threshold_routed)
    problems = _route_problems()
    for c in counters:
        c.launches = 0
    for r in routed:
        r.kernel_calls = r.plain_calls = 0
    t = time.perf_counter()
    on_card = _route_solves(problems, dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    launches = {c.__name__: c.launches for c in counters}
    routes = {f"{r.__module__.rsplit('.', 1)[-1]}.{r.__name__}": (r.kernel_calls, r.plain_calls) for r in routed}
    ok = not any(launches.values()) and all(k == 0 and n > 0 for k, n in routes.values())
    print(f"[23b] the solves on the card ({card_s:.3f} s, host clock, first calls): kernel launches {launches}; "
          f"routes (kernel, plain) {routes}; no kernel launched, every route plain: {ok}")
    if not ok:
        raise SystemExit("[23b] a float64 or complex128 solve launched a kernel")
    t = time.perf_counter()
    on_cpu, cpu_s = cpu_queue.get(timeout=600)
    print(f"[23b] the CPU's half took {cpu_s:.1f} s; this side waited {time.perf_counter() - t:.1f} s for it "
          "(its results included)")
    for name, got in on_card.items():
        ref = torch.from_numpy(on_cpu[name])
        got = got.cpu()
        d = (got - ref).abs().flatten(1).amax(1) / ref.abs().flatten(1).amax(1)
        rel = float(d.max())
        ok = got.dtype == ref.dtype and got.dtype in (torch.float64, torch.complex128) and rel <= ROUTES_RTOL
        print(f"[23b] {name} {tuple(got.shape)}: card against CPU, max|d|/max|ref| per realization {rel:.2e} "
              f"<= {ROUTES_RTOL:g}: {ok}")
        if not ok:
            raise SystemExit(f"[23b] {name}: the card and the CPU disagree")
    print(f"[23a-b] {time.perf_counter() - t0:.1f} s (host clock)")
    return fwht_oracle_err


def _routes_card_half(cpu_queue, out_queue, threads: int = 2) -> None:
    """Phase 23's checks (:func:`_routes_checks`) in a process of their own,
    beside [21] and [22] on the card (launch streams that leave it room; the
    launch counts are this process's own).  Puts ``(the printed lines, (a)'s
    max|Δ|, None)`` on ``out_queue``, or the lines and the failure."""
    import traceback

    torch.set_num_threads(threads)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            err = _routes_checks(torch.device("cuda"), cpu_queue)
        out_queue.put((buf.getvalue(), err, None))
    except SystemExit as e:
        out_queue.put((buf.getvalue(), None, str(e)))
    except Exception:  # the boundary of this process: the main process reports it and fails
        out_queue.put((buf.getvalue(), None, traceback.format_exc()))


def _start_routes_card_half(cpu):
    """Start :func:`_routes_card_half`; ``cpu``: the (process, queue) of
    :func:`_start_cpu_halves` whose queue carries [23]'s CPU results.
    Returns ``(process, its queue)``."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    proc = ctx.Process(target=_routes_card_half, args=(cpu[1], out), daemon=True)
    proc.start()
    return proc, out


def _routes_result(half) -> float:
    """[23]'s checks from the process of :func:`_start_routes_card_half`:
    prints its lines and returns (a)'s max|Δ|, or fails as it did."""
    import queue as queue_module

    proc, out = half
    t = time.perf_counter()
    while True:
        try:
            text, err, failure = out.get(timeout=5)
            break
        except queue_module.Empty:
            if not proc.is_alive():
                raise SystemExit(f"[23] the process of the checks ended with code {proc.exitcode}")
    proc.join(timeout=60)
    print(text, end="")
    print(f"[23] the checks ran beside [21] and [22]; the main process waited {time.perf_counter() - t:.1f} s for them")
    if failure:
        raise SystemExit(failure)
    return err


def _softshrink_times(dev, card, kernels) -> None:
    """Phase 23c: the soft threshold at one τ against ``F.softshrink`` on the
    real view, on the same v: equal, and both timed; sets the soft
    threshold's ``library_ms`` (and the one-τ times) in ``kernels``."""
    import torch.nn.functional as F

    from jstsp19_torch.bench import device_ms
    from jstsp19_torch.kernels import softthresh

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(23)
    v = torch.randn(B_MAIN, 32, 16, generator=g, device=dev, dtype=torch.complex64) * 0.3
    tau = 0.2

    def library():
        return torch.view_as_complex(F.softshrink(torch.view_as_real(v), tau))

    def kernel():
        return softthresh.fused_soft_threshold(v, tau)

    def one_kernel_ms(fn, match):
        """``device_ms`` of fn, which launches one kernel a call, from a trace
        that recorded one a call (within 5%); at most three traces, else NaN."""
        for _ in range(3):
            ms, n = device_ms(fn, match=match)
            if abs(n - 1) <= 0.05:
                return ms, n
        return float("nan"), n

    same = torch.equal(kernel(), library())
    (k_dev, k_n), (l_dev, l_n) = one_kernel_ms(kernel, "soft_threshold"), one_kernel_ms(library, "softshrink")
    k_ms, l_ms = [], []
    for _ in range(2):  # in turns: kernel, softshrink, kernel, softshrink
        k_ms.append(_per_call_ms(kernel))
        l_ms.append(_per_call_ms(library))
    print(f"[23c] soft_threshold, one tau {tau}, v {tuple(v.shape)}: equal to softshrink: {same}; device a call "
          f"kernel {k_dev * 1e3:.2f} us ({k_n:.2f} kernels), softshrink {l_dev * 1e3:.2f} us ({l_n:.2f}); per "
          f"call, mean of {TIMED_CALLS}, in turns: kernel {k_ms[0]:.4f} and {k_ms[1]:.4f} ms, softshrink "
          f"{l_ms[0]:.4f} and {l_ms[1]:.4f} ms (card: {card})")
    if not same:
        raise SystemExit("[23c] the soft threshold at one tau differs from softshrink")
    entry = {k["name"]: k for k in kernels}
    entry["soft_threshold"].update(library_ms=min(l_ms), library_device_ms=l_dev, ms_one_tau=min(k_ms),
                                   device_ms_one_tau=k_dev)
    print(f"[23c] {time.perf_counter() - t0:.1f} s (host clock)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the GPU", file=sys.stderr)
        return 1

    from jstsp19_torch.bench import NOISE_VAR_0DB, REPS, card_line, cuda_event_times, device_ms, time_route
    from jstsp19_torch.core import prng
    from jstsp19_torch.core.metrics import clamped_nmse
    from jstsp19_torch.harness.pipeline import PointConfig, fused_point_errors, proposed_problem
    from jstsp19_torch import __main__ as cli
    from jstsp19_torch.harness import hadamard_cs as hcs
    from jstsp19_torch.kernels import admm_fused, dictionary, softthresh, wht
    from jstsp19_torch.kernels.admm_fused import fused_tracked_admm, fused_tracked_admm_plain
    from jstsp19_torch.kernels.build import KERNELS, build_all, library_path
    from jstsp19_torch.kernels.dictionary import dict_correlation, dict_correlation_plain
    from jstsp19_torch.kernels.softthresh import fused_soft_threshold, fused_soft_threshold_plain
    from jstsp19_torch.kernels.wht import fwht_kernel, fwht_plain, ifwht_plain
    from jstsp19_torch.solvers.admm import proposed_admm
    from jstsp19_torch.solvers.gamp import gamp
    from jstsp19_torch.solvers.gamp_full import gamp_est

    root = pathlib.Path(__file__).resolve().parent
    dev = torch.device("cuda")

    # ---- 0. the card -----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[0] device: {kind}; nvidia-smi: {card}")

    # ---- 1. build: one nvcc per kernel source, all started together -------------
    build_seconds = build_all(KERNELS)
    for module in (admm_fused, dictionary, softthresh, wht):
        module._library()
    _print_build("[1]", "admm_fused", build_seconds)
    # the CPU's halves of [23]'s, [21]'s and [22]'s card-against-CPU checks, in a process beside phases [2]-[20]
    cpu_21, cpu_22, cpu_23 = _start_cpu_halves()

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

    Bt, N, M = prob["subY"].shape
    Gr, K = prob["A"].shape[-1], prob["B"].shape[-2]
    admm_bound = _bound(_nbytes(*args, S_k) + Bt * N * M * 8,  # the inputs, S and Y (complex64)
                        _admm_flops(Bt, N, M, Gr, K, IMAX_MAIN))
    print(f"[4] bound at B={Bt}, Imax={IMAX_MAIN}: {admm_bound[0]:.3f} ms, set by {admm_bound[1]} "
          f"({_admm_flops(Bt, N, M, Gr, K, IMAX_MAIN) / 1e9:.3f} GFLOP of complex products)")

    kernels = [{
        "name": "fused_tracked_admm",
        "route": "cuda",
        "source": "jstsp19_torch/kernels/csrc/admm_fused.cu",
        "replaces": "jstsp19_tpu/kernels/admm_fused.py:361",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": admm_bound[0],
        "bound_by": admm_bound[1],
        "library_ms": None,
    }]

    # ---- 5. the second slice's kernels: build report -------------------------------
    for name in ("dict_correlation", "soft_threshold"):
        _print_build("[5]", name, build_seconds)

    # ---- 6. each kernel against its plain version at the slice's shapes --------------
    g = torch.Generator(device=dev).manual_seed(6)

    def crandn(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.complex64)

    B = B_MAIN
    dict_cases = [  # (what, A, K, B)
        ("errorVSnrf ADMM", crandn(B, 32, 32), crandn(B, 32, 20), crandn(B, 16, 20)),
        *((f"VAMP adjoint Mr={mr}", crandn(B, mr, 32), crandn(B, mr, 16), crandn(B, 16, 16))
          for mr in NRF_MR),
        ("canonical, shared A and B", crandn(32, 32), crandn(B, 32, 140), crandn(16, 140)),
        ("canonical, per realization", crandn(B, 32, 32), crandn(B, 32, 140), crandn(B, 16, 140)),
        ("errorVSnrf ADMM Mr=16", crandn(B, 32, 32), crandn(B, 32, 80), crandn(B, 16, 80)),
    ]
    dict_err = 0.0
    dict_device = []
    for what, A_, K_, B_ in dict_cases:
        out_k = dict_correlation(A_, K_, B_)
        ref = dict_correlation_plain(A_, K_, B_)
        torch.cuda.synchronize()
        err, scale = float((out_k - ref).abs().max()), float(ref.abs().max())
        ok = err <= 1e-5 * scale
        dict_err = max(dict_err, err)
        print(f"[6] dict_correlation {what}: K {tuple(K_.shape)}, A {tuple(A_.shape)}, B {tuple(B_.shape)}: "
              f"max|d|={err:.3e} <= 1e-5*max|ref|={1e-5 * scale:.3e}: {ok}")
        if not ok:
            raise SystemExit("[6] dict_correlation disagrees with its plain version")
        Nk, Mk = K_.shape[-2:]
        Grk, Kdk = A_.shape[-1], B_.shape[-2]
        plan = dictionary.plan(Nk, Mk, Grk, Kdk)
        d_ms, launched = device_ms(lambda: dict_correlation(A_, K_, B_), match="dict_correlation")
        call_ms = _per_call_ms(lambda: dict_correlation(A_, K_, B_))
        bound = _bound(_nbytes(A_, K_, B_) + B * Grk * Kdk * 8, 8.0 * B * (Nk * Mk * Kdk + Grk * Nk * Kdk))
        dict_device.append(d_ms)
        print(f"[6]   plan {plan.rpb} realization(s) a block, tk {plan.tk}, tiles of {plan.mt} columns, "
              f"{plan.smem_bytes} B shared; device {d_ms * 1e3:.2f} us in {launched:.0f} kernel(s) a call, "
              f"{call_ms * 1e3:.2f} us a call of {TIMED_CALLS} back to back; bound {bound[0] * 1e3:.3f} us "
              f"({bound[1]}), {100 * bound[0] / d_ms:.1f}% of it (card: {card})")
    v = crandn(B, 32, 16) * 0.3
    tau_shared = 0.2
    tau_per = torch.rand(B, 1, 1, generator=g, device=dev) * 0.4
    soft_err = 0.0
    soft_device = []
    for what, tau in (("shared tau", tau_shared), ("per-matrix tau", tau_per)):
        out_k = fused_soft_threshold(v, tau)
        ref = fused_soft_threshold_plain(v, tau)
        torch.cuda.synchronize()
        err = float((out_k - ref).abs().max())
        soft_err = max(soft_err, err)
        d_ms, launched = device_ms(lambda: fused_soft_threshold(v, tau), match="soft_threshold")
        call_ms = _per_call_ms(lambda: fused_soft_threshold(v, tau))
        soft_device.append(d_ms)
        print(f"[6] soft_threshold {what}, v {tuple(v.shape)}: max|d|={err:.3e} <= 1e-6: {err <= 1e-6}; "
              f"device {d_ms * 1e3:.2f} us in {launched:.0f} kernel(s) a call, {call_ms * 1e3:.2f} us a call "
              f"of {TIMED_CALLS} back to back (card: {card})")
        if not err <= 1e-6:
            raise SystemExit("[6] soft_threshold disagrees with its plain version")
    _, A_, K_, B_ = dict_cases[0]
    dict_ms = _per_call_ms(lambda: dict_correlation(A_, K_, B_))
    dict_plain_ms = _per_call_ms(lambda: dict_correlation_plain(A_, K_, B_))
    soft_ms = _per_call_ms(lambda: fused_soft_threshold(v, tau_per))
    soft_plain_ms = _per_call_ms(lambda: fused_soft_threshold_plain(v, tau_per))
    # one PyTorch call computing Aᴴ·K·Bᴴ (conj() is a lazy view): the einsum
    dict_library_ms = _per_call_ms(lambda: torch.einsum("...ng,...nm,...km->...gk", A_.conj(), K_, B_.conj()))
    print(f"[6] per call, mean of {TIMED_CALLS}: dict_correlation {dict_ms:.4f} ms (plain {dict_plain_ms:.4f} ms, "
          f"one einsum {dict_library_ms:.4f} ms) at K {tuple(K_.shape)}; soft_threshold {soft_ms:.4f} ms "
          f"(plain {soft_plain_ms:.4f} ms) at v {tuple(v.shape)} (card: {card})")
    Nk, Mk = K_.shape[-2:]
    Grk, Kdk = A_.shape[-1], B_.shape[-2]
    # Aᴴ·(K·Bᴴ), the cheaper association: N·M·Kd + Gr·N·Kd complex multiply-adds a matrix
    dict_bound = _bound(_nbytes(A_, K_, B_) + B * Grk * Kdk * 8, 8.0 * B * (Nk * Mk * Kdk + Grk * Nk * Kdk))
    soft_bound = _bound(_nbytes(v, tau_per, v), 6.0 * v.numel())
    print(f"[6] bounds: dict_correlation {dict_bound[0] * 1e3:.3f} us ({dict_bound[1]}), "
          f"soft_threshold {soft_bound[0] * 1e3:.3f} us ({soft_bound[1]})")

    # ---- 7. the second slice: the errorVSnrf sweep through the CLI ------------------
    dict_correlation.launches = 0
    fused_soft_threshold.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        tee = _Tee()
        with contextlib.redirect_stdout(tee):
            rc = cli.main(["run", "error_vs_nrf", "--n-mc", str(B_MAIN), "--no-plot", "--out", tmp])
        torch.cuda.synchronize()
        dict_launches, soft_launches = dict_correlation.launches, fused_soft_threshold.launches
        if rc != 0:
            raise SystemExit(f"[7] the CLI exited {rc}")
        res = json.loads((pathlib.Path(tmp) / "error_vs_nrf.json").read_text())
    nrf_res = res
    need = len(NRF_MR) * 2 * IMAX_MAIN
    print(f"[7] launches: dict_correlation {dict_launches}, soft_threshold {soft_launches} "
          f"(need >= {need} each)")
    if dict_launches < need or soft_launches < need:
        raise SystemExit("[7] the slice did not go through both kernels")
    times = nrf_times = dict(re.findall(r"Mr=(\d+): .* \[([0-9.]+) s\]", tee.getvalue()))
    for mr in NRF_MR:
        print(f"[7] point Mr={mr}: wall {float(times[str(mr)]):.3f} s at n_mc={B_MAIN} (card: {card})")
    ref = _sweep_reference(root, "error_vs_nrf")
    if res["sweep"]["Mr"] != [float(m) for m in NRF_MR] or set(res["curves"]) != set(ref):
        raise SystemExit("[7] the JSON does not hold the JAX artifact's sweep and methods")
    for m in sorted(ref):
        for i, mr in enumerate(NRF_MR):
            mean, sd, n = _stats(res["raw"][m][i])
            r_mean, r_sd, r_n = ref[m][i]
            se = math.sqrt(r_sd**2 / r_n + sd**2 / n)
            val = res["curves"][m][i]
            ok = math.isfinite(val) and 0.0 <= val <= 1.0 and abs(mean - r_mean) <= 4 * se
            print(f"[7] {m} Mr={mr}: mean {mean:.6f} (sd {sd:.4f}, n {n}) vs JAX {r_mean:.6f} "
                  f"(sd {r_sd:.4f}, n {r_n}): z {(mean - r_mean) / se:+.2f}, within 4 SE and in [0, 1]: {ok}")
            if not ok:
                raise SystemExit(f"[7] {m} at Mr={mr} outside the 4-sigma band or [0, 1]")

    # ---- 8. one errorVSnrf point, unfused route, kernels on and off -------------------
    pc8 = PointConfig(Mr=16, T=5, methods=("proposed",))
    prob = proposed_problem(prng.realization_generators(0, 3, dev), pc8, NV_5DB, B_MAIN)
    args = [prob[k] for k in ("subY", "Omega", "A", "B")]
    hp = [prob[k] for k in ("tau_Y", "tau_S", "rho")]

    def solve(use_kernels):
        return proposed_admm(*args, IMAX_MAIN, *hp, use_kernels=use_kernels).S

    e_on = clamped_nmse(solve(True), prob["Zbar"])
    e_off = clamped_nmse(solve(False), prob["Zbar"])
    ok = bool(torch.allclose(e_on, e_off, rtol=2e-3, atol=2e-4))
    print(f"[8] Mr=16 point, B={B_MAIN}, Imax={IMAX_MAIN}: mean NMSE kernels on {float(e_on.mean()):.6f}, "
          f"off {float(e_off.mean()):.6f}; max per-realization |dNMSE| = {float((e_on - e_off).abs().max()):.3e}; "
          f"within rtol 2e-3, atol 2e-4: {ok}")
    if not ok:
        raise SystemExit("[8] kernels on and off disagree")
    for label, flag in (("kernels on", True), ("kernels off", False), ("kernels on", True), ("kernels off", False)):
        t, _ = cuda_event_times(lambda r: solve(flag), REPS)
        best, median = min(t), sorted(t)[len(t) // 2]
        print(f"[8] unfused solve, {label}: best {best * 1e3:.3f} ms, median {median * 1e3:.3f} ms, "
              f"spread {(max(t) - best) * 1e3:.3f} ms over {REPS} reps (card: {card})")

    kernels += [{
        "name": "dict_correlation",
        "route": "cuda",
        "source": "jstsp19_torch/kernels/csrc/dict_correlation.cu",
        "replaces": "jstsp19_tpu/kernels/dictionary.py:79",
        "launches": dict_launches,
        "max_abs_err": dict_err,
        "ms": dict_ms,
        "plain_ms": dict_plain_ms,
        "bound_ms": dict_bound[0],
        "bound_by": dict_bound[1],
        "library_ms": dict_library_ms,
        "device_ms": dict_device[0],  # torch.profiler at K (256, 32, 20), without the wrapper's host cost
    }, {
        "name": "soft_threshold",
        "route": "cuda",
        "source": "jstsp19_torch/kernels/csrc/soft_threshold.cu",
        "replaces": "jstsp19_tpu/kernels/softthresh.py:30",
        "launches": soft_launches,
        "max_abs_err": soft_err,
        "ms": soft_ms,
        "plain_ms": soft_plain_ms,
        "bound_ms": soft_bound[0],
        "bound_by": soft_bound[1],
        "library_ms": None,  # [23c]: softshrink at one τ for all (the path passes one per matrix)
        "device_ms": soft_device[1],  # torch.profiler, per-matrix τ
    }]

    # ---- 9. the third slice's kernel: build report ------------------------------------
    print(f"[9] built {library_path('fwht').name} in {build_seconds['fwht']:.3f} s (all kernels built together)")
    for name, line in _ptxas_report(library_path("fwht").with_suffix(".log").read_text()).items():
        print(f"[9] {name}: {line}")

    # ---- 10. the FWHT kernel against its plain version ---------------------------------
    fwht_err = 0.0
    for n in FWHT_NS:
        rows = max(2, min(256, (1 << 21) // n))
        for dtype in (torch.float32, torch.complex64):
            x = torch.randn(rows, n, generator=g, device=dev, dtype=dtype)
            plan = wht.plan_fwht(n, x.element_size())
            for ordering in ("natural", "sequency"):
                for inverse in (False, True):
                    out_k = fwht_kernel(x, ordering, inverse=inverse)
                    ref = (ifwht_plain if inverse else fwht_plain)(x, ordering)
                    torch.cuda.synchronize()
                    err = float((out_k - ref).abs().max())
                    fwht_err = max(fwht_err, err)
                    ok = torch.equal(out_k, ref)
                    print(f"[10] fwht ({rows}, {n}) {str(dtype)[6:]} {ordering} {'inverse' if inverse else 'forward'} "
                          f"({plan.path}, cluster {plan.cluster}, {plan.threads} threads): max|d|={err:.3e}; "
                          f"bit-equal: {ok}")
                    if not ok:
                        raise SystemExit("[10] the FWHT kernel is not bit-equal to its plain version")
    x_main = torch.randn(hcs.BATCH, hcs.N, generator=g, device=dev)
    fwht_ms = _per_call_ms(lambda: fwht_kernel(x_main))
    fwht_plain_ms = _per_call_ms(lambda: fwht_plain(x_main))
    fwht_bound = _bound(_nbytes(x_main, x_main), x_main.numel() * math.log2(hcs.N))
    fwht_device = {}
    for rows, n, inverse in ((hcs.BATCH, hcs.N, False), (hcs.BATCH, hcs.N, True), (256, 4096, False),
                             (4, 1 << 20, False)):
        x = x_main if n == hcs.N else torch.randn(rows, n, generator=g, device=dev)
        d_ms, launched = device_ms(lambda: fwht_kernel(x, inverse=inverse))
        fwht_device[(rows, n, inverse)] = d_ms
        bound = _bound(_nbytes(x, x), x.numel() * math.log2(n))
        print(f"[10] device time a call, float32 sequency {'inverse' if inverse else 'forward'} ({rows}, {n}), "
              f"{wht.plan_fwht(n, 4).path} path: {d_ms * 1e3:.2f} us in {launched:.0f} kernel(s) a call; bound "
              f"{bound[0] * 1e3:.2f} us ({bound[1]}), {100 * bound[0] / d_ms:.1f}% of it (card: {card})")
    x_small = torch.randn(256, 4096, generator=g, device=dev)
    Wt = _walsh_t(4096, dev)
    small = [_per_call_ms(f) for f in (lambda: fwht_kernel(x_small), lambda: fwht_plain(x_small),
                                        lambda: torch.matmul(x_small, Wt))]
    mm_err = float((torch.matmul(x_small, Wt) - fwht_plain(x_small)).abs().max())
    print(f"[10] per call, mean of {TIMED_CALLS}, float32 sequency forward: ({hcs.BATCH}, {hcs.N}) kernel "
          f"{fwht_ms:.4f} ms, plain {fwht_plain_ms:.4f} ms, bound {fwht_bound[0] * 1e3:.3f} us ({fwht_bound[1]}); "
          f"(256, 4096) kernel {small[0]:.4f} ms, plain {small[1]:.4f} ms, dense Walsh matmul {small[2]:.4f} ms "
          f"(max|d| to plain {mm_err:.2e}) (card: {card})")
    del Wt
    Wt = _walsh_t(hcs.N, dev)  # 17.2 GB: one dense product is the only single PyTorch call at this size
    fwht_library_ms = _per_call_ms(lambda: torch.matmul(x_main, Wt), calls=10)
    mm_err = float((torch.matmul(x_main, Wt) - fwht_plain(x_main)).abs().max())
    print(f"[10] dense Walsh matmul at ({hcs.BATCH}, {hcs.N}): {fwht_library_ms:.3f} ms per call, mean of 10 "
          f"(max|d| to plain {mm_err:.2e}) (card: {card})")
    del Wt
    torch.cuda.empty_cache()

    # ---- 11. the third slice: partial Walsh–Hadamard CS through the GAMP core ----------
    prob_cs = hcs.hadamard_cs_problem()
    ref_cs = json.loads((root / "results" / "torch_gamp_fwht_jax.json").read_text())
    routes = {flag: hcs.hadamard_cs_torch(prob_cs, dev, use_kernel=flag) for flag in (True, False)}

    def solve_cs(solver, flag):
        prior, like, op = routes[flag]
        if solver == "gamp_est":
            fin, _, _ = gamp_est(prior, like, op)
            return fin.xhat, int(fin.nit.max())
        return gamp(prior, like, op, nit=hcs.GAMP_NIT, step=hcs.GAMP_STEP).x, hcs.GAMP_NIT

    fwht_launches = 0
    iterations = {}
    for solver in ("gamp_est", "gamp"):
        fwht_kernel.launches = 0
        xhat, its = solve_cs(solver, True)
        torch.cuda.synchronize()
        n_launch = fwht_kernel.launches
        fwht_launches += n_launch
        iterations[solver] = its
        print(f"[11] {solver}: fwht_kernel launches = {n_launch} over {its} iterations (need >= {2 * its})")
        if n_launch < 2 * its:
            raise SystemExit(f"[11] {solver} did not go through the FWHT kernel")
        xhat_off, _ = solve_cs(solver, False)
        e_on = hcs.nmse_db(xhat.cpu().numpy(), prob_cs["x"])
        e_off = hcs.nmse_db(xhat_off.cpu().numpy(), prob_cs["x"])
        lin_on, lin_off = 10 ** (e_on / 10), 10 ** (e_off / 10)
        rel = float(np.max(np.abs(lin_on - lin_off) / lin_off))
        ok = bool(np.all(np.isfinite(e_on)) and rel <= 0.01)
        print(f"[11] {solver}: NMSE kernel on {e_on.mean():.4f} dB, off {e_off.mean():.4f} dB; max per-realization "
              f"relative |dNMSE| = {rel:.3e}; finite and within 1%: {ok}")
        if not ok:
            raise SystemExit(f"[11] {solver}: NMSE not finite or kernel on and off disagree")
        r = ref_cs[solver]
        mean, sd, n = float(e_on.mean()), float(e_on.std(ddof=1)), e_on.size
        se = math.sqrt(r["sd_db"] ** 2 / len(r["nmse_db"]) + sd**2 / n)
        inside = abs(mean - r["mean_db"]) <= 4 * se
        worst = float(np.max(np.abs(e_on - np.asarray(r["nmse_db"]))))
        print(f"[11] {solver}: batch mean {mean:.4f} dB (sd {sd:.4f}, n {n}) vs JAX {r['mean_db']:.4f} dB "
              f"(sd {r['sd_db']:.4f}): z {(mean - r['mean_db']) / se:+.2f}, within 4 SE: {inside}; "
              f"largest per-realization |d dB| against JAX {worst:.4f}")
        if not inside:
            raise SystemExit(f"[11] {solver}: batch mean NMSE outside 4 SE of the JAX reference")

    # ---- 12. both solvers timed, kernel on and off ------------------------------------
    for solver in ("gamp_est", "gamp"):
        for label, flag in (("kernel on", True), ("kernel off", False), ("kernel on", True), ("kernel off", False)):
            t, _ = cuda_event_times(lambda r: solve_cs(solver, flag), REPS)
            best, median = min(t), sorted(t)[len(t) // 2]
            print(f"[12] {solver} ({iterations[solver]} iterations), {label}: best {best * 1e3:.3f} ms, "
                  f"median {median * 1e3:.3f} ms, spread {(max(t) - best) * 1e3:.3f} ms over {REPS} reps "
                  f"(card: {card})")

    # ---- 13. the fused ADMM kernel at every fused-route sweep shape and errorVSnrf's -----
    ptxas = _ptxas_report(library_path("admm_fused").with_suffix(".log").read_text())
    shapes13 = [(label, changes, NOISE_VAR_0DB, B_CHECK) for label, changes in SWEEP_SHAPES]
    shapes13 += [(NRF_KERNEL[0], NRF_KERNEL[1], NRF_KERNEL[2], batch) for batch in (B_CHECK, B_NRF)]
    for label, changes, nv, batch in shapes13:
        args, rank13 = _kernel_problem(changes, nv, batch, 13, dev)
        _, N13, M13 = args[0].shape
        Gr13, K13 = args[2].shape[-1], args[3].shape[-2]
        plan = admm_fused.plan(N13, M13, Gr13, K13)
        inst = admm_fused.instance(N13, Gr13, K13)
        line = next((v for k, v in ptxas.items() if _mangled(inst) in k), "not found")
        print(f"[13] {label} B={batch}: N={N13} M={M13} Gr={Gr13} K={K13}: plan tile {plan.tw}, "
              f"{plan.blocks_per_sm} block(s) per SM by shared memory, {plan.smem_bytes} B shared; {inst}: "
              f"{admm_fused.blocks_per_sm(N13, Gr13, K13, plan.smem_bytes)} block(s) per SM on the card; "
              f"ptxas: {line}")
        for rank in (None, rank13):
            S_k, Y_k = fused_tracked_admm(*args, Imax=IMAX_CHECK, support_rank=rank)
            S_p, _ = fused_tracked_admm_plain(*args, Imax=IMAX_CHECK, support_rank=rank)
            torch.cuda.synchronize()
            err, scale = float((S_k - S_p).abs().max()), float(S_p.abs().max())
            finite = bool(torch.isfinite(torch.view_as_real(Y_k)).all())
            ok = err <= 2e-4 * scale and finite
            max_abs_err = max(max_abs_err, err)
            print(f"[13]   support={'rank' if rank is not None else 'none'}: max|dS|={err:.3e} "
                  f"<= 2e-4*max|S|={2e-4 * scale:.3e}: {err <= 2e-4 * scale}; Y finite: {finite}")
            if not ok:
                raise SystemExit(f"[13] {label}: the kernel disagrees with its plain version")
    kernels[0]["max_abs_err"] = max_abs_err

    # ---- 14. the fused ADMM kernel timed at five batch sizes and shapes ---------------
    for label, changes, nv, batch in (("canonical", {}, NOISE_VAR_0DB, 1), ("canonical", {}, NOISE_VAR_0DB, 132),
                                      ("canonical", {}, NOISE_VAR_0DB, B_MAIN),
                                      ("errorVSnt Nt=12 (M=420, K=48)", dict(Nt=12, Gt=12, beamformer="fft"),
                                       NOISE_VAR_0DB, B_MAIN),
                                      (*NRF_KERNEL, B_NRF)):
        args, _ = _kernel_problem(changes, nv, batch, 0, dev)
        Bt, N14, M14 = args[0].shape
        Gr14, K14 = args[2].shape[-1], args[3].shape[-2]
        t, _ = cuda_event_times(lambda r: fused_tracked_admm(*args, Imax=IMAX_MAIN), REPS)
        t = sorted(1e3 * x for x in t)
        flops = _admm_flops(Bt, N14, M14, Gr14, K14, IMAX_MAIN)
        bound = _bound(_nbytes(*args) + Bt * (Gr14 * K14 + N14 * M14) * 8, flops)
        print(f"[14] {label} B={Bt}, Imax={IMAX_MAIN}: best {t[0]:.3f} ms, median {t[len(t) // 2]:.3f} ms, "
              f"spread {t[-1] - t[0]:.3f} ms over {REPS} reps; bound {bound[0]:.3f} ms ({bound[1]}, "
              f"{flops / 1e9:.3f} GFLOP), {100 * bound[0] / t[0]:.1f}% of it; {admm_fused.instance(N14, Gr14, K14)} "
              f"(card: {card})")

    # ---- 15. the fourth slice: the specialized recipes through the CLI ---------------
    special = _special_recipes(root, dev, card, cli, dict_correlation, dict_correlation_plain, dictionary,
                               fused_soft_threshold, fused_soft_threshold_plain)
    for k, (name, err) in zip(kernels[1:3], (("dict_correlation", special["dict_err"]),
                                             ("soft_threshold", special["soft_err"]))):
        k["max_abs_err"] = max(k["max_abs_err"], err)
        k["launches_by_path"] = {"error_vs_nrf": k["launches"], "specialized recipes": special[name]}
        k["launches"] += special[name]

    # ---- 16. the fifth slice: the remaining errorVSsnr families ------------------------
    families = _families(root, dev, card, cli, {"fused_tracked_admm": fused_tracked_admm,
                                                "dict_correlation": dict_correlation,
                                                "soft_threshold": fused_soft_threshold})
    kernels[0]["launches_by_path"] = {"canonical point [3]": kernels[0]["launches"]}
    for k in kernels[:3]:
        for path, n in families[k["name"]].items():
            if n:
                k["launches_by_path"][path] = n
                k["launches"] += n

    # ---- 17. the sixth slice: precision, --distributed, the dryrun, panel, npz ----------
    slice10 = _distributed(root, dev, card, cli, nrf_res, nrf_times, {"fused_tracked_admm": fused_tracked_admm,
                                                                   "dict_correlation": dict_correlation,
                                                                   "soft_threshold": fused_soft_threshold})
    for k in kernels[:3]:
        for path, n in slice10[k["name"]].items():
            if n:
                k["launches_by_path"][path] = n
                k["launches"] += n

    # ---- 18. the seventh slice: mean removal and the estimator library --------------
    demean_launches = _mean_removal(root, dev, card, prob_cs, routes)

    # ---- 19. the eighth slice: amp_est, S-AMP, sparse_admm, vamp_slm, the operators ---
    tail = _amp_sparse(root, dev, card, prob_cs)
    for k in kernels[1:3]:
        k["max_abs_err"] = max(k["max_abs_err"], tail["errs"][k["name"]])
        for path, n in tail["paths"][k["name"]].items():
            k["launches_by_path"][path] = n
            k["launches"] += n

    # ---- 20. the ninth slice: EM learning and the turbo solvers ------------------------
    em_paths = _em_turbo(root, dev, card)
    for path, n in em_paths["dict_correlation"].items():
        kernels[1]["launches_by_path"][path] = n
        kernels[1]["launches"] += n
    tail["paths"]["fwht"].update(em_paths["fwht"])

    # [23]'s checks in a process of their own, beside [21] and [22] (their CPU half ran in the CPU halves' process)
    routes_23 = _start_routes_card_half(cpu_23)

    # ---- 21. the tenth slice: the bilinear solvers (no kernel on this path) -------------
    _bilinear(root, dev, card, {"fused_tracked_admm": fused_tracked_admm, "dict_correlation": dict_correlation,
                                "soft_threshold": fused_soft_threshold, "fwht": fwht_kernel}, cpu_21)

    # ---- 22. the eleventh slice: the worked examples -------------------------------------
    examples = _examples(root, dev, card, cpu_22)
    for k in kernels[:3]:
        k["launches_by_path"]["examples [22]"] = examples[k["name"]]
        k["launches"] += examples[k["name"]]
    tail["paths"]["fwht"]["examples [22]"] = examples["fwht"]

    kernels.append({
        "name": "fwht",
        "route": "cuda",
        "source": "jstsp19_torch/kernels/csrc/fwht.cu",
        "replaces": "jstsp19_tpu/kernels/wht.py:46",
        "launches": fwht_launches + demean_launches + sum(tail["paths"]["fwht"].values()),
        "launches_by_path": {"partial Hadamard GAMP [11]": fwht_launches, "mean removal [18]": demean_launches,
                             **tail["paths"]["fwht"]},
        "max_abs_err": fwht_err,
        "ms": fwht_ms,
        "plain_ms": fwht_plain_ms,
        "bound_ms": fwht_bound[0],
        "bound_by": fwht_bound[1],
        "library_ms": fwht_library_ms,
        "device_ms": fwht_device[(hcs.BATCH, hcs.N, False)],  # torch.profiler, without the wrapper's host cost
    })

    # ---- 23. the twelfth slice: the host library and the routes by dtype and shape ----------
    kernels[3]["native_oracle_max_abs_err"] = _routes_result(routes_23)
    _softshrink_times(dev, card, kernels)
    cpu_21[0].join(timeout=60)  # it has put its last result
    if cpu_21[0].is_alive():
        cpu_21[0].terminate()
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
