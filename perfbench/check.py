"""Whether what the window produced is correct, by the plain reference.

Every answer of the window (each method's clamped NMSE of each realization
of each point) is checked for being there, finite and in [0, 1].  A sample
of the points drawn from the seed (one of each distinct shape, and
``EXTRA_POINTS`` more) is compared with the reference at its full size, layer
by layer:

The check follows the route that each point runs (``perfbench/system.py``):
the program's front end and solve are taken from the calls of that route,
the fused kernel's or the tracked chain's, and held to the same reference,
whose tracked SVT is the mathematics of both.  :func:`follows` refuses,
before any point runs, a cell whose points would run a route or a method
that the reference does not compute.

- the front end, from the point's random numbers: the program's
  (``proposed_problem`` on the fused route, ``point_draws`` and
  ``_proposed_frontend`` on the tracked) against the reference's,
  ``frontend_rel_err`` (Zbar,
  the observation, A, B, tau_Y, tau_S and rho, each as max|difference| over
  max|reference|, the largest) and ``omega_mismatch`` (entries of the
  sampling mask that differ, exact);
- the oracle order that Algorithm 3 takes from Zbar: the program's against
  the reference's order of the program's own Zbar, ``rank_mismatch`` (exact);
- the solve, from the program's front end: the estimate S of each method
  (``fused_tracked_admm``, or ``proposed_admm`` and ``proposed_admm_angles``
  on the tracked route) against the reference's ADMM on the same
  problem, ``s_rel_err`` (per realization max|difference| over
  max|reference|, the largest);
- the answers: the window's NMSE against the reference's NMSE of that S,
  ``nmse_gap`` (the largest absolute difference);
- ``answers_missing``: answers of the window missing, non-finite or out of
  [0, 1] (exact).

Where the traffic holds a baseline (``ls``, ``vamp``, ``omp_mmv``), the
conventional receiver's branch is compared too, with numbers of its own
(:data:`BASELINE_NUMBERS`); a traffic of the proposed pair alone compares
the six above and nothing else:

- its front end, ``pipeline.conventional_problem``'s against the
  reference's, ``conv_frontend_rel_err`` (Y_c, A_c, B_c and Zbar, each as
  max|difference| over max|reference|, the largest);
- the estimates of LS and MMV-OMP on the program's conventional problem
  against the reference's on the same, ``baseline_s_rel_err`` (per
  realization, the largest);
- VAMP's estimate there, ``vamp_s_min_rel_err``: the point's smallest
  per-realization gap.  At the script's noise variance 1 VAMP does not
  settle on most realizations: from about its 25th iteration float32
  rounding decides its path, and keep-best picks among those iterates, so
  the program's and the reference's estimates (or the reference's own in
  float32 and float64) part by up to the estimate's size on most
  realizations whatever either does; on the realizations where the iteration
  settles first they agree to float32 rounding, and the smallest gap is
  theirs;
- VAMP over every realization, ``vamp_mean_nmse_gap``: the mean of the
  point's VAMP answers of the window against the mean of the reference's
  NMSE of the reference's estimate (the curve's value at the point), the
  absolute difference.  Rounding's paths average out over the point, so a
  VAMP that is wrong on some realizations alone (half of the batch left at
  its start) shows here, where the smallest gap holds only the easiest;
- the answers, ``baseline_nmse_gap``: each LS and MMV-OMP answer of the
  window against the reference's NMSE of the reference's estimate, each
  VAMP answer against the reference's NMSE of the program's own estimate
  (the NMSE, its clamp and its copy to the host), the largest absolute
  difference.

The solve is compared on the program's front end, and the front end by
itself, because the oracle order is not continuous in Zbar: where two
entries of |Zbar| lie within rounding of each other, the program's and the
reference's float32 Zbar can order them apart, and Algorithm 3 then admits
them at other iterations.  The comparison runs after the window, once the
program's state is freed.
"""
from __future__ import annotations

import gc
import random
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from perfbench import reference
from perfbench.traffic import Point

EXTRA_POINTS = 2
UNREADABLE = 1e300  # what a number reads where its comparison gave no finite value (the result line is JSON)
FRONTEND_KEYS = ("Zbar", "subY", "A", "B", "tau_Y", "tau_S", "rho")
NUMBERS = ("frontend_rel_err", "omega_mismatch", "rank_mismatch", "s_rel_err", "nmse_gap", "answers_missing")
CONVENTIONAL_KEYS = ("Y_c", "A_c", "B_c", "Zbar")
BASELINE_NUMBERS = ("conv_frontend_rel_err", "baseline_s_rel_err", "vamp_s_min_rel_err", "vamp_mean_nmse_gap",
                    "baseline_nmse_gap")


def numbers(methods) -> Tuple[str, ...]:
    """The numbers compared for a traffic of ``methods``: :data:`NUMBERS`,
    and :data:`BASELINE_NUMBERS` after them where a baseline is among the
    methods."""
    return NUMBERS + BASELINE_NUMBERS if set(methods) & set(reference.BASELINES) else NUMBERS


def follows(system, points: Sequence[Point], route: str) -> None:
    """Raise ValueError where a point of ``points`` would run another route
    than ``route`` (the traffic's) or one that the reference cannot hold
    the program to: a route or method it has no code for."""
    for pt in points:
        ran = system.route(pt)
        if ran != route:
            raise ValueError(f"point {pt.params} would run on the {ran!r} route, not the traffic's {route!r}")
        gaps = reference.lacks(pt.params, pt.methods, ran)
        if gaps:
            raise ValueError(f"the check cannot follow point {pt.params} on the {ran!r} route: "
                             f"perfbench/reference/ has no code for {'; '.join(gaps)}")


def answer_faults(pt: Point, answers: Dict[str, np.ndarray]) -> Tuple[int, int]:
    """(answers of ``pt`` missing, non-finite or outside [0, 1]; realizations
    with such an answer).  An array of another length than n_mc counts
    every answer of its method as missing."""
    ok_all = np.ones(pt.n_mc, dtype=bool)
    bad = 0
    for m in pt.methods:
        a = np.asarray(answers.get(m, np.empty(0)), dtype=np.float64).reshape(-1)
        ok = np.isfinite(a) & (a >= 0.0) & (a <= 1.0) if a.size == pt.n_mc else np.zeros(pt.n_mc, dtype=bool)
        bad += int((~ok).sum())
        ok_all &= ok
    return bad, int((~ok_all).sum())


def sample(points: Sequence[Point], seed: int) -> List[Point]:
    """One completed point of each distinct shape and ``EXTRA_POINTS`` more,
    drawn from ``seed``; in the order they ran."""
    rng = random.Random(seed)
    by_shape: Dict[tuple, List[Point]] = {}
    for pt in points:
        by_shape.setdefault(pt.fields, []).append(pt)
    chosen = {rng.choice(group).k for group in by_shape.values()}
    rest = [pt.k for pt in points if pt.k not in chosen]
    chosen.update(rng.sample(rest, min(EXTRA_POINTS, len(rest))))
    return [pt for pt in points if pt.k in chosen]


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a.to(ref.dtype) - ref).abs().max() / ref.abs().max())


def compare_point(system, pt: Point, answers: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The compared numbers of one point (all but ``answers_missing``)."""
    ref_prob = reference.problem(pt.params, pt.noise_var, pt.n_mc, system.seed, pt.k, system.device)
    prob = system.problem(pt)
    out = dict(frontend_rel_err=max(_rel(prob[key], ref_prob[key]) for key in FRONTEND_KEYS),
               omega_mismatch=float((prob["Omega"] != ref_prob["Omega"]).sum()),
               rank_mismatch=float((prob["rank"] != reference.oracle_rank(prob["Zbar"])).sum()),
               s_rel_err=0.0, nmse_gap=0.0)
    del ref_prob
    for m in (m for m in pt.methods if m not in reference.BASELINES):
        S = system.solve(pt, prob, m)
        S_ref = reference.solve(prob, pt.params, m)
        scale = S_ref.abs().amax(dim=(-2, -1))
        out["s_rel_err"] = max(out["s_rel_err"], float(((S - S_ref).abs().amax(dim=(-2, -1)) / scale).max()))
        nmse_ref = reference.clamped_nmse(S_ref, prob["Zbar"]).cpu().numpy()
        got = np.asarray(answers.get(m, np.empty(0)), dtype=np.float64).reshape(-1)
        if got.shape != nmse_ref.shape:
            out["nmse_gap"] = UNREADABLE
        else:
            out["nmse_gap"] = max(out["nmse_gap"], float(np.abs(got - nmse_ref).max()))
        del S, S_ref
    if set(pt.methods) & set(reference.BASELINES):
        del prob
        out.update(compare_conventional(system, pt, answers))
    return out


def compare_conventional(system, pt: Point, answers: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The compared numbers of one point's conventional branch
    (:data:`BASELINE_NUMBERS`)."""
    ref_prob = reference.conventional_problem(pt.params, pt.noise_var, pt.n_mc, system.seed, pt.k, system.device)
    prob = system.conventional_problem(pt)
    out = dict.fromkeys(BASELINE_NUMBERS, 0.0)
    out["conv_frontend_rel_err"] = max(_rel(prob[key], ref_prob[key]) for key in CONVENTIONAL_KEYS)
    del ref_prob
    for m in (m for m in pt.methods if m in reference.BASELINES):
        S = system.solve(pt, prob, m)
        S_ref = reference.solve(prob, pt.params, m)
        gap = (S - S_ref).abs().amax(dim=(-2, -1)) / S_ref.abs().amax(dim=(-2, -1))
        got = np.asarray(answers.get(m, np.empty(0)), dtype=np.float64).reshape(-1)
        if m == "vamp":
            out["vamp_s_min_rel_err"] = float(gap.min())
            mean_ref = float(reference.clamped_nmse(S_ref, prob["Zbar"]).double().mean())
            out["vamp_mean_nmse_gap"] = abs(float(got.mean()) - mean_ref) if got.size == pt.n_mc else UNREADABLE
            judged = S
        else:
            out["baseline_s_rel_err"] = max(out["baseline_s_rel_err"], float(gap.max()))
            judged = S_ref
        nmse_ref = reference.clamped_nmse(judged, prob["Zbar"]).cpu().numpy()
        if got.shape != nmse_ref.shape:
            out["baseline_nmse_gap"] = UNREADABLE
        else:
            out["baseline_nmse_gap"] = max(out["baseline_nmse_gap"], float(np.abs(got - nmse_ref).max()))
        del S, S_ref
    return out


def run(system, done: Sequence[Tuple[Point, Dict[str, np.ndarray]]], seed: int,
        limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {number: {"value", "limit"}}) over the window's points ``done``."""
    keys = numbers({m for pt, _ in done for m in pt.methods})
    values = dict.fromkeys(keys, 0.0)
    values["answers_missing"] = float(sum(answer_faults(pt, ans)[0] for pt, ans in done))
    answers = {pt.k: ans for pt, ans in done}
    for pt in sample([pt for pt, _ in done], seed):
        got = compare_point(system, pt, answers[pt.k])
        for key, v in got.items():
            values[key] = max(values[key], v) if np.isfinite(v) else UNREADABLE
        gc.collect()
        if system.device.type == "cuda":
            torch.cuda.empty_cache()
    checks = {key: {"value": values[key], "limit": float(limits[key])} for key in keys}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
