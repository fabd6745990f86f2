"""The plain reference of a Monte-Carlo point on the fused or the tracked route.

It computes the proposed pair (``admm.py`` on ``frontend.py``'s problem) and
the conventional baselines LS, VAMP and MMV-OMP (``conventional.py`` on the
conventional receiver's problem, from the same received frame).  Plain
PyTorch, in float32 with every product in full float32 (TF32 off), or with
``tf32=True`` the same with every product's operands rounded to TF32: the
control.  It imports nothing of the measured program and takes nothing
the program made: it draws the point's random numbers itself from
(seed, sweep index) and computes everything else from them.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional

import torch

from perfbench.reference import conventional
from perfbench.reference.admm import admm, clamped_nmse
from perfbench.reference.frontend import Products, combiner, draw, frontend, oracle_rank, received

ANGLES = "proposed_angles"  # the method that runs Algorithm 3's oracle support schedule
METHODS = ("proposed", ANGLES)
BASELINES = ("ls", "vamp", "omp_mmv")  # the conventional receiver's, plot_errorVSsnr.m:73-121
# the VAMP settings a point with a baseline states, and the values the reference has for those it fixes
VAMP_SETTINGS = ("vamp_nit", "vamp_damp", "vamp_true_noise", "vamp_normal_eq")
VAMP_FIXED = {"vamp_true_noise": (False, "the noise variance 1 that the script passes"),
              "vamp_normal_eq": (True, "the normal-equation form y = vec(Y_c·B_cᴴ)")}
# the program's routes whose solve is this reference's: the tracked SVT with one Jacobi round an iteration
ROUTES = ("fused", "tracked")
COMBINERS = ("ZC", "fft", "ps")


def lacks(point: Mapping, methods: Iterable[str] = (), route: Optional[str] = None) -> List[str]:
    """What the reference would need to compute ``methods`` of ``point`` on
    ``route`` (None: any of ``ROUTES``) and has no code for; empty where it
    computes them."""
    gaps = []
    if route is not None and route not in ROUTES:
        gaps.append(f"the {route!r} route's SVT (it has the tracked SVT of {' and '.join(map(repr, ROUTES))})")
    gaps += [f"the method {m!r} (it has {', '.join(map(repr, METHODS + BASELINES))})" for m in methods
             if m not in METHODS + BASELINES]
    if point.get("channel_quirks"):
        gaps.append("the quirks channel (channel_quirks; it has the paper's channel)")
    if point.get("admm_mode") != "approximate":
        gaps.append(f"admm_mode {point.get('admm_mode')!r} (it has 'approximate')")
    if point.get("rho_scale") != 1.0:
        gaps.append(f"rho_scale {point.get('rho_scale')!r} (it has the recipe's rho)")
    if point.get("track_rounds", 1) != 1:
        gaps.append(f"track_rounds {point.get('track_rounds')!r} (it tracks with one Jacobi round an iteration)")
    if point.get("beamformer") not in COMBINERS:
        gaps.append(f"the combiner {point.get('beamformer')!r} (it has {', '.join(map(repr, COMBINERS))})")
    if min(point["Mr_e"], point["T"] * point["Nt"]) % 2:
        gaps.append("a tracked SVT of odd thin side min(Mr_e, T*Nt)")
    if set(methods) & set(BASELINES):
        for key in VAMP_SETTINGS:
            if key not in point:
                gaps.append(f"baselines at an unstated {key} (the point has to state {', '.join(VAMP_SETTINGS)})")
            elif key in VAMP_FIXED and point[key] is not VAMP_FIXED[key][0]:
                value, what = VAMP_FIXED[key]
                gaps.append(f"{key} {point[key]!r} (it has {value!r}: {what})")
    return gaps


def _require(gaps: List[str]) -> None:
    if gaps:
        raise ValueError("perfbench/reference/ has no code for " + "; ".join(gaps))


def problem(point: Mapping, noise_var: float, n_mc: int, seed: int, sweep_index: int, device,
            tf32: bool = False) -> Dict[str, torch.Tensor]:
    """The point's front end: the keys of :func:`frontend.frontend`."""
    _require(lacks(point))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return frontend(point, draw(point, noise_var, n_mc, seed, sweep_index, device), Products(tf32))


def conventional_problem(point: Mapping, noise_var: float, n_mc: int, seed: int, sweep_index: int, device,
                         tf32: bool = False) -> Dict[str, torch.Tensor]:
    """The conventional receiver's problem: the keys of :func:`conventional.problem`."""
    _require(lacks(point))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm = Products(tf32)
    d = draw(point, noise_var, n_mc, seed, sweep_index, device)
    return conventional.problem(point, received(point, d, mm), combiner(point["beamformer"], point["Nr"], device), mm)


def solve(prob: Mapping[str, torch.Tensor], point: Mapping, method: str, tf32: bool = False) -> torch.Tensor:
    """The (B, Gr, L·Gt) estimate of ``method`` on ``prob``: the proposed
    problem for the proposed pair, the conventional one for a baseline."""
    _require(lacks(point, (method,)))
    if method in BASELINES:
        return conventional.solve(prob, point, method, Products(tf32))
    return admm(prob, point["Imax"], Products(tf32), rank=prob["rank"] if method == ANGLES else None)


def errors(prob: Mapping[str, torch.Tensor], point: Mapping, methods: Iterable[str], tf32: bool = False
           ) -> Dict[str, torch.Tensor]:
    """{method: (B,) clamped NMSE} on ``prob``, the problem of ``methods``' branch."""
    return {m: clamped_nmse(solve(prob, point, m, tf32), prob["Zbar"]) for m in methods}
