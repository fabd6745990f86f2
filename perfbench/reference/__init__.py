"""The plain reference of a fused-route Monte-Carlo point.

Plain PyTorch, in float32 with every product in full float32 (TF32 off), or
with ``tf32=True`` the same with every product's operands rounded to TF32:
the control.  It imports nothing of the measured program and takes nothing
the program made: it draws the point's random numbers itself from
(seed, sweep index) and computes everything else from them.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping

import torch

from perfbench.reference.admm import admm, clamped_nmse
from perfbench.reference.frontend import Products, draw, frontend, oracle_rank

ANGLES = "proposed_angles"  # the method that runs Algorithm 3's oracle support schedule
METHODS = ("proposed", ANGLES)


def problem(point: Mapping, noise_var: float, n_mc: int, seed: int, sweep_index: int, device,
            tf32: bool = False) -> Dict[str, torch.Tensor]:
    """The point's front end: the keys of :func:`frontend.frontend`."""
    if point.get("channel_quirks") or point.get("admm_mode") != "approximate" or point.get("rho_scale") != 1.0:
        raise ValueError("the reference computes the paper's channel, the approximate ADMM and the recipe's rho")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return frontend(point, draw(point, noise_var, n_mc, seed, sweep_index, device), Products(tf32))


def solve(prob: Mapping[str, torch.Tensor], point: Mapping, method: str, tf32: bool = False) -> torch.Tensor:
    """The (B, Gr, L·Gt) estimate of ``method`` on ``prob``."""
    if method not in METHODS:
        raise ValueError(f"the reference has no method {method!r}")
    if point.get("track_rounds", 1) != 1:
        raise ValueError("the reference tracks with one Jacobi round an iteration")
    return admm(prob, point["Imax"], Products(tf32), rank=prob["rank"] if method == ANGLES else None)


def errors(prob: Mapping[str, torch.Tensor], point: Mapping, methods: Iterable[str], tf32: bool = False
           ) -> Dict[str, torch.Tensor]:
    """{method: (B,) clamped NMSE} on ``prob``."""
    return {m: clamped_nmse(solve(prob, point, m, tf32), prob["Zbar"]) for m in methods}
