"""The system under test, and the control that stands in its place.

:class:`Port` is the measured program, ``jstsp19_torch``: the window drives
its per-point entry ``harness.runner.run_point``; the correctness check takes
a point's front end and estimates from the same calls that
``harness.pipeline.fused_point_errors`` makes (``proposed_problem``, then
``kernels.admm_fused.fused_tracked_admm``).  :class:`Control` answers the
same three calls from the reference with TF32 products, to show that the
check fails it.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from perfbench import reference
from perfbench.traffic import Point


class Port:
    """The measured program, ``jstsp19_torch``."""

    def __init__(self, device, seed: int):
        from jstsp19_torch.harness import runner

        self.device = torch.device(device)
        self.seed = seed
        self._runner = runner

    def config(self, pt: Point):
        from jstsp19_torch.harness.pipeline import PointConfig

        return PointConfig(methods=pt.methods, svt_method=pt.svt_method, **pt.params)

    def route(self, pt: Point) -> str:
        """The route ``run_point`` takes for ``pt``, decided from its shapes."""
        return self._runner.svt_route(self.config(pt))

    def run_point(self, pt: Point) -> Dict[str, np.ndarray]:
        return self._runner.run_point(self.config(pt), pt.noise_var, pt.n_mc, seed=self.seed, sweep_index=pt.k,
                                      device=self.device)

    def problem(self, pt: Point) -> Dict[str, torch.Tensor]:
        from jstsp19_torch.core import prng
        from jstsp19_torch.harness import pipeline

        gens = prng.realization_generators(self.seed, pt.k, self.device)
        return pipeline.proposed_problem(gens, self.config(pt), pt.noise_var, pt.n_mc)

    def solve(self, pt: Point, prob: Dict[str, torch.Tensor], method: str) -> torch.Tensor:
        from jstsp19_torch.kernels import admm_fused

        pc = self.config(pt)
        args = [prob[key] for key in ("subY", "Omega", "A", "B", "tau_Y", "tau_S", "rho")]
        rank = prob["rank"] if method == reference.ANGLES else None
        S, _ = admm_fused.fused_tracked_admm(*args, Imax=pc.Imax, track_rounds=pc.track_rounds, support_rank=rank)
        return S


class Control:
    """The reference with every product in TF32, in the program's place."""

    def __init__(self, device, seed: int):
        self.device = torch.device(device)
        self.seed = seed

    def route(self, pt: Point) -> str:
        return pt.svt_method

    def run_point(self, pt: Point) -> Dict[str, np.ndarray]:
        errs = reference.errors(self.problem(pt), pt.params, pt.methods, tf32=True)
        return {m: e.cpu().numpy() for m, e in errs.items()}

    def problem(self, pt: Point) -> Dict[str, torch.Tensor]:
        return reference.problem(pt.params, pt.noise_var, pt.n_mc, self.seed, pt.k, self.device, tf32=True)

    def solve(self, pt: Point, prob: Dict[str, torch.Tensor], method: str) -> torch.Tensor:
        return reference.solve(prob, pt.params, method, tf32=True)
