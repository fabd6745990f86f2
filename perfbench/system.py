"""The system under test, and the control that stands in its place.

:class:`Port` is the measured program, ``jstsp19_torch``: the window drives
its per-point entry ``harness.runner.run_point``; the correctness check takes
a point's front end and estimates from the calls that ``run_point`` makes on
the point's route (``harness.runner.svt_route``, decided from its shapes):

- ``fused``: those of ``harness.pipeline.fused_point_errors``,
  ``proposed_problem`` and then ``kernels.admm_fused.fused_tracked_admm``;
- ``tracked``: those of ``harness.pipeline.realization_errors`` for the
  proposed methods, ``point_draws`` and ``_proposed_frontend``, and then
  ``proposed_admm`` or ``proposed_admm_angles`` with the point's tracked-SVT
  settings, each looked up in ``harness.pipeline`` at the call, as
  ``realization_errors`` looks them up.

On either route the baselines (``ls``, ``vamp``, ``omp_mmv``) run on the
conventional receiver's problem, ``harness.pipeline.conventional_problem``,
and are solved by the calls ``realization_errors`` makes for them, with the
point's VAMP settings: ``ls_estimate``, ``vamp_mmwave`` and ``omp_mmv``,
each looked up in ``harness.pipeline`` at the call.

The other routes (``eigh``, ``jacobi``) have no reference to be held to, and
``bench.run_cell`` refuses them before any point runs.  :class:`Control`
answers the same calls from the reference with TF32 products, to show that
the check fails it; the reference's solve is the same on both routes, so the
control takes the traffic's route as it stands.
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
        """The point's front end under the check's keys (subY, Omega, A, B,
        tau_Y, tau_S, rho, Zbar, rank), and on the tracked route the oracle
        order too, for the solve."""
        from jstsp19_torch.core import prng
        from jstsp19_torch.harness import pipeline

        pc = self.config(pt)
        gens = prng.realization_generators(self.seed, pt.k, self.device)
        if self.route(pt) == "fused":
            return pipeline.proposed_problem(gens, pc, pt.noise_var, pt.n_mc)
        draws = pipeline.point_draws(gens, pc, pt.noise_var, pt.n_mc)
        ch, obs, A, B, tau_Y, tau_S, rho = pipeline._proposed_frontend(gens, pc, pt.noise_var, pt.n_mc, draws=draws)
        order = pipeline._oracle_order(ch.Zbar)
        rank = pipeline.support_rank_from_order(order, pc.Gr * pc.L * pc.Gt).reshape(ch.Zbar.shape)
        return dict(subY=obs.Y, Omega=obs.Omega, A=A, B=B, tau_Y=tau_Y, tau_S=tau_S, rho=rho, Zbar=ch.Zbar,
                    rank=rank, order=order)

    def conventional_problem(self, pt: Point) -> Dict[str, torch.Tensor]:
        """The point's conventional problem: Y_c, A_c, B_c and Zbar."""
        from jstsp19_torch.core import prng
        from jstsp19_torch.harness import pipeline

        gens = prng.realization_generators(self.seed, pt.k, self.device)
        return pipeline.conventional_problem(gens, self.config(pt), pt.noise_var, pt.n_mc)

    def solve(self, pt: Point, prob: Dict[str, torch.Tensor], method: str) -> torch.Tensor:
        from jstsp19_torch.harness import pipeline
        from jstsp19_torch.kernels import admm_fused

        if method in reference.BASELINES:
            return self._baseline(pt, prob, method)
        pc = self.config(pt)
        args = [prob[key] for key in ("subY", "Omega", "A", "B", "tau_Y", "tau_S", "rho")]
        angles = method == reference.ANGLES
        if self.route(pt) == "fused":
            S, _ = admm_fused.fused_tracked_admm(*args, Imax=pc.Imax, track_rounds=pc.track_rounds,
                                                 support_rank=prob["rank"] if angles else None)
            return S
        subY, Omega, A, B, tau_Y, tau_S, rho = args
        kw = dict(mode=pc.admm_mode, svt_method="tracked", track_rounds=pc.track_rounds,
                  track_precision=pc.track_precision)
        if angles:
            return pipeline.proposed_admm_angles(subY, Omega, prob["order"], A, B, pc.Imax, tau_Y, tau_S, rho, **kw).S
        return pipeline.proposed_admm(subY, Omega, A, B, pc.Imax, tau_Y, tau_S, rho, **kw).S

    def _baseline(self, pt: Point, prob: Dict[str, torch.Tensor], method: str) -> torch.Tensor:
        """A baseline's estimate as ``realization_errors`` makes it; VAMP at
        the settings ``reference.lacks`` leaves (noise variance 1, the normal
        equations)."""
        from jstsp19_torch.harness import pipeline

        pc = self.config(pt)
        Y_c, A_c, B_c = prob["Y_c"], prob["A_c"], prob["B_c"]
        if method == "ls":
            return pipeline.ls_estimate(Y_c, A_c, B_c)
        if method == "omp_mmv":
            return pipeline.omp_mmv(A_c, Y_c @ pipeline.pinv(B_c), min(pc.num_nonzero, pc.Gr)).x
        return pipeline.vamp_mmwave(Y_c @ B_c.mH, A_c, B_c @ B_c.mH, 1.0, pc.num_nonzero, nit=pc.vamp_nit,
                                    damp=pc.vamp_damp)


class Control:
    """The reference with every product in TF32, in the program's place."""

    def __init__(self, device, seed: int):
        self.device = torch.device(device)
        self.seed = seed

    def route(self, pt: Point) -> str:
        return pt.svt_method

    def run_point(self, pt: Point) -> Dict[str, np.ndarray]:
        proposed = [m for m in pt.methods if m not in reference.BASELINES]
        baselines = [m for m in pt.methods if m in reference.BASELINES]
        errs = reference.errors(self.problem(pt), pt.params, proposed, tf32=True) if proposed else {}
        if baselines:
            errs.update(reference.errors(self.conventional_problem(pt), pt.params, baselines, tf32=True))
        return {m: e.cpu().numpy() for m, e in errs.items()}

    def problem(self, pt: Point) -> Dict[str, torch.Tensor]:
        return reference.problem(pt.params, pt.noise_var, pt.n_mc, self.seed, pt.k, self.device, tf32=True)

    def conventional_problem(self, pt: Point) -> Dict[str, torch.Tensor]:
        return reference.conventional_problem(pt.params, pt.noise_var, pt.n_mc, self.seed, pt.k, self.device,
                                              tf32=True)

    def solve(self, pt: Point, prob: Dict[str, torch.Tensor], method: str) -> torch.Tensor:
        return reference.solve(prob, pt.params, method, tf32=True)
