"""Probit (1-bit) sparse regression: empirical GAMP vs state evolution.

The reference's ``examples/ProbitSE/`` suite (``ProbitEmpirical.m``,
``ProbitStateEvo.m``, ``ProbitPhasePlane.m``): a Bernoulli-Gaussian
vector observed through y = sign(Ax + w) — sparse binary classification /
1-bit compressed sensing.  This demo

1. runs GAMP with ``ProbitLikelihood`` on one problem instance,
2. runs the matched SE recursion with a Monte-Carlo probit output
   average (``MCOutAvg`` — the ``ProbitStateEvoEstimOut.m`` analog), and
3. sweeps the measurement ratio m/n — the 1-D slice of the reference's
   phase plane.

Run: python -m jstsp19_torch demo probit_classification [--cpu]
"""
import math

import numpy as np
import torch

from jstsp19_torch.core import prng
from jstsp19_torch.examples import _common
from jstsp19_torch.ops import MatrixOp
from jstsp19_torch.solvers import (AwgnPrior, EstimInAvg, GampOptions, MCOutAvg, ProbitLikelihood, SparsePrior,
                                   bg_sampler, estim_in_avg, gamp_est)
from jstsp19_torch.solvers.gamp_se import gamp_se

SEED = 30
# the table prints dB without the unit; the SE's output average draws its
# 32768 samples with the port's generator: 0.093 dB is the spread of the
# final SE over 8 seeds of both samplers (the port on the CPU)
TOLERANCE = ((r"^0[2-4] # # # #1$", "db", 0.05), (r"^0[2-4] # # # #2$", "mc", 0.093))
P1, VAR0, WVAR, NIT = 0.1, 1.0, 1e-2, 25
N = 512
RATIOS = (2.0, 4.0, 6.0)
TRIALS = (30, 31, 32, 33)  # the script's PRNGKey seeds, one trial each
SE_IN, SE_OUT = 2, 1  # the SE samplers' seeds
N_IN, N_OUT = 65536, 32768


def channel(gen, z):
    """y = 1{z + w > 0}, w ~ N(0, WVAR) (ProbitLikelihood's {0, 1} labels)."""
    w = torch.randn(z.shape, generator=gen, device=gen.device).to(z.device)
    return (z + math.sqrt(WVAR) * w > 0).float()


def _prior():
    return SparsePrior(base=AwgnPrior(mean0=0.0, var0=VAR0), p1=P1)


def build(device, gen):
    """For each ratio, each trial's A, x and dithered labels from
    ``fold_in(gen, seed)`` split in three (the trials stacked as a batch);
    the SE's input samples from ``fold_in(gen, 2)``; the output average's
    generator ``fold_in(gen, 1)`` (drawn from in the SE)."""
    out = {}
    for ratio in RATIOS:
        m = int(ratio * N)
        A, x, y = [], [], []
        for s in TRIALS:
            ka, kx, kw = prng.split(prng.fold_in(gen, s), 3)
            A.append(_common.normal(ka, (m, N)) / math.sqrt(m))
            x.append(bg_sampler(P1, VAR0)(kx, N))
            y.append(channel(kw, A[-1] @ x[-1]))
        out.update({f"A{m}": torch.stack(A), f"x{m}": torch.stack(x), f"y{m}": torch.stack(y)})
    se = estim_in_avg(_prior(), prng.fold_in(gen, SE_IN), n_samp=N_IN, sampler=bg_sampler(P1, VAR0))
    out.update(se_x=se.x, se_w=se.w, out_key=prng.fold_in(gen, SE_OUT))
    return _common.moved(out, device)


def lines(p):
    prior = _prior()
    in_avg = EstimInAvg(prior, p["se_x"], p["se_w"])
    out = [("== probit GAMP: empirical vs state evolution (BG prior, p1={}, 1-bit AWGN-dithered sign "
            "measurements) ==", (P1,)),
           ("  {:>5s} {:>15s} {:>9s}", ("m/n", "empirical (dB)", "SE (dB)"))]
    for ratio in RATIOS:
        m = int(ratio * N)
        A, x, y = p[f"A{m}"], p[f"x{m}"], p[f"y{m}"]
        fin, _, _ = gamp_est(prior, ProbitLikelihood(y=y, wvar=WVAR), MatrixOp(A),
                             GampOptions(nit=NIT, adapt_step=False, step=1.0, tol=-1.0))
        emp = float(np.mean([float(((fin.xhat[b] - x[b]).abs() ** 2).double().mean()) for b in range(len(TRIALS))]))
        out_avg = MCOutAvg(like_factory=lambda yy: ProbitLikelihood(y=yy, wvar=WVAR), channel=channel,
                           key=p["out_key"], n_samp=N_OUT)
        se = float(gamp_se(in_avg, out_avg, beta=N / m, nit=NIT)["mse"][-1])
        out.append(("  {:5.1f} {:15.2f} {:9.2f}", (ratio, 10 * math.log10(emp + 1e-12), 10 * math.log10(se + 1e-12))))
    out += [("  (SE tracks the empirical MSE across the undersampling sweep —", ()),
            ("   the ProbitPhasePlane.m slice at this sparsity.)", ())]
    return out


def solve(problem):
    return _common.labelled(lines(problem))


def main(argv=None):
    return _common.main(build, lines, SEED, argv)


if __name__ == "__main__":
    raise SystemExit(main())
