"""Nonlinear output channels: saturated sigmoid and Poisson counting.

Covers the reference's ``examples/sparseNL/`` (y = f(Ax) + w with a
saturating sigmoid f — ``sparseNL.m``, ``sparseNLParam.m:36``) and the
linear-nonlinear-Poisson family of ``examples/LNPAdapt/`` (count
observations y ~ Poisson(rate(Ax)) — ``LNPTest.m``): both reduce to
swapping the ``EstimOut`` module, everything else in GAMP unchanged.

1. sparseNL: GAMP with the quadrature ``NLLikelihood`` on the sigmoid
   channel, vs a naive AWGN-GAMP that ignores the nonlinearity.
2. LNP: GAMP with ``PoissonLikelihood`` on counts with a linear rate,
   vs AWGN-GAMP treating counts as Gaussian.

Run: python -m jstsp19_torch demo nonlinear_channels [--cpu]
"""
import math

import torch

from jstsp19_torch.core import prng
from jstsp19_torch.examples import _common
from jstsp19_torch.ops import MatrixOp
from jstsp19_torch.solvers import (AwgnPrior, CAwgnLikelihood, GampOptions, NLLikelihood, NNGMPrior,
                                   PoissonLikelihood, SparsePrior, bg_sampler, gamp_est)

SEED = 7
TOLERANCE = ()  # the classes of _common.tolerance
# the card against the CPU in float64: on the port's own draws the script's
# Poisson GAMP is float32 roundoff (the CPU +3.99 to +5.20 dB, the H100
# +0.88; JAX's solver on the same draws +2.43); in float64 (gamp_est keeps a
# float64 state for a float64 observation) the CPU reads +0.098 dB, moved
# at most 1.4e-3 dB by a 1e-12 relative change of A
FLOAT64 = True
M, N, P1, SNR_DB = 500, 1000, 0.1, 20
WVAR = 10 ** (-0.1 * SNR_DB)
# ascale chosen so ~30% of z-draws hit the +-0.5 saturation knee
# (sparseNLParam.m:31: ascale = 1/sqrt(2 zvar0)/satlev/erfinv(1-psat))
ZVAR0 = P1 * 1.0
ASCALE = 1.0 / math.sqrt(2 * ZVAR0) / 0.5 / float(torch.special.erfinv(torch.tensor(1 - 0.3, dtype=torch.float64)))
MP, NP, SCALE = 800, 200, 8.0


def out_fn(z):
    return 2.0 / (1.0 + torch.exp(-ASCALE * z)) - 1.0


def build(device, gen):
    """The sigmoid problem from ``fold_in(gen, 7)`` split in three (A, x, w);
    the Poisson problem from ``fold_in(gen, 8)`` split in three (the mask
    and gains, the intensity, the counts), each as the script folds them."""
    ka, kx, kw = prng.split(prng.fold_in(gen, 7), 3)
    A = _common.normal(ka, (M, N)) / math.sqrt(M)
    x = bg_sampler(P1, 1.0)(kx, N)
    y = out_fn(A @ x) + math.sqrt(WVAR) * _common.normal(kw, (M,))
    ka, kx, kp = prng.split(prng.fold_in(gen, 8), 3)
    act = torch.rand(NP, generator=prng.fold_in(kx, 0)) < P1
    mag = torch.empty(NP).exponential_(generator=prng.fold_in(kx, 1))
    x_nn = torch.where(act, mag, 0.0)
    A_nn = ((torch.rand((MP, NP), generator=ka) < 0.25).float()
            * torch.rand((MP, NP), generator=prng.fold_in(ka, 1)) * (8.0 / NP))
    y_cnt = torch.poisson(SCALE * (A_nn @ x_nn), generator=kp)
    return _common.moved(dict(A=A, x=x, y=y, x_nn=x_nn, A_nn=A_nn, y_cnt=y_cnt), device)


def lines(p):
    A, x = p["A"], p["x"]
    dev = A.device
    db = _common.nmse_db
    y = p["y"][None]
    prior = SparsePrior(base=AwgnPrior(mean0=0.0, var0=1.0), p1=P1)
    opt = GampOptions(nit=30, adapt_step=False, step=0.7, tol=-1.0)
    fin_nl, _, _ = gamp_est(prior, NLLikelihood(y=y, wvar=WVAR, out_fn=out_fn), MatrixOp(A), opt)
    # naive: pretend y ~ a'·z + noise with the small-signal slope at 0
    f32 = torch.float32
    slope = float((out_fn(torch.tensor(1e-3, dtype=f32)) - out_fn(torch.tensor(0.0, dtype=f32))) / 1e-3)
    fin_aw, _, _ = gamp_est(prior, CAwgnLikelihood(y=y / slope, wvar=WVAR / slope**2), MatrixOp(A), opt)
    out = [("== sparseNL: y = sigmoid(Ax) + w, 30% saturated ==", ()),
           ("  GAMP + NLLikelihood   NMSE = {:7.2f} dB", (db(fin_nl.xhat[0], x),)),
           ("  GAMP + linearized AWGN NMSE = {:7.2f} dB", (db(fin_aw.xhat[0], x),))]
    # -- 2. Poisson counting channel (LNPAdapt family)
    x_nn, A_nn, y_cnt = p["x_nn"], p["A_nn"], p["y_cnt"][None]
    t = lambda v: torch.tensor(v, dtype=A_nn.dtype, device=dev)  # noqa: E731
    prior_nn = NNGMPrior(t([1.0]), t([1.0]), t([1.0]), p1=t(P1))
    # positive mixing matrix -> strong mean component: mean removal
    # (gampEst.m:238-272 capability)
    opt_p = GampOptions(nit=40, adapt_step=False, step=0.5, tol=-1.0, remove_mean=True)
    fin_p, _, _ = gamp_est(prior_nn, PoissonLikelihood(y=y_cnt, scale=SCALE), MatrixOp(A_nn), opt_p)
    gvar = float(y_cnt.mean() / SCALE**2) + 1e-9
    fin_g, _, _ = gamp_est(prior_nn, CAwgnLikelihood(y=y_cnt / SCALE, wvar=gvar), MatrixOp(A_nn), opt_p)
    out += [("== LNP: y ~ Poisson({:.0f} * Ax), non-negative sparse x ==", (SCALE,)),
            ("  GAMP + PoissonLikelihood NMSE = {:7.2f} dB", (db(fin_p.xhat[0], x_nn),)),
            ("  GAMP + Gaussian approx   NMSE = {:7.2f} dB", (db(fin_g.xhat[0], x_nn),))]
    return out


def solve(problem):
    return _common.labelled(lines(problem))


def main(argv=None):
    return _common.main(build, lines, SEED, argv)


if __name__ == "__main__":
    raise SystemExit(main())
