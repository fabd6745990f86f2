"""SNIPE as an overmatched Bernoulli-Gaussian denoiser.

The reference's ``examples/SNIPE/snipe_as_overmatched_BernGauss.m``:
SNIPE (sparsifying non-informative parameter estimator, the
infinite-slab-variance limit of a Bernoulli-Gaussian prior) recovers
BG signals almost as well as the MATCHED BG prior while needing only a
single tuning scalar omega — and is insensitive to it over a wide range.

Run: python -m jstsp19_torch demo snipe [--cpu]
"""
import math

import numpy as np
import torch

from jstsp19_torch.core import prng
from jstsp19_torch.examples import _common
from jstsp19_torch.ops import MatrixOp
from jstsp19_torch.solvers import AwgnPrior, CAwgnLikelihood, GampOptions, SNIPEPrior, SparsePrior, bg_sampler, gamp_est

SEED = 40
# the SNIPE column prints dB without the unit on its lines
TOLERANCE = ((r"^0[3-7] # # #1$", "db", 0.05),)
M, N, P1, WVAR = 300, 512, 0.08, 1e-4
TRIALS = (40, 41, 42, 43)  # the script's PRNGKey seeds, one trial each
OMEGAS = (0.0, 1.0, 2.0, 3.0, 4.0)


def build(device, gen):
    """Each trial's A, x and noise from ``fold_in(gen, seed)`` split in three,
    the four trials stacked as a batch."""
    A, x, y = [], [], []
    for s in TRIALS:
        ka, kx, kw = prng.split(prng.fold_in(gen, s), 3)
        A.append(_common.normal(ka, (M, N)) / math.sqrt(M))
        x.append(bg_sampler(P1, 1.0)(kx, N))
        y.append(A[-1] @ x[-1] + math.sqrt(WVAR) * _common.normal(kw, (M,)))
    return _common.moved(dict(A=torch.stack(A), x=torch.stack(x), y=torch.stack(y)), device)


def lines(p):
    A, x, y = p["A"], p["x"], p["y"]
    opt = GampOptions(nit=40, adapt_step=False, step=0.8, tol=-1.0)

    def mean_nmse(prior):
        fin, _, _ = gamp_est(prior, CAwgnLikelihood(y=y, wvar=WVAR), MatrixOp(A), opt)
        return float(np.mean([_common.nmse(fin.xhat[b], x[b]) for b in range(len(TRIALS))]))

    ref = mean_nmse(SparsePrior(base=AwgnPrior(mean0=0.0, var0=1.0), p1=P1))
    out = [("== SNIPE vs matched Bernoulli-Gaussian (m/n = 0.59, p1 = 0.08) ==", ()),
           ("  matched BG prior      : NMSE = {:7.2f} dB", (10 * math.log10(ref),)),
           ("  {:>7s} {:>16s}", ("omega", "SNIPE NMSE (dB)"))]
    for omega in OMEGAS:
        e = mean_nmse(SNIPEPrior(omega=torch.tensor(omega, device=A.device)))
        out.append(("  {:7.1f} {:16.2f}", (omega, 10 * math.log10(e))))
    out += [("  (SNIPE tracks the matched prior to within a few dB over a wide", ()),
            ("   omega band, with no knowledge of the sparsity rate or the", ()),
            ("   slab amplitude — the overmatched-BG point of the reference.)", ())]
    return out


def solve(problem):
    return _common.labelled(lines(problem))


def main(argv=None):
    return _common.main(build, lines, SEED, argv)


if __name__ == "__main__":
    raise SystemExit(main())
