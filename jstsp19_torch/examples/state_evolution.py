"""State-evolution demo: predicted vs empirical GAMP MSE trajectories.

Runs the matched SE recursion (``stateEvo/gampSE.m`` capability,
``solvers/gamp_se.py``) for a Bernoulli-Gaussian prior under an AWGN
output channel and overlays the empirical per-iteration MSE of the
actual GAMP solver — the strongest hardware-free correctness oracle
for message-passing implementations.

Run: python -m jstsp19_torch demo state_evolution [--cpu]
"""
import math

import torch

from jstsp19_torch.core import prng
from jstsp19_torch.examples import _common
from jstsp19_torch.ops import MatrixOp
from jstsp19_torch.solvers import (AwgnOutAvg, AwgnPrior, CAwgnLikelihood, EstimInAvg, GampOptions, SparsePrior,
                                   bg_sampler, estim_in_avg, gamp_est)
from jstsp19_torch.solvers.gamp_se import gamp_se

SEED = 0
# the table prints dB without the unit on its lines
TOLERANCE = ((r"^(0[2-9]|1[0-7]) # # # #[12]$", "db", 0.05),)
P1, VAR0, WVAR = 0.1, 1.0, 1e-4
M, N, NIT = 512, 1024, 16
N_SAMP = 65536
TRIALS = (10, 11, 12, 13)  # the script's PRNGKey seeds of the empirical draws


def _prior():
    return SparsePrior(base=AwgnPrior(mean0=0.0, var0=VAR0), p1=P1)


def build(device, gen):
    """The SE's input samples (x, w) from ``fold_in(gen, 0)``; each trial's
    A, x and noise from ``fold_in(gen, seed)`` split in three, the trials
    stacked as a batch."""
    se = estim_in_avg(_prior(), prng.fold_in(gen, 0), n_samp=N_SAMP, sampler=bg_sampler(P1, VAR0))
    A, x, y = [], [], []
    for s in TRIALS:
        ka, kx, kw = prng.split(prng.fold_in(gen, s), 3)
        A.append(_common.normal(ka, (M, N)) / math.sqrt(M))
        x.append(bg_sampler(P1, VAR0)(kx, N))
        y.append(A[-1] @ x[-1] + math.sqrt(WVAR) * _common.normal(kw, (M,)))
    return _common.moved(dict(se_x=se.x, se_w=se.w, A=torch.stack(A), x=torch.stack(x), y=torch.stack(y)), device)


def lines(p):
    prior = _prior()
    se = gamp_se(EstimInAvg(prior, p["se_x"], p["se_w"]), AwgnOutAvg(wvar=WVAR), beta=N / M, nit=NIT)
    # the empirical trajectory, averaged over the trials (one batch)
    _, _, hist = gamp_est(prior, CAwgnLikelihood(y=p["y"], wvar=WVAR), MatrixOp(p["A"]),
                          GampOptions(nit=NIT, adapt_step=False, step=1.0, tol=-1.0, save_hist=True))
    emp = ((hist["xhat"] - p["x"][None]).abs() ** 2).mean(-1).mean(-1).double().cpu().numpy()
    se_db = [10 * math.log10(float(v) + 1e-12) for v in se["mse"].cpu()]
    emp_db = [10 * math.log10(float(v) + 1e-12) for v in emp]
    out = [("== GAMP state evolution vs empirical (BG-AWGN, n/m = 2) ==", ()),
           ("  {:>4s} {:>9s} {:>15s}", ("iter", "SE (dB)", "empirical (dB)"))]
    for i in range(min(len(se_db), len(emp_db))):
        out.append(("  {:4d} {:9.2f} {:15.2f}", (i, se_db[i], emp_db[i])))
    out.append(("  steady-state gap = {:.2f} dB", (abs(se_db[len(emp_db) - 1] - emp_db[-1]),)))
    return out


def solve(problem):
    return _common.labelled(lines(problem))


def main(argv=None):
    return _common.main(build, lines, SEED, argv)


if __name__ == "__main__":
    raise SystemExit(main())
