"""Full-capability GAMP demo: the gampEst.m options matrix on one testbed.

Runs the same Bernoulli-Gaussian compressed-sensing problem through the
sum-product / adaptive-step (log-likelihood and Bethe) / mean-removal /
uniform-variance / max-sum (MAP) modes of ``solvers/gamp_full.py``, and
shows the bit-exact warm-start contract (``main/gampEst.m:1-55``,
``main/GampOpt.m:1-30``, ``test/warmStart/``).

Run: python -m jstsp19_torch demo gamp_options [--cpu]
"""
import numpy as np
import torch

from jstsp19_torch.examples import _common
from jstsp19_torch.ops import MatrixOp
from jstsp19_torch.solvers import AwgnPrior, CAwgnLikelihood, GampOptions, SoftThreshPrior, SparsePrior, gamp_est

SEED = 0
TOLERANCE = ()  # the classes of _common.tolerance
N, M, K, WVAR = 512, 256, 32, 1e-4


def build(device, gen=None):
    """The script's numpy draws (``default_rng(0)``); ``gen`` is not used."""
    rng = np.random.default_rng(SEED)
    A = rng.standard_normal((M, N)) / np.sqrt(M)
    x = np.zeros(N)
    x[rng.choice(N, K, False)] = rng.standard_normal(K)
    y = A @ x + np.sqrt(WVAR) * rng.standard_normal(M)
    return {"A": torch.tensor(A, dtype=torch.float32, device=device), "x": torch.tensor(x, device=device),
            "y": torch.tensor(y, dtype=torch.float32, device=device)}


def lines(p):
    x = p["x"]
    op = MatrixOp(p["A"])
    prior = SparsePrior(base=AwgnPrior(mean0=0.0, var0=1.0), p1=K / N)
    like = CAwgnLikelihood(y=p["y"][None], wvar=WVAR)
    out = [("== gampEst options matrix (BG-CS, n=512 m=256 k=32) ==", ())]
    matrix = [
        ("plain step=0.9", GampOptions(nit=80, adapt_step=False, step=0.9)),
        ("adaptive (loglike)", GampOptions(nit=80)),
        ("adaptive (Bethe)", GampOptions(nit=80, adapt_step_bethe=True)),
        ("mean removal", GampOptions(nit=80, remove_mean=True)),
        ("uniform variance", GampOptions(nit=80, uniform_variance=True)),
        ("wvar autotune", GampOptions(nit=80, tune_wvar=True)),
    ]
    for label, opts in matrix:
        fin, _, _ = gamp_est(prior, like, op, opts)
        out.append(("  {:22s} NMSE = {:7.2f} dB", (label, _common.nmse_db(fin.xhat[0], x))))
    # max-sum (MAP) mode: LASSO via the SoftThresh prior
    fin, _, _ = gamp_est(SoftThreshPrior(lam=2.0), like, op, GampOptions(nit=200, max_sum=True, step=0.5))
    out.append(("  {:22s} NMSE = {:7.2f} dB", ("max-sum LASSO", _common.nmse_db(fin.xhat[0], x))))
    # warm start: 15 + 25 resumed iterations equal 40 straight, bit-exact
    kw = dict(tol=-1.0, step_tol=-1.0)
    fin40, _, _ = gamp_est(prior, like, op, GampOptions(nit=40, **kw))
    _, st15, _ = gamp_est(prior, like, op, GampOptions(nit=15, **kw))
    fin_res, _, _ = gamp_est(prior, like, op, GampOptions(nit=25, **kw), state_in=st15)
    exact = bool(torch.equal(fin40.xhat, fin_res.xhat))
    out.append(("  warm start (15+25 vs 40): bit-exact = {}", (exact,)))
    assert exact
    return out


def solve(problem):
    return _common.labelled(lines(problem))


def main(argv=None):
    return _common.main(build, lines, SEED, argv)


if __name__ == "__main__":
    raise SystemExit(main())
