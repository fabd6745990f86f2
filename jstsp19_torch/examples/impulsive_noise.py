"""Sparse recovery through an impulsive (Bernoulli-Gaussian) noise channel.

Demonstrates the AWBGN likelihood (``main/AwbgnEstimOut.m`` analog): each
measurement is exactly noiseless w.p. (1−λ) and hit by a large Gaussian
impulse w.p. λ.  A GAMP run with the delta-spike-aware ``AwbgnLikelihood``
identifies the clean measurements and recovers the signal almost exactly,
while a naive AWGN likelihood matched only to the average noise power is
badly degraded.

Run: python -m jstsp19_torch demo impulsive_noise [--cpu]
"""
import math

import numpy as np
import torch

from jstsp19_torch.examples import _common
from jstsp19_torch.ops import MatrixOp
from jstsp19_torch.solvers import AwbgnLikelihood, AwgnPrior, CAwgnLikelihood, SparsePrior
from jstsp19_torch.solvers.gamp_full import GampOptions, gamp_est

SEED = 7
TOLERANCE = ()  # the classes of _common.tolerance
N, M, K = 400, 240, 24
LAM, WVAR = 0.1, 9.0  # 10% impulses, 9x-unit-variance hits


def build(device, gen=None):
    """The script's numpy draws (``default_rng(7)``); ``gen`` is not used."""
    rng = np.random.default_rng(SEED)
    A = rng.standard_normal((M, N)) / np.sqrt(M)
    x = np.zeros(N)
    x[rng.choice(N, K, False)] = rng.standard_normal(K)
    impulses = (rng.uniform(size=M) < LAM) * (np.sqrt(WVAR) * rng.standard_normal(M))
    f32 = torch.float32
    return {"A": torch.tensor(A, dtype=f32, device=device), "x": torch.tensor(x, dtype=f32, device=device),
            "impulses": torch.tensor(impulses, dtype=f32, device=device)}


def lines(p):
    A, x = p["A"], p["x"]
    dev = A.device
    y = (A @ x + p["impulses"])[None]
    prior = SparsePrior(base=AwgnPrior(mean0=0.0, var0=1.0), p1=K / N)
    # pvar_min floors the near-deterministic channel's collapsing precision
    # (GampOpt.pvarMin analog) — see AwbgnLikelihood's docstring.
    opts = GampOptions(nit=100, pvar_min=1e-6)
    fin_awbgn, _, _ = gamp_est(
        prior, AwbgnLikelihood(y=y, wvar=torch.tensor(WVAR, device=dev), lam=torch.tensor(LAM, device=dev)),
        MatrixOp(A), opts)
    fin_awgn, _, _ = gamp_est(prior, CAwgnLikelihood(y=y, wvar=torch.tensor(LAM * WVAR, device=dev)), MatrixOp(A),
                              opts)

    def nmse_db(xhat):
        return 10 * math.log10(max(_common.nmse(xhat[0], x), 1e-30))

    return [("n={} m={} k={}  lambda={} wvar={}", (N, M, K, LAM, WVAR)),
            ("GAMP + AwbgnLikelihood (impulse-aware): {:8.1f} dB NMSE", (nmse_db(fin_awbgn.xhat),)),
            ("GAMP + CAwgnLikelihood (avg-power AWGN): {:7.1f} dB NMSE", (nmse_db(fin_awgn.xhat),))]


def solve(problem):
    return _common.labelled(lines(problem))


def main(argv=None):
    return _common.main(build, lines, SEED, argv)


if __name__ == "__main__":
    raise SystemExit(main())
