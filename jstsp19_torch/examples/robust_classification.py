"""Robust binary + multinomial classification through GAMP.

The reference's ``classification/`` tail (``TestRobitGAMP`` capability):
sparse weight recovery when a fraction of training labels are flipped,
comparing the clean probit channel against the outlier-robust variants
(robust probit, robust logit, robit/t2), plus a small multinomial-logit
posterior demo.

Run: python -m jstsp19_torch demo robust_classification [--cpu]
"""
import math

import numpy as np
import torch

from jstsp19_torch.core import prng
from jstsp19_torch.examples import _common
from jstsp19_torch.ops import MatrixOp
from jstsp19_torch.solvers import (AwgnPrior, MultiLogitLikelihood, ProbitLikelihood, RobustLogitLikelihood,
                                   RobustProbitLikelihood, SparsePrior, TDistLikelihood)
from jstsp19_torch.solvers.gamp import gamp

SEED = 7
TOLERANCE = ()  # the classes of _common.tolerance
N, M, K = 64, 256, 8
P_FLIP = 0.08


def build(device, gen):
    """A and the label flips from ``split(gen, 2)`` (the script's kA, kf)."""
    kA, kf = prng.split(gen, 2)
    A = _common.normal(kA, (M, N)) / math.sqrt(N)
    y_clean = (A @ _x0() > 0).float()
    y = torch.where(torch.rand(M, generator=kf) < P_FLIP, 1.0 - y_clean, y_clean)
    return _common.moved(dict(A=A, y=y), device)


def _x0(device=None):
    return torch.where(torch.arange(N, device=device) < K, 2.0, 0.0)


def lines(p):
    A = p["A"]
    dev = A.device
    x0 = _x0(dev)
    y = p["y"][None]
    t = lambda v: torch.tensor(v, device=dev)  # noqa: E731
    prior = SparsePrior(AwgnPrior(t(0.0), t(4.0)), t(K / N))
    op = MatrixOp(A)

    def corr(xhat):
        xhat = xhat[0]
        return float((xhat * x0).sum() / torch.clamp(torch.linalg.vector_norm(xhat) * torch.linalg.vector_norm(x0),
                                                     min=1e-12))

    channels = {
        "probit (clean model)": ProbitLikelihood(y, t(0.04)),
        "robust probit": RobustProbitLikelihood(ProbitLikelihood(y, t(0.04)), t(P_FLIP)),
        "robust logit": RobustLogitLikelihood(y, t(P_FLIP), t(3.0)),
        "robit (t2 CDF)": TDistLikelihood(y, t(0.5)),
    }
    out = [("{} samples, {:.0%} flipped labels — weight-vector corr:", (M, P_FLIP))]
    for name, lik in channels.items():
        out.append(("  {:22s} corr = {:.4f}", (name, corr(gamp(prior, lik, op, nit=30).x))))
    # multinomial softmax posterior (MultiLogitEstimOut capability)
    lik = MultiLogitLikelihood(torch.tensor([0, 2], device=dev), D=3, n_particles=2048)
    phat = torch.tensor([[0.5, -0.2, 0.1], [-1.0, 0.3, 0.8]], device=dev)
    zhat, _ = lik.estim(phat, torch.full((2, 3), 0.5, device=dev))
    out += [("multi-logit posterior means (labels 0, 2):", ()),
            ("{}", (np.round(zhat.cpu().numpy(), 3),))]
    return out


def solve(problem):
    return _common.labelled(lines(problem))


def main(argv=None):
    return _common.main(build, lines, SEED, argv)


if __name__ == "__main__":
    raise SystemExit(main())
