"""Basic GAMP walkthrough: the reference's ``examples/basic/`` quartet.

Three classical problems solved through the same ``gamp_est`` interface:

1. dense Gaussian x, real AWGN measurements — GAMP converges to the
   closed-form LMMSE solution (``examples/basic/simpleAWGN.m``);
2. dense complex-Gaussian x, complex AWGN — same, natively complex
   (``examples/basic/simpleCAWGN.m``, ``AWGsignal_CAWGNmeas.m``);
3. a near-noninformative prior — GAMP approaches the regularized
   least-squares / pseudo-inverse answer (``examples/basic/simpleLS.m``).

Run: python -m jstsp19_torch demo basic_gamp [--cpu]
"""
import math

import torch

from jstsp19_torch.core import prng
from jstsp19_torch.examples import _common
from jstsp19_torch.ops import MatrixOp
from jstsp19_torch.solvers import AwgnPrior, CAwgnLikelihood, CAwgnPrior, GampOptions, gamp_est

SEED = 0
# the distance of two float32 solutions of one problem is roundoff (JAX
# 3.19e-7 and 2.34e-6, the port 8.4e-7 and 2.0e-6 on the same draws)
TOLERANCE = ((r"\|\|GAMP - ", "abs", 1e-5),)
M, N, WVAR = 300, 100, 0.01


def build(device, gen):
    """Problem 1 from ``fold_in(gen, 0)`` split in three (A, x, w), problem 2
    from ``fold_in(gen, 1)`` folded with 0, 1, 2 (A, x, w)."""
    ka, kx, kw = prng.split(prng.fold_in(gen, 0), 3)
    A = _common.normal(ka, (M, N)) / math.sqrt(M)
    x = _common.normal(kx, (N,))
    y = A @ x + math.sqrt(WVAR) * _common.normal(kw, (M,))
    k = prng.fold_in(gen, 1)
    Ac = prng.complex_normal(prng.fold_in(k, 0), (M, N), var=1.0 / M)
    xc = prng.complex_normal(prng.fold_in(k, 1), (N,))
    yc = Ac @ xc + prng.complex_normal(prng.fold_in(k, 2), (M,), var=WVAR)
    return _common.moved(dict(A=A, x=x, y=y, Ac=Ac, xc=xc, yc=yc), device)


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def lines(p):
    A, x, y, Ac, xc, yc = (p[k] for k in ("A", "x", "y", "Ac", "xc", "yc"))
    dev = A.device
    opt = GampOptions(nit=50, adapt_step=False, step=1.0, tol=1e-8)
    db = _common.nmse_db
    out = []
    # -- 1. real Gaussian x, AWGN (simpleAWGN.m)
    fin, _, _ = gamp_est(AwgnPrior(mean0=0.0, var0=1.0), CAwgnLikelihood(y=y[None], wvar=WVAR), MatrixOp(A), opt)
    xh = fin.xhat[0]
    x_lmmse = torch.linalg.solve(A.T @ A + WVAR * torch.eye(N, device=dev), A.T @ y)
    out += [("== simpleAWGN: dense Gaussian x, real AWGN ==", ()),
            ("  GAMP  NMSE = {:7.2f} dB", (db(xh, x),)),
            ("  LMMSE NMSE = {:7.2f} dB", (db(x_lmmse, x),)),
            ("  ||GAMP - LMMSE|| / ||LMMSE|| = {:.2e}", (_rel(xh, x_lmmse),))]
    # -- 2. complex Gaussian x, complex AWGN (simpleCAWGN.m)
    fin, _, _ = gamp_est(CAwgnPrior(torch.tensor(0.0 + 0j, device=dev), torch.tensor(1.0, device=dev)),
                         CAwgnLikelihood(y=yc[None], wvar=WVAR), MatrixOp(Ac), opt)
    xc_lmmse = torch.linalg.solve(Ac.mH @ Ac + WVAR * torch.eye(N, dtype=Ac.dtype, device=dev), Ac.mH @ yc)
    out += [("== simpleCAWGN: complex Gaussian x, complex AWGN ==", ()),
            ("  GAMP  NMSE = {:7.2f} dB", (db(fin.xhat[0], xc),)),
            ("  LMMSE NMSE = {:7.2f} dB", (db(xc_lmmse, xc),))]
    # -- 3. near-noninformative prior -> least squares (simpleLS.m)
    fin, _, _ = gamp_est(AwgnPrior(mean0=0.0, var0=1e4), CAwgnLikelihood(y=y[None], wvar=WVAR), MatrixOp(A), opt)
    xh = fin.xhat[0]
    x_ls = torch.linalg.lstsq(A, y[:, None]).solution[:, 0]
    out += [("== simpleLS: flat prior -> least squares ==", ()),
            ("  GAMP NMSE = {:7.2f} dB, LS NMSE = {:7.2f} dB", (db(xh, x), db(x_ls, x))),
            ("  ||GAMP - LS|| / ||LS|| = {:.2e}", (_rel(xh, x_ls),))]
    return out


def solve(problem):
    return _common.labelled(lines(problem))


def main(argv=None):
    return _common.main(build, lines, SEED, argv)


if __name__ == "__main__":
    raise SystemExit(main())
