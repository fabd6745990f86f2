"""Self-calibration with parametric bilinear GAMP (P-BiG-AMP).

The reference's ``examples/PBiGAMP/PBiGAMPiidBGawgn.m`` /
``affine_BG_AWGN.m`` use case: a sensor array with UNKNOWN per-measurement
complex gains b measures a sparse vector c through a known matrix Phi,

    y_m = b_m . (Phi c)_m + w_m        i.e.  z_m = b^T A[m] c,

with the measurement tensor A[m] = e_m Phi_{m,:}.  P-BiG-AMP jointly
estimates the gains and the signal; the EM wrapper additionally learns the
noise level and sparsity rate (``solvers/pbigamp.py``).

Run: python -m jstsp19_torch demo self_calibration [--cpu]
"""
import math

import torch

from jstsp19_torch.core import prng
from jstsp19_torch.examples import _common
from jstsp19_torch.solvers import CAwgnPrior, SparsePrior, pbigamp

SEED = 11
TOLERANCE = ()  # the classes of _common.tolerance
# the card against the CPU in float64: the genie LMMSE solves a system of
# condition ~1e6 (AᴴA of rank 96 in 128, ridge nv·β ≈ 6e-6), so float32
# solvers part by up to 0.6 dB (the CPU -7.07, the H100 -6.48; float64 -6.97)
FLOAT64 = True
M, NC, K = 96, 128, 8
GAIN_VAR = 0.05


def draw(gen, M=M, Nc=NC, k=K, gain_var=GAIN_VAR):
    """Phi, c, b and y's noise from ``fold_in(gen, 0..4)``; P-BiG-AMP's
    initialization generator ``fold_in(gen, 5)``."""
    Phi = prng.complex_normal(prng.fold_in(gen, 0), (M, Nc)) / math.sqrt(M)
    beta = k / Nc
    act = torch.rand(Nc, generator=prng.fold_in(gen, 1)) < beta
    c = torch.where(act, prng.complex_normal(prng.fold_in(gen, 2), (Nc,), var=1 / beta), 0.0)
    b = 1.0 + prng.complex_normal(prng.fold_in(gen, 3), (M,), var=gain_var)
    z = b * (Phi @ c)
    y = z + prng.complex_normal(prng.fold_in(gen, 4), (M,), var=_noise_var(z))
    return dict(Phi=Phi, c_true=c.to(torch.complex64), b_true=b, y=y, key=prng.fold_in(gen, 5))


def _noise_var(z):
    return 1e-4 * float((z.abs() ** 2).mean())


def calibrate(p, gain_var=GAIN_VAR):
    """(z_true, y, nv, the P-BiG-AMP result) of :func:`draw`'s problem."""
    Phi, c_true, b_true = p["Phi"], p["c_true"], p["b_true"]
    dev = Phi.device
    M, Nc = Phi.shape
    beta = K / Nc
    z_true = b_true * (Phi @ c_true)
    nv, y = _noise_var(z_true), p["y"]
    A = torch.zeros((M, M, Nc), dtype=Phi.dtype, device=dev)
    A[torch.arange(M), torch.arange(M), :] = Phi
    t = lambda v: torch.tensor(v, device=dev)  # noqa: E731
    prior_b = CAwgnPrior(t(1.0 + 0j), t(gain_var))
    prior_c = SparsePrior(CAwgnPrior(t(0.0 + 0j), t(1.0 / beta)), t(beta))
    res = pbigamp(y[None], A, prior_b, prior_c, nv, p["key"], nit=200, step=0.5)
    return z_true, y, nv, res


def build(device, gen):
    return _common.moved(draw(gen), device)


def lines(p):
    Phi, c_true, b_true = p["Phi"], p["c_true"], p["b_true"]
    z_true, y, nv, res = calibrate(p)
    rc, rb, rz = res.c[0], res.b[0], res.z[0]
    db = _common.nmse_db
    # resolve the bilinear scale ambiguity before factor-wise NMSE
    al = (rc.conj() * c_true).sum() / torch.clamp((rc.conj() * rc).sum().real, min=1e-30)
    out = [("== P-BiG-AMP self-calibration: unknown gains x sparse signal ==", ()),
           ("  M={} measurements, Nc={} unknowns, k={} active, gain spread {}", (M, NC, K, GAIN_VAR)),
           ("  z  (ambiguity-free)  NMSE = {:7.2f} dB", (db(rz, z_true),)),
           ("  c  (scale-aligned)   NMSE = {:7.2f} dB", (db(al * rc, c_true),)),
           ("  b  (scale-aligned)   NMSE = {:7.2f} dB", (db(rb / al.conj(), b_true),))]
    # genie baseline: gains known exactly -> plain LMMSE on active support
    Phi_g = b_true[:, None] * Phi
    beta = K / NC
    c_lmmse = torch.linalg.solve(Phi_g.mH @ Phi_g + nv * beta * torch.eye(NC, dtype=Phi.dtype, device=Phi.device),
                                 Phi_g.mH @ y)
    out.append(("  genie known-gain LMMSE c NMSE = {:7.2f} dB (dense; no sparsity)", (db(c_lmmse, c_true),)))
    return out


def solve(problem):
    return _common.labelled(lines(problem))


def main(argv=None):
    return _common.main(build, lines, SEED, argv)


if __name__ == "__main__":
    raise SystemExit(main())
