"""Low-rank matrix completion: SVT vs ADMM-MC vs BiG-AMP.

Run: python -m jstsp19_torch demo matrix_completion [--cpu]
"""
import torch

from jstsp19_torch.core import prng
from jstsp19_torch.examples import _common
from jstsp19_torch.solvers import bigamp_mc, mc_admm, mc_svt

SEED = 0
TOLERANCE = ()  # the classes of _common.tolerance
L, M, R, OBS_FRAC, NV = 48, 64, 3, 0.5, 1e-3


def build(device, gen):
    """The factors, the mask and the noise from ``fold_in(gen, 0..3)``;
    BiG-AMP's initialization draws from ``fold_in(gen, 4)`` (kept, not
    drawn here)."""
    Af = prng.complex_normal(prng.fold_in(gen, 0), (L, R))
    Xf = prng.complex_normal(prng.fold_in(gen, 1), (R, M))
    mask = (torch.rand((L, M), generator=prng.fold_in(gen, 2)) < OBS_FRAC).float()
    Z = Af @ Xf
    Y = mask * (Z + prng.complex_normal(prng.fold_in(gen, 3), (L, M), var=NV))
    return _common.moved(dict(Z=Z, mask=mask, Y=Y, key=prng.fold_in(gen, 4)), device)


def lines(p):
    Z, mask, Y = p["Z"][None], p["mask"][None], p["Y"][None]

    def nmse(Zh):
        return _common.nmse(Zh[0], Z[0])

    Z_svt = mc_svt(Y, mask, Imax=300, tau=5.0, rho=1.0)
    Z_admm, _ = mc_admm(Z, Y, mask, Imax=300, tau=0.5, rho=1.0)
    Z_big = bigamp_mc(Y, mask, R, NV, p["key"], nit=300, step=0.5).Z
    return [("{}x{} rank-{}, {}% observed", (L, M, R, int(OBS_FRAC * 100))),
            ("  SVT-MC    NMSE = {:.2e}", (nmse(Z_svt),)),
            ("  ADMM-MC   NMSE = {:.2e}", (nmse(Z_admm),)),
            ("  BiG-AMP   NMSE = {:.2e}", (nmse(Z_big),))]


def solve(problem):
    return _common.labelled(lines(problem))


def main(argv=None):
    return _common.main(build, lines, SEED, argv)


if __name__ == "__main__":
    raise SystemExit(main())
