"""Application-family demos: one small instance per capability.

Mirrors the reference's application example directories
(``MPbased_solvers/phase/``, ``classification/``, ``PBiGAMP/``,
``HUTAMP/``): phase retrieval with PR-GAMP, sparse logistic
classification, self-calibration with parametric bilinear GAMP, and
hyperspectral unmixing.

Run: python -m jstsp19_torch demo applications [--cpu]
"""
import math

import torch

from jstsp19_torch.core import prng
from jstsp19_torch.examples import _common, hyperspectral_unmixing, self_calibration
from jstsp19_torch.ops import MatrixOp
from jstsp19_torch.solvers import AwgnPrior, CAwgnPrior, LogitLikelihood, MagnitudeLikelihood, SparsePrior
from jstsp19_torch.solvers.gamp import gamp

SEED = 5
# the unmixing demo's scene family sits on the reference fault of
# hyperspectral_unmixing: JAX 2.69e-3, the port on JAX's draws 2.649e-3 (1.5%)
TOLERANCE = (("hyperspectral unmixing", "rel", 5e-2),)
PR_N, PR_M = 64, 384
CL_N, CL_P, CL_K, CL_SCALE = 128, 800, 8, 3.0
SEEDS = {"phase": 5, "classification": 7, "calibration": 11, "unmixing": 9}


def build(device, gen):
    """Each demo from ``fold_in(gen, seed)`` with the script's seed, folded
    as the script folds its key."""
    k = prng.fold_in(gen, SEEDS["phase"])
    A = prng.complex_normal(prng.fold_in(k, 0), (PR_M, PR_N)) / math.sqrt(PR_N)
    x = prng.complex_normal(prng.fold_in(k, 1), (PR_N,))
    y = (A @ x + prng.complex_normal(prng.fold_in(k, 2), (PR_M,), var=_pr_noise_var(A, x))).abs()
    out = {"pr_A": A, "pr_x": x, "pr_y": y}
    k = prng.fold_in(gen, SEEDS["classification"])
    X = _common.normal(prng.fold_in(k, 0), (CL_P, CL_N)) / math.sqrt(CL_K)
    idx = torch.randperm(CL_N, generator=prng.fold_in(k, 1))[:CL_K]
    w = torch.zeros(CL_N).index_put((idx,), _common.normal(prng.fold_in(k, 2), (CL_K,)))
    y = (torch.rand(CL_P, generator=prng.fold_in(k, 3)) < torch.sigmoid(CL_SCALE * (X @ w))).float()
    out.update(cl_X=X, cl_w=w, cl_y=y)
    cal = self_calibration.draw(prng.fold_in(gen, SEEDS["calibration"]))
    out.update({f"sc_{key}": v for key, v in cal.items()})
    hsi = hyperspectral_unmixing.draw(prng.fold_in(gen, SEEDS["unmixing"]), N=400, pure=False)
    out.update({f"hu_{key}": v for key, v in hsi.items()})
    return _common.moved(out, device)


def _pr_noise_var(A, x):
    return 1e-4 * float(((A @ x).abs() ** 2).mean())


def _phase_retrieval(p):
    A, x, y = p["pr_A"], p["pr_x"], p["pr_y"]
    dev = A.device
    m, n = A.shape
    wvar = _pr_noise_var(A, x)
    Mspec = A.mH @ (y[:, None] ** 2 * A) / m
    x0 = torch.linalg.eigh(Mspec)[1][:, -1] * math.sqrt(n * 1.0)
    t = lambda v: torch.tensor(v, device=dev)  # noqa: E731
    res = gamp(CAwgnPrior(t(0.0 + 0j), t(1.0)), MagnitudeLikelihood(y[None], t(wvar)), MatrixOp(A), nit=150,
               step=0.5, x_init=x0[None])
    rx = res.x[0]
    ph = (rx.conj() * x).sum()
    ph = ph / torch.clamp(ph.abs(), min=1e-30)
    return _common.nmse(ph * rx, x)


def _classification(p):
    X, w, y = p["cl_X"], p["cl_w"], p["cl_y"]
    dev = X.device
    t = lambda v: torch.tensor(v, device=dev)  # noqa: E731
    prior = SparsePrior(AwgnPrior(t(0.0), t(1.0)), t(CL_K / CL_N))
    rx = gamp(prior, LogitLikelihood(y[None], CL_SCALE), MatrixOp(X), nit=60, step=0.5).x[0].double()
    w = w.double()
    return float((rx * w).sum().abs() / torch.clamp(torch.linalg.vector_norm(rx) * torch.linalg.vector_norm(w),
                                                    min=1e-30))


def lines(p):
    z, _, _, res = self_calibration.calibrate({k[3:]: v for k, v in p.items() if k.startswith("sc_")})
    Z, res_hu = hyperspectral_unmixing.unmix({k[3:]: v for k, v in p.items() if k.startswith("hu_")})
    return [("application-family demos:", ()),
            ("  phase retrieval (m=6n)      NMSE = {:.2e}", (_phase_retrieval(p),)),
            ("  logit classification        weight corr = {:.3f}", (_classification(p),)),
            ("  self-calibration (PBiGAMP)  z-NMSE = {:.2e}", (_common.nmse(res.z[0], z),)),
            ("  hyperspectral unmixing      Z-NMSE = {:.2e}", (_common.nmse(res_hu.Z[0], Z),))]


def solve(problem):
    return _common.labelled(lines(problem))


def main(argv=None):
    return _common.main(build, lines, SEED, argv)


if __name__ == "__main__":
    raise SystemExit(main())
