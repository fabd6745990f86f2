"""Sparse-recovery solver comparison on one synthetic problem.

Compares OMP, CoSaMP, FISTA, AMP, GAMP, VAMP-SLM and EM-BG-VAMP on a
Bernoulli-Gaussian compressed-sensing instance (the `examples/sparseEstim`
flavor of the reference toolbox).  Its 128×256 ``KronDictOp`` holds an A too
large for the dictionary-correlation kernel's shared memory, so the
operator's adjoint takes ``torch.matmul``.

Run: python -m jstsp19_torch demo sparse_recovery [--cpu]
"""
import math

import torch

from jstsp19_torch.core import prng
from jstsp19_torch.examples import _common
from jstsp19_torch.ops import KronDictOp, MatrixOp
from jstsp19_torch.solvers import CAwgnLikelihood, CAwgnPrior, SparsePrior, em_bg_vamp, em_gm_vamp
from jstsp19_torch.solvers.gamp import amp, fista, gamp, sure_amp
from jstsp19_torch.solvers.omp import cosamp, omp
from jstsp19_torch.solvers.vamp_slm import vamp_slm

SEED = 0
TOLERANCE = ()  # the classes of _common.tolerance
# the card against the CPU: FISTA's 300 float32 steps from a 20-step power
# iteration move its NMSE by up to 0.92% when A moves by 1e-7 (relative, the
# CPU, three draws); the H100 and the CPU are 0.25% apart
CARD_TOLERANCE = (("FISTA NMSE", "rel", 2e-2),)
M, N, K, SNR_DB = 128, 256, 12, 30.0


def build(device, gen):
    """A, the support and its values, and the noise of y from
    ``split(gen, 4)`` (the script's kA, kx, ki, kn)."""
    kA, kx, ki, kn = prng.split(gen, 4)
    A = prng.complex_normal(kA, (M, N)) / math.sqrt(M)
    idx = torch.randperm(N, generator=ki)[:K]
    beta = K / N
    x = torch.zeros(N, dtype=torch.complex64).index_put((idx,), prng.complex_normal(kx, (K,), var=1 / beta))
    y_clean = A @ x
    y = y_clean + prng.complex_normal(kn, (M,), var=_noise_var(y_clean))
    return _common.moved(dict(A=A, x=x, y=y), device)


def _noise_var(y_clean):
    return float((y_clean.abs() ** 2).mean()) * 10 ** (-SNR_DB / 10)


def lines(p):
    A, x = p["A"], p["x"]
    dev = A.device
    nv = _noise_var(A @ x)
    y = p["y"][None]
    beta = K / N
    op = MatrixOp(A)
    prior = SparsePrior(CAwgnPrior(torch.tensor(0.0 + 0j, device=dev), torch.tensor(1 / beta, device=dev)),
                        torch.tensor(beta, device=dev))
    lik = CAwgnLikelihood(y, torch.tensor(nv, device=dev))

    def nmse(xh):
        return _common.nmse(xh[0], x)

    results = {
        "OMP": nmse(omp(A, y, K).x),
        "CoSaMP": nmse(cosamp(A, y, K)),
        "FISTA": nmse(fista(y, op, lam=0.002, nit=300)),
        "AMP": nmse(amp(y, op, prior, nit=60)),
        "SURE-AMP": nmse(sure_amp(y, op, nit=60)),
        "GAMP": nmse(gamp(prior, lik, op, nit=80).x),
        "EM-GM-VAMP": nmse(em_gm_vamp(y, op, n_components=3, n_em=8, nit=40).x),
    }
    # VAMP-SLM needs the kron-structured operator protocol; wrap as 1-col kron
    kop = KronDictOp(A, torch.eye(1, dtype=A.dtype, device=dev))
    results["VAMP-SLM"] = nmse(vamp_slm(prior, y[..., None], kop, gamw=1.0 / nv, nit=50).x[..., 0])
    results["EM-BG-VAMP"] = nmse(em_bg_vamp(y[..., None], kop, n_em=8, nit=40).x[..., 0])
    out = [("m={}, n={}, k={}, SNR={} dB", (M, N, K, SNR_DB))]
    out += [("  {:12s} NMSE = {:.2e}", (name, e)) for name, e in results.items()]
    return out


def solve(problem):
    return _common.labelled(lines(problem))


def main(argv=None):
    return _common.main(build, lines, SEED, argv)


if __name__ == "__main__":
    raise SystemExit(main())
