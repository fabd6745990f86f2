"""S-AMP on a non-i.i.d. (unitarily-invariant) measurement ensemble.

Standard AMP assumes an i.i.d.-subgaussian operator; on a spectrally
shaped ensemble (here: log-spaced singular values, condition 10) it
diverges.  The reference toolbox's answer is ``ampEst.m``'s exact-rvar
mode (``opt.Stransform``, ``ampEst.m:221-268``): the Onsager gain
becomes ``1 − 1/S(−xvar/rvar)`` and the denoiser-input variance solves
the fixed point ``rvar = wvar·S(−xvar/rvar)``, with ``S`` the
S-transform of the operator spectrum.  This script compares plain AMP,
S-AMP (``amp_est`` with ``evals_aah``), and VAMP-SLM (whose LMMSE stage
handles arbitrary spectra exactly) on the same instance.  Its
``KronDictOp`` is real and takes ``torch.matmul`` for its adjoint.

Run: python -m jstsp19_torch demo s_amp [--cpu]
"""
import numpy as np
import torch

from jstsp19_torch.examples import _common
from jstsp19_torch.ops import KronDictOp, MatrixOp
from jstsp19_torch.solvers import amp, amp_est
from jstsp19_torch.solvers.estim import AwgnPrior, SparsePrior
from jstsp19_torch.solvers.vamp_slm import vamp_slm

SEED = 0
TOLERANCE = ()  # the classes of _common.tolerance
# the card against the CPU in float64: on the card, float32 eigh's roundoff in
# the 128-dimensional null space of AᵀA, times VAMP-SLM's noise precision 1e5,
# moves its NMSE from 1.51e-5 (the CPU, and JAX) to 2.40e-5 (H100); the CPU's
# float32 run moves under 1e-3 with A perturbed by 1e-7 relative
FLOAT64 = True
N, M, K, WVAR, COND = 256, 128, 12, 1e-5, 10.0


def build(device, gen=None):
    """The script's numpy draws (``default_rng(0)``); ``gen`` is not used."""
    rng = np.random.default_rng(SEED)
    U, _ = np.linalg.qr(rng.standard_normal((M, M)))
    V, _ = np.linalg.qr(rng.standard_normal((N, N)))
    s = np.logspace(0, -np.log10(COND), M)
    A = U @ np.diag(s) @ V[:, :M].T
    A *= np.sqrt(N / np.sum(s**2))
    evals = (s * np.sqrt(N / np.sum(s**2))) ** 2
    x = np.zeros(N)
    idx = rng.choice(N, K, False)
    x[idx] = rng.standard_normal(K)
    y = A @ x + np.sqrt(WVAR) * rng.standard_normal(M)
    f32 = torch.float32
    return {"A": torch.tensor(A, dtype=f32, device=device), "evals": torch.tensor(evals, dtype=f32, device=device),
            "x": torch.tensor(x, device=device), "y": torch.tensor(y, dtype=f32, device=device)}


def lines(p):
    A, x, y = p["A"], p["x"], p["y"][None]
    op = MatrixOp(A)
    prior = SparsePrior(base=AwgnPrior(mean0=0.0, var0=1.0), p1=K / N)
    out = [("{}x{} log-spectrum ensemble, condition {:.0f}, k={}", (N, M, COND, K))]
    out.append(("  AMP (i.i.d. assumption)  NMSE = {:.2e}", (_common.nmse(amp(y, op, prior, nit=100)[0], x),)))
    xs = amp_est(y, op, prior, nit=200, wvar=WVAR, evals_aah=p["evals"], damp=0.5)
    out.append(("  S-AMP (exact rvar)       NMSE = {:.2e}", (_common.nmse(xs[0], x),)))
    kop = KronDictOp(A, torch.eye(1, dtype=A.dtype, device=A.device))
    xv = vamp_slm(prior, y[..., None], kop, gamw=1.0 / WVAR, nit=50).x[0, :, 0]
    out.append(("  VAMP-SLM                 NMSE = {:.2e}", (_common.nmse(xv, x),)))
    return out


def solve(problem):
    return _common.labelled(lines(problem))


def main(argv=None):
    return _common.main(build, lines, SEED, argv)


if __name__ == "__main__":
    raise SystemExit(main())
