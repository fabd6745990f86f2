"""Structured-sparsity turbo demos: Markov-chain support + EM learning.

A block-sparse signal defeats an i.i.d. spike-slab prior at a
measurement-starved operating point; the turbo loop's chain smoother
recovers it, and EM-turboGAMP learns the chain's transition probability
and sparsity rate from the data (``turboGAMP/EMturboGAMP.m``,
``ClassDefs/@MarkovChain1``).

Run: python -m jstsp19_torch demo structured_sparsity [--cpu]
"""
import numpy as np
import torch

from jstsp19_torch.examples import _common
from jstsp19_torch.ops import MatrixOp
from jstsp19_torch.solvers import CAwgnPrior, SparsePrior, em_turbo_markov_vamp, turbo_markov_vamp
from jstsp19_torch.solvers.vamp_slm import vamp_slm

SEED = 2
TOLERANCE = ()  # the classes of _common.tolerance
N, M, WVAR = 256, 110, 1e-3
P01, LAM = 0.05, 0.25  # sticky chain, stationary activity 0.25
P10 = P01 * LAM / (1 - LAM)


def build(device, gen=None):
    """The script's numpy draws (``default_rng(2)``): chains drawn until the
    realized activity is near the stationary rate; ``gen`` is not used."""
    rng = np.random.default_rng(SEED)
    while True:
        s = np.zeros(N, bool)
        st = rng.random() < LAM
        for i in range(N):
            st = (rng.random() < (1 - P01)) if st else (rng.random() < P10)
            s[i] = st
        if abs(s.mean() - LAM) < 0.02:
            break
    x = np.where(s, (rng.standard_normal(N) + 1j * rng.standard_normal(N)) / np.sqrt(2), 0)
    A = (rng.standard_normal((M, N)) + 1j * rng.standard_normal((M, N))) / np.sqrt(2 * M)
    y = A @ x + np.sqrt(WVAR / 2) * (rng.standard_normal(M) + 1j * rng.standard_normal(M))
    c64 = torch.complex64
    return {"s": torch.tensor(s, device=device), "x": torch.tensor(x, device=device),
            "A": torch.tensor(A, dtype=c64, device=device), "y": torch.tensor(y, dtype=c64, device=device)}


def lines(p):
    x, s = p["x"], p["s"]
    dev = x.device
    op = MatrixOp(p["A"])
    yj = p["y"][None]
    beta = float(s.double().mean())
    db = _common.nmse_db
    out = [("== block-sparse recovery (n={} m={}, {} active) ==", (N, M, int(s.sum())))]
    prior = SparsePrior(CAwgnPrior(torch.tensor(0.0 + 0j, device=dev), torch.tensor(1 / beta, device=dev)),
                        torch.tensor(beta, device=dev))
    res_iid = vamp_slm(prior, yj, op, gamw=1.0 / WVAR, nit=40)
    out.append(("  iid spike-slab VAMP     NMSE = {:7.2f} dB", (db(res_iid.x[0], x),)))
    res_tb = turbo_markov_vamp(yj, op, slab_var=1 / beta, gamw=1.0 / WVAR, p01=P01, p10=P10, n_turbo=6, nit=40)
    out.append(("  turbo (true chain)      NMSE = {:7.2f} dB", (db(res_tb.x[0], x),)))
    res_em = em_turbo_markov_vamp(yj, op, 1 / beta, 1.0 / WVAR, p01_init=0.5, lam_init=0.5, n_em=10)
    out.append(("  EM-turbo (learned)      NMSE = {:7.2f} dB", (db(res_em.x[0], x),)))
    out.append(("  learned p01 = {:.3f} (true {}), lam = {:.3f} (true {:.3f})",
                (float(res_em.p01), P01, float(res_em.lam), beta)))
    return out


def solve(problem):
    return _common.labelled(lines(problem))


def main(argv=None):
    return _common.main(build, lines, SEED, argv)


if __name__ == "__main__":
    raise SystemExit(main())
