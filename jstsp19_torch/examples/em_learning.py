"""EM hyper-parameter learning demos: EM-BG-AMP, EM-GM-AMP, noise autotune.

The solver learns the prior (activity, mixture weights/means/variances)
and the noise level from the data alone — the ``EMGMAMP(new)/`` and
``CAwgnEstimOut.m`` (tune flags) capabilities.

Run: python -m jstsp19_torch demo em_learning [--cpu]
"""
import math

import numpy as np
import torch

from jstsp19_torch.examples import _common
from jstsp19_torch.ops import MatrixOp
from jstsp19_torch.solvers import em_bg_vamp, em_gm_vamp

SEED = 0
TOLERANCE = ()  # the classes of _common.tolerance
N, M, WVAR, K, BETA = 512, 300, 1e-3, 40, 0.08


def build(device, gen=None):
    """The script's numpy draws (``default_rng(0)``); ``gen`` is not used."""
    rng = np.random.default_rng(SEED)
    x = np.zeros(N, complex)
    idx = rng.choice(N, K, False)
    x[idx] = (rng.standard_normal(K) + 1j * rng.standard_normal(K)) / np.sqrt(2)
    A = (rng.standard_normal((M, N)) + 1j * rng.standard_normal((M, N))) / np.sqrt(2 * M)
    y = A @ x + np.sqrt(WVAR / 2) * (rng.standard_normal(M) + 1j * rng.standard_normal(M))
    act = rng.random(N) < BETA
    big = rng.random(N) < 0.5
    amp = np.where(big, 3.0, 0.5)
    x2 = np.where(act, amp * (rng.standard_normal(N) + 1j * rng.standard_normal(N)) / np.sqrt(2), 0)
    A2 = (rng.standard_normal((M, N)) + 1j * rng.standard_normal((M, N))) / np.sqrt(2 * M)
    nv2 = 1e-3 * float(np.mean(np.abs(x2) ** 2)) * N / M
    y2 = A2 @ x2 + np.sqrt(nv2 / 2) * (rng.standard_normal(M) + 1j * rng.standard_normal(M))
    c64 = torch.complex64
    return {"x": torch.tensor(x, device=device), "A": torch.tensor(A, dtype=c64, device=device),
            "y": torch.tensor(y, dtype=c64, device=device), "x2": torch.tensor(x2, device=device),
            "A2": torch.tensor(A2, dtype=c64, device=device), "y2": torch.tensor(y2, dtype=c64, device=device),
            "nv2": torch.tensor(nv2, dtype=torch.float64, device=device)}


def lines(p):
    res = em_bg_vamp(p["y"][None], MatrixOp(p["A"]))
    nmse = 10 * math.log10(_common.nmse(res.x[0], p["x"]))
    out = [("== EM-BG-AMP (unknown sparsity/noise) ==", ()),
           ("  true sparsity {:.3f}  learned {:.3f}", (K / N, float(res.prior.p1.mean()))),
           ("  true wvar {:.1e}     learned {:.1e}", (WVAR, float(res.noise_var))),
           ("  NMSE = {:.2f} dB", (nmse,))]
    res2 = em_gm_vamp(p["y2"][None], MatrixOp(p["A2"]), n_components=3, n_em=10, nit=40)
    nmse2 = 10 * math.log10(_common.nmse(res2.x[0], p["x2"]))
    out += [("== EM-GM-AMP (two-scale complex mixture amplitudes) ==", ()),
            ("  true activity {:.3f}  learned {:.3f}", (BETA, float(res2.prior.p1))),
            ("  true wvar {:.2e}    learned {:.2e}", (float(p["nv2"]), float(res2.noise_var))),
            ("  NMSE = {:.2f} dB", (nmse2,))]
    return out


def solve(problem):
    return _common.labelled(lines(problem))


def main(argv=None):
    return _common.main(build, lines, SEED, argv)


if __name__ == "__main__":
    raise SystemExit(main())
