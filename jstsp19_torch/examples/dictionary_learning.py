"""Bilinear GAMP demos: EM matrix completion with rank selection,
BiG-AMP-Lite's cheap all-Gaussian fast path, and EM dictionary learning.

The ``BiGAMP/`` capability family (``EMBiGAMP_MC.m``, ``BiGAMP_Lite.m``,
``EMBiGAMP_DL.m``): recover Z = A·X from partial / noisy observations with
both factors unknown.

Run: python -m jstsp19_torch demo dictionary_learning [--cpu]
"""
import math

import numpy as np
import torch

from jstsp19_torch.core import prng
from jstsp19_torch.examples import _common
from jstsp19_torch.solvers import bigamp_lite, em_bigamp_dl, em_bigamp_mc

SEED = 0
TOLERANCE = ()  # the classes of _common.tolerance
L, M, R, NV = 64, 64, 4, 1e-4
LD, RD, MD, LAM_TRUE = 24, 5, 400, 0.15


def build(device, gen):
    """The script's numpy draws (``default_rng(0)``); the solvers'
    initialization generators ``fold_in(gen, 0)`` (completion and Lite) and
    ``fold_in(gen, 1)`` (dictionary learning), the script's PRNGKey(0) and
    PRNGKey(1)."""
    rng = np.random.default_rng(SEED)
    A0 = (rng.standard_normal((L, R)) + 1j * rng.standard_normal((L, R))) / np.sqrt(2)
    X0 = (rng.standard_normal((R, M)) + 1j * rng.standard_normal((R, M))) / np.sqrt(2)
    Z0 = A0 @ X0
    mask = (rng.random((L, M)) < 0.5).astype(float)
    Y = (Z0 + np.sqrt(NV / 2) * (rng.standard_normal((L, M)) + 1j * rng.standard_normal((L, M)))) * mask
    D0 = (rng.standard_normal((LD, RD)) + 1j * rng.standard_normal((LD, RD))) / np.sqrt(2)
    support = rng.random((RD, MD)) < LAM_TRUE
    C0 = support * (rng.standard_normal((RD, MD)) + 1j * rng.standard_normal((RD, MD))) / np.sqrt(2)
    Zd = D0 @ C0
    nvd = 1e-4 * float(np.mean(np.abs(Zd) ** 2))
    Yd = Zd + np.sqrt(nvd / 2) * (rng.standard_normal((LD, MD)) + 1j * rng.standard_normal((LD, MD)))
    c64 = torch.complex64
    return {"Z0": torch.tensor(Z0, device=device), "mask": torch.tensor(mask, dtype=torch.float32, device=device),
            "Y": torch.tensor(Y, dtype=c64, device=device), "Zd": torch.tensor(Zd, device=device),
            "Yd": torch.tensor(Yd, dtype=c64, device=device), "key0": prng.fold_in(gen, 0),
            "key1": prng.fold_in(gen, 1)}


def lines(p):
    Z0, Y, mask = p["Z0"], p["Y"][None], p["mask"][None]

    def db(Zh, Z):
        return 10 * math.log10(_common.nmse(Zh[0], Z))

    res = em_bigamp_mc(Y, mask, 8, p["key0"], nit=300, n_em=3, step=0.5)
    out = [("== EM-BiG-AMP matrix completion (50% observed, true rank 4) ==", ()),
           ("  selected rank = {},  NMSE = {:.2f} dB", (int(res.rank[0]), db(res.Z, Z0)))]
    r_lite, hist = bigamp_lite(Y, mask, R, 1.0, 1.0, NV, p["key0"], nit=400, step=0.05)
    out += [("== BiG-AMP-Lite (three matmuls per iteration) ==", ()),
            ("  NMSE = {:.2f} dB, adaptive pass rate = {:.2f}",
             (db(r_lite.Z, Z0), float(hist["passed"][0].double().mean())))]
    res_dl = em_bigamp_dl(p["Yd"][None], RD, p["key1"])
    out += [("== EM-BiG-AMP dictionary learning (15%-sparse codes) ==", ()),
            ("  reconstruction NMSE = {:.2f} dB, learned sparsity = {:.3f} (true {})",
             (db(res_dl.Z, p["Zd"]), float(res_dl.sparsity[0]), LAM_TRUE))]
    return out


def solve(problem):
    return _common.labelled(lines(problem))


def main(argv=None):
    return _common.main(build, lines, SEED, argv)


if __name__ == "__main__":
    raise SystemExit(main())
