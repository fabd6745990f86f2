"""Compressed-sensing MRI reconstruction with GAMP — the ``MRI/`` family.

The reference's medical-imaging application acquires undersampled,
noise-free k-space data of a wavelet-sparse image through
``Z = M·F·Wᴴ·X`` (``main/MedImageLinTrans.m``).  Here the same operator
(``ops/structured.py::MedImageOp``: binary k-space mask ∘ orthonormal 2-D
DFT ∘ multi-level 2-D Haar synthesis) reconstructs a synthetic
piecewise-constant phantom from a fraction of k-space via GAMP with a
spike-slab wavelet prior, vs the naive zero-filled inverse FFT.

Run: python -m jstsp19_torch demo cs_mri [--cpu]
"""
import math

import numpy as np
import torch

from jstsp19_torch.examples import _common
from jstsp19_torch.ops import MedImageOp
from jstsp19_torch.solvers import CAwgnLikelihood, CAwgnPrior, SparsePrior
from jstsp19_torch.solvers.gamp_full import GampOptions, gamp_est

SEED = 2
TOLERANCE = ()  # the classes of _common.tolerance
NY = NX = 32
LEVELS = 3
FRAC = 0.35  # 35% of k-space acquired


def _phantom(ny, nx, rng):
    """Piecewise-constant blocks — sparse under the Haar basis."""
    img = np.zeros((ny, nx))
    for _ in range(6):
        y0, x0 = rng.integers(0, ny - 8, 2)
        h, w = rng.integers(4, ny // 3, 2)
        img[y0:y0 + h, x0:x0 + w] += rng.uniform(0.3, 1.0)
    return img


def build(device, gen=None):
    """The script's numpy draws (``default_rng(2)``): the phantom and the
    variable-density k-space mask; ``gen`` is not used."""
    rng = np.random.default_rng(SEED)
    n = NY * NX
    img = _phantom(NY, NX, rng)
    keep = set()
    for i in range(NY):
        for j in range(NX):
            if min(i, NY - i) <= 2 and min(j, NX - j) <= 2:
                keep.add(i * NX + j)
    rest = [k for k in range(n) if k not in keep]
    keep |= set(rng.choice(rest, int(FRAC * n) - len(keep), False).tolist())
    idx = sorted(keep)
    return {"img": torch.tensor(img, device=device), "idx": torch.tensor(idx, dtype=torch.int64, device=device)}


def lines(p):
    img, idx = p["img"], p["idx"]
    dev, n = img.device, NY * NX
    op = MedImageOp(NY, NX, LEVELS, idx)
    c_true = op._analysis(img.to(torch.complex64))
    y = op.mv(c_true.reshape(1, -1))
    k_sparsity = float((c_true.abs() > 1e-3).float().mean())
    prior = SparsePrior(base=CAwgnPrior(mean0=torch.tensor(0.0 + 0.0j, device=dev), var0=torch.tensor(1.0, device=dev)),
                        p1=max(k_sparsity, 0.02))
    fin, _, _ = gamp_est(prior, CAwgnLikelihood(y=y, wvar=torch.tensor(1e-6, device=dev)), op,
                         GampOptions(nit=80, pvar_min=1e-8))
    rec = op._synthesis(fin.xhat[0].reshape(NY, NX)).real
    # zero-filled baseline: scatter the acquired k-space, inverse FFT
    full = torch.zeros(n, dtype=torch.complex64, device=dev).index_put((idx,), y[0])
    zf = torch.fft.ifft2(full.reshape(NY, NX), norm="ortho").real

    def nmse_db(x):
        e = _common.nmse(x.double(), img)
        return 10 * math.log10(max(e, 1e-30))

    m = idx.numel()
    return [("{}x{} phantom, {}/{} k-space samples ({:.0f}%), Haar levels={}, wavelet density={:.2f}",
             (NY, NX, m, n, 100 * m / n, LEVELS, k_sparsity)),
            ("GAMP + MedImageOp reconstruction: {:7.1f} dB NMSE", (nmse_db(rec),)),
            ("zero-filled IFFT baseline:        {:7.1f} dB NMSE", (nmse_db(zf),))]


def solve(problem):
    return _common.labelled(lines(problem))


def main(argv=None):
    return _common.main(build, lines, SEED, argv)


if __name__ == "__main__":
    raise SystemExit(main())
