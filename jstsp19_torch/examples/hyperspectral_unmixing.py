"""Hyperspectral unmixing with HUTAMP (pure-pixel synthetic scene).

The reference's ``examples/hyperspectral/HU_pure_pixel.m``: a scene of
N pixels, each a convex combination of R endmember spectra, observed in
T bands with noise.  HUTAMP factors Y ~= S.A with non-negative spectra A
and simplex-constrained abundances S (sum-to-one pseudo-band + EM noise
refits, ``solvers/hutamp.py``).

Run: python -m jstsp19_torch demo hyperspectral_unmixing [--cpu]
"""
import math
from itertools import permutations

import numpy as np
import torch

from jstsp19_torch.core import prng
from jstsp19_torch.examples import _common
from jstsp19_torch.solvers import hutamp

SEED = 5
# the reference's own fault (ROADMAP Queue 3): on this scene HUTAMP's
# iterates pass more than 12 sigma into the non-negative priors' tail, where
# JAX's float32 moments are roundoff (the port with JAX's formula there
# returns NaN); with its Mills-ratio series the port on JAX's draws reads
# -21.09 dB against JAX's -20.40, angles 10.25, 12.71 and 16.08 degrees
# against 10.32, 12.41 and 14.09, the abundance minimum 6.5e-5 against 4.03e-5
TOLERANCE = (("scene reconstruction", "db", 1.5), (r"min= .* #0$", "abs", 1e-4),
             (r"spectral angle = # deg #1$", "abs", 3.0))
N, T, R = 600, 48, 3


def endmembers(T=T):
    """Smooth positive "mineral" spectra, (3, T) float32."""
    t = np.linspace(0, 1, T)
    return np.stack([
        0.2 + np.exp(-0.5 * ((t - 0.25) / 0.08) ** 2),
        0.3 + 0.8 * np.exp(-0.5 * ((t - 0.6) / 0.15) ** 2),
        0.1 + 0.5 * t + 0.4 * np.exp(-0.5 * ((t - 0.9) / 0.1) ** 2),
    ]).astype(np.float32)


def draw(gen, N=N, T=T, pure=True):
    """Dirichlet abundances (with 5 pure pixels per material where ``pure``)
    from ``fold_in(gen, 0)``, Y's noise from ``fold_in(gen, 1)``; HUTAMP's
    initialization generator ``fold_in(gen, 2)``."""
    e = torch.empty((N, R)).exponential_(generator=prng.fold_in(gen, 0))
    S = e / e.sum(1, keepdim=True)
    if pure:
        for r in range(R):
            S[r * 5:r * 5 + 5] = torch.eye(R)[r]
    Z = S @ torch.tensor(endmembers(T))
    Y = Z + math.sqrt(_noise_var(Z)) * _common.normal(prng.fold_in(gen, 1), (N, T))
    return dict(S_true=S, Y=Y, key=prng.fold_in(gen, 2))


def _noise_var(Z):
    return 1e-4 * float((Z**2).mean())


def unmix(p):
    """(Z, the HUTAMP result) of :func:`draw`'s scene."""
    S_true, Y = p["S_true"], p["Y"]
    Z = S_true @ torch.tensor(endmembers(Y.shape[-1]), device=S_true.device)
    return Z, hutamp(Y[None], R, p["key"], nit=150, n_em=3, step=0.3)


def build(device, gen):
    return _common.moved(draw(gen), device)


def lines(p):
    A_true = endmembers()
    Z, res = unmix(p)
    znmse = _common.nmse(res.Z[0], Z)
    Ae = res.A[0].double().cpu().numpy()
    S = res.S[0]

    def cos(r, q):
        return np.dot(Ae[q], A_true[r]) / (np.linalg.norm(Ae[q]) * np.linalg.norm(A_true[r]) + 1e-12)

    # permutation-align endmembers by cosine similarity
    best_p, best_c = None, -1.0
    for perm in permutations(range(R)):
        c = np.mean([cos(r, perm[r]) for r in range(R)])
        if c > best_c:
            best_p, best_c = perm, c
    sad = [float(np.degrees(np.arccos(np.clip(cos(r, best_p[r]), -1.0, 1.0)))) for r in range(R)]
    out = [("== HUTAMP unmixing: N={} pixels, T={} bands, R={} materials ==", (N, T, R)),
           ("  scene reconstruction NMSE = {:.2f} dB", (10 * math.log10(znmse + 1e-12),)),
           ("  abundance rows on simplex: min={:.2e}, row-sum err={:.2e}",
            (float(S.min()), float((S.sum(1) - 1).abs().max())))]
    out += [("  endmember {}: spectral angle = {:5.2f} deg", (r, sad[r])) for r in range(R)]
    return out


def solve(problem):
    return _common.labelled(lines(problem))


def main(argv=None):
    return _common.main(build, lines, SEED, argv)


if __name__ == "__main__":
    raise SystemExit(main())
