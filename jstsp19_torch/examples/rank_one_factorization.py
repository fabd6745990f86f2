"""Rank-one matrix factorization: AMP-style fit vs state evolution.

The ``matrixFactor/`` capability (``rankOneFit.m``, ``rankOneSE.m``,
``rankOneTest.m``): fit A = u0·v0ᵀ + noise with Onsager-corrected
alternating MMSE estimation, and overlay the empirical squared
correlations against the scalar SE prediction.

Run: python -m jstsp19_torch demo rank_one_factorization [--cpu]
"""
import math

import numpy as np
import torch

from jstsp19_torch.core import prng
from jstsp19_torch.examples import _common
from jstsp19_torch.solvers import AwgnPrior, DiscretePrior, mc_prior_mse, prior_moments, rank_one_fit, rank_one_se

SEED = 0
# the SE's mc_prior_mse draws its 8192 samples with the port's generator:
# the standard errors of corr(u) and corr(v), the spread over 16 seeds (the
# port on the CPU), at 0, 5 and 10 dB
_SE = {1: (0.056, 0.129), 2: (0.0081, 0.0048), 3: (0.0033, 0.0012)}
TOLERANCE = tuple((rf"^0{row} .* #{k + 3}$", "mc", se[k]) for row, se in _SE.items() for k in (0, 1))
# the card against the CPU in float64: at 0 dB, below the transition, the
# float32 fit's squared correlations (~1e-3) are 20% off float64's on the
# CPU; in float64 a 1e-9 relative change of the draws moves them 1e-11
FLOAT64 = True
M, N, NX = 1000, 500, 100
SNRS = (0.0, 5.0, 10.0)


def _priors(device=None, dtype=torch.float32):
    """u Gaussian; v sparse-exponential on the reference's discrete grid
    (rankOneSE.m:53-66)."""
    x = np.linspace(1 / NX, 2, NX)
    px = np.exp(-x)
    px = 0.1 * px / px.sum()
    estimu = AwgnPrior(torch.tensor(0.0, dtype=dtype, device=device), torch.tensor(1.0, dtype=dtype, device=device))
    estimv = DiscretePrior(torch.tensor(np.concatenate([[0.0], x]), dtype=dtype, device=device),
                           torch.tensor(np.concatenate([[0.9], px]), dtype=dtype, device=device))
    return estimu, estimv


def _v_sampler(estimv):
    w = estimv.weights / estimv.weights.sum()
    return lambda k, nn: estimv.atoms[torch.multinomial(w.to(k.device), nn, replacement=True, generator=k).to(
        estimv.atoms.device)]


def build(device, gen):
    """u0, v0 and the unit noise matrix from ``split(gen, 3)`` (the script's
    ku, kv, kw; one noise draw serves every SNR, scaled); the fit's
    initialization generator seeded with 0 (JAX's default key)."""
    ku, kv, kw = prng.split(gen, 3)
    _, estimv = _priors()
    u0 = _common.normal(ku, (M,))
    v0 = _v_sampler(estimv)(kv, N)
    noise = _common.normal(kw, (M, N))
    return _common.moved(dict(u0=u0, v0=v0, noise=noise, fit_key=torch.Generator().manual_seed(0)), device)


def _fresh(key):
    """The fit's key as the problem holds it: the script hands every fit the
    same key, so a generator, which its draws advance, is given afresh; an
    immutable key is passed as it is."""
    if isinstance(key, torch.Generator):
        return torch.Generator(key.device).manual_seed(key.initial_seed())
    return key


def lines(p):
    u0, v0 = p["u0"], p["v0"]
    dev = u0.device
    estimu, estimv = _priors(dev, u0.dtype)
    um, uv = prior_moments(estimu)
    vm, vv = prior_moments(estimv)
    usq0 = float(um**2 + uv)
    vsq0 = float(vm**2 + vv)

    def corr(a, b):
        a, b = a.double(), b.double()
        return float((a * b).sum().abs() ** 2 / ((a * a).sum() * (b * b).sum()))

    out = [("snr(dB)  fit corr(u)  fit corr(v)  SE corr(u)  SE corr(v)", ())]
    for snr_db in SNRS:
        wvar = usq0 * vsq0 * 10 ** (-0.1 * snr_db)
        A = torch.outer(u0, v0) + math.sqrt(M * wvar) * p["noise"]
        res = rank_one_fit(A[None], estimu, estimv, torch.tensor(wvar, dtype=u0.dtype, device=dev),
                           key=_fresh(p["fit_key"]), nit=10)
        mse_u = mc_prior_mse(lambda k, nn: torch.randn(nn, generator=k, device=k.device), estimu, device=dev)
        mse_v = mc_prior_mse(_v_sampler(estimv), estimv, device=dev)
        corru_se, corrv_se = rank_one_se(mse_u, mse_v, N / M, um, uv, vm, vv, torch.tensor(wvar, dtype=u0.dtype),
                                         nit=10)
        out.append(("{:7.1f}  {:11.4f}  {:11.4f}  {:10.4f}  {:10.4f}",
                    (snr_db, corr(res.u[0], u0), corr(res.v[0], v0), float(corru_se[-1]), float(corrv_se[-1]))))
    return out


def solve(problem):
    return _common.labelled(lines(problem))


def main(argv=None):
    return _common.main(build, lines, SEED, argv)


if __name__ == "__main__":
    raise SystemExit(main())
