"""Partial Walsh–Hadamard compressive sensing: the GAMP slice's problems.

A sparse real x of length n (a 256×256 image grid at n = 2^16) is measured
through m = n/4 randomly kept sequency rows of the orthonormal FWHT,
``y = SubsetOp(FWHTOp(n), idx)·x + w``, with one row set per realization:
x Bernoulli–Gaussian with activity ε = 0.05 and active entries N(0, 1/ε),
and white noise at 40 dB SNR.  It is the measurement of a single-pixel
camera or of partial-Hadamard CS recovery.  The solver sees the prior
``SparsePrior(AwgnPrior(0, 1/ε), ε)`` and the likelihood
``CAwgnLikelihood(y, wvar)``.

:func:`hadamard_cs_problem` makes the problems with numpy from a seed; the
JAX reference tool, the tests and ``chip_smoke.py`` all take them from here.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from jstsp19_torch.core.config import resolve_device
from jstsp19_torch.kernels.wht import fwht_plain
from jstsp19_torch.ops.fourier import FWHTOp
from jstsp19_torch.ops.structured import SubsetOp
from jstsp19_torch.solvers.estim import AwgnPrior, CAwgnLikelihood, SparsePrior

N, BATCH, EPS, SNR_DB, SEED = 1 << 16, 32, 0.05, 40.0, 0
GAMP_NIT, GAMP_STEP = 100, 0.9  # the lean gamp's iterations and step on this slice


def hadamard_cs_problem(seed: int = SEED, batch: int = BATCH, n: int = N, m: int = None, eps: float = EPS,
                        snr_db: float = SNR_DB, nonneg: bool = False) -> Dict[str, np.ndarray]:
    """``batch`` problems as numpy: x (batch, n) float32, idx (batch, m)
    int64 (sorted, distinct rows), y (batch, m) float32 and wvar (batch,)
    float32, the noise variance that puts the noiseless measurement
    ``snr_db`` above the noise.  m defaults to n/4.  The measurement is
    computed in float64 from the float32 x.  With ``nonneg`` x is |x| of the
    same Bernoulli–Gaussian draw (the non-negative signal of
    ``em_nngm_gamp``); the row sets and the noise draws stay the same."""
    m = n // 4 if m is None else m
    rng = np.random.default_rng(seed)
    x = ((rng.random((batch, n)) < eps) * rng.standard_normal((batch, n)) / np.sqrt(eps)).astype(np.float32)
    if nonneg:
        x = np.abs(x)
    idx = np.stack([np.sort(rng.choice(n, m, replace=False)) for _ in range(batch)]).astype(np.int64)
    z = np.take_along_axis(fwht_plain(torch.from_numpy(x.astype(np.float64))).numpy(), idx, -1)
    wvar = (z**2).mean(-1) / 10 ** (snr_db / 10)
    y = z + np.sqrt(wvar)[:, None] * rng.standard_normal((batch, m))
    return dict(x=x, idx=idx, y=y.astype(np.float32), wvar=wvar.astype(np.float32))


def hadamard_cs_torch(prob: Dict[str, np.ndarray], device=None, use_kernel: bool = True):
    """The port's (prior, likelihood, op) for a batch of problems made with
    the default ε, on ``device`` (the card unless named; without one it
    raises unless ``device="cpu"``): the measurement operator goes through
    the FWHT kernel unless ``use_kernel`` is False."""
    device = resolve_device(device)
    y = torch.from_numpy(prob["y"]).to(device)
    wvar = torch.from_numpy(prob["wvar"]).to(device)[:, None]
    op = SubsetOp(FWHTOp(prob["x"].shape[-1], use_kernel=use_kernel), torch.from_numpy(prob["idx"]).to(device))
    return SparsePrior(AwgnPrior(0.0, 1.0 / EPS), EPS), CAwgnLikelihood(y, wvar), op


def nmse_db(xhat, x) -> np.ndarray:
    """Per-realization 10·log10(‖x̂ − x‖² / ‖x‖²) of (batch, n) arrays."""
    xhat, x = np.asarray(xhat, np.float64), np.asarray(x, np.float64)
    return 10 * np.log10(((xhat - x) ** 2).sum(-1) / (x**2).sum(-1))
