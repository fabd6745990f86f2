"""The problems of the AMP, S-AMP, l1 beamspace ADMM and VAMP-SLM checks.

Each is made as numpy from a seed, so that the JAX reference tool
(``tools/torch_amp_sparse_reference.py``), the tests and ``chip_smoke.py``
solve the same inputs:

* :func:`hadamard_amp_torch`: ``amp_est`` on the partial Walsh–Hadamard
  problems of ``harness/hadamard_cs.py``.  Keeping m = n/4 rows of the
  orthonormal FWHT leaves columns of norm 1/2, so the operator is scaled by 2
  (unit-norm columns, as AMP assumes), and y by 2 and the noise variance by 4
  with it.
* :func:`spectrum_problems`: the condition-10 log-spectrum ensemble of the
  JAX package's S-AMP test and example (n 256, m 128, k 12, wvar 1e-5),
  one problem per numpy seed.
* :func:`beamspace_problem`: ``sparse_admm`` at the canonical point's
  shapes (Nr = Gr = 32, Nt = Gt = 4): each realization's subcarrier-0
  channel from the port's channel synthesis (CPU generators), plus circular
  Gaussian noise at 10 dB drawn with numpy, and the scaled DFT dictionaries.
* :func:`vamp_slm_problem`: the canonical point's VAMP problem (the
  conventional branch's Y_c, A_c, B_c at 0 dB, made on the CPU), with the
  factor scaling of ``solvers/vamp.py::vamp_mmwave`` and gamw = s²/noise_var
  per realization.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from jstsp19_torch.channel.widemmwave import dft_dictionary, taps_to_subcarriers, wideband_mmwave_channel
from jstsp19_torch.core import prng
from jstsp19_torch.core.config import resolve_device
from jstsp19_torch.harness import hadamard_cs as hcs
from jstsp19_torch.harness.pipeline import PointConfig, conventional_problem
from jstsp19_torch.ops.base import ScaledOp
from jstsp19_torch.solvers.estim import AwgnPrior, CAwgnPrior, SparsePrior

AMP_NIT = 50  # amp_est's iterations on the Hadamard problems
AMP_DAMP = 1.0
SPEC_N, SPEC_M, SPEC_K, SPEC_WVAR, SPEC_COND = 256, 128, 12, 1e-5, 10.0
SPEC_SEEDS = tuple(range(16))
SAMP_NIT, SAMP_DAMP = 200, 0.5
ADMM_BATCH, ADMM_IMAX, ADMM_RHO, ADMM_TAU_S, ADMM_SNR_DB, ADMM_SEED = 256, 100, 0.01, 1e-4, 10.0, 0
VAMP_BATCH, VAMP_NIT, VAMP_DAMP, VAMP_NOISE_VAR, VAMP_SEED = 256, 50, 0.9, 1.0, 0


def hadamard_amp_torch(prob: Dict[str, np.ndarray], device=None, use_kernel: bool = True):
    """``(y, op, prior, wvar)`` for ``amp_est`` on
    :func:`~jstsp19_torch.harness.hadamard_cs.hadamard_cs_problem`'s problems:
    the operator ``ScaledOp(SubsetOp(FWHTOp(n), idx), 2)`` with unit-norm
    columns, y·2, wvar·4 (B, 1), on ``device`` (the card unless named)."""
    prior, like, op = hcs.hadamard_cs_torch(prob, device, use_kernel=use_kernel)
    return like.y * 2.0, ScaledOp(op, 2.0), prior, like.wvar * 4.0


def spectrum_problem(seed: int, cond: float = SPEC_COND, n: int = SPEC_N, m: int = SPEC_M, k: int = SPEC_K,
                     wvar: float = SPEC_WVAR) -> Dict[str, np.ndarray]:
    """One unitarily invariant problem with log-spaced singular values of
    condition ``cond``, scaled to ‖A‖²_F = n (unit-norm columns on average),
    as ``tests/test_gamp.py::_spectrum_problem`` makes it: A (m, n) and y (m,)
    float32, x (n,) float64 with k N(0, 1) entries, evals (m,) float32 (the
    spectrum of A·Aᴴ)."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, m)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.logspace(0, -np.log10(cond), m)
    A = U @ np.diag(s) @ V[:, :m].T
    A *= np.sqrt(n / np.sum(s**2))
    evals = (s * np.sqrt(n / np.sum(s**2))) ** 2
    x = np.zeros(n)
    idx = rng.choice(n, k, False)  # drawn before the values, as the JAX test draws them
    x[idx] = rng.standard_normal(k)
    y = A @ x + np.sqrt(wvar) * rng.standard_normal(m)
    return dict(A=A.astype(np.float32), y=y.astype(np.float32), x=x, evals=evals.astype(np.float32))


def spectrum_problems(seeds=SPEC_SEEDS, cond: float = SPEC_COND) -> Dict[str, np.ndarray]:
    """:func:`spectrum_problem` for each seed, stacked along a leading axis."""
    probs = [spectrum_problem(s, cond) for s in seeds]
    return {k: np.stack([p[k] for p in probs]) for k in probs[0]}


def spectrum_prior():
    """The S-AMP problems' prior, ``SparsePrior(AwgnPrior(0, 1), k/n)``."""
    return SparsePrior(AwgnPrior(0.0, 1.0), SPEC_K / SPEC_N)


def beamspace_problem(batch: int = ADMM_BATCH, seed: int = ADMM_SEED, snr_db: float = ADMM_SNR_DB
                      ) -> Dict[str, np.ndarray]:
    """``sparse_admm``'s inputs as numpy complex64: H (batch, 32, 4), each
    realization's subcarrier-0 channel (the sum of its taps) from the port's
    canonical channel synthesis on CPU generators seeded ``seed``; OH = H plus
    CN noise ``snr_db`` below each realization's mean |H|², drawn with numpy;
    Dr = dft_dictionary(32, 32)·√32 and Dt = dft_dictionary(4, 4)·√4."""
    pc = PointConfig()
    gen = prng.role_generator(seed, 0, prng.ROLE_CHANNEL, "cpu")
    ch = wideband_mmwave_channel(gen, pc.L, pc.Nr, pc.Nt, pc.n_clusters, pc.n_rays, pc.Gr, pc.Gt, batch=(batch,))
    H = taps_to_subcarriers(ch.H, pc.L)[:, 0].numpy()
    rng = np.random.default_rng(seed)
    nv = (np.abs(H) ** 2).mean((-2, -1), keepdims=True) / 10 ** (snr_db / 10)
    W = np.sqrt(nv / 2) * (rng.standard_normal(H.shape) + 1j * rng.standard_normal(H.shape))
    Dr = dft_dictionary(pc.Nr, pc.Gr).numpy() * math.sqrt(pc.Nr)
    Dt = dft_dictionary(pc.Nt, pc.Gt).numpy() * math.sqrt(pc.Nt)
    return dict(H=H.astype(np.complex64), OH=(H + W).astype(np.complex64), Dr=Dr.astype(np.complex64),
                Dt=Dt.astype(np.complex64))


def vamp_slm_problem(batch: int = VAMP_BATCH, seed: int = VAMP_SEED, noise_var: float = VAMP_NOISE_VAR
                     ) -> Dict[str, np.ndarray]:
    """``vamp_slm``'s inputs as numpy: the canonical point's conventional
    branch (``PointConfig()``, 0 dB, CPU generators seeded ``seed``) with
    ``vamp_mmwave``'s scaling: A/sa (batch, Mr, Gr) and B/sb (batch, K, T)
    for unit spectral norms, y = Y_c/s, gamw = s²/noise_var (batch,), s =
    sa·sb, the true beamspace channel x (batch, Gr, K) and the spike-slab
    activity beta = num_nonzero / (2·Gr·K)."""
    pc = PointConfig()
    d = conventional_problem(prng.realization_generators(seed, 0, "cpu"), pc, noise_var, batch)
    A, B = d["A_c"], d["B_c"]
    sa = torch.sqrt(torch.linalg.eigvalsh(A.mH @ A)[..., -1])[..., None, None]
    sb = torch.sqrt(torch.linalg.eigvalsh(B @ B.mH)[..., -1])[..., None, None]
    s = sa * sb
    Gr, K = A.shape[-1], B.shape[-2]
    return dict(y=(d["Y_c"] / s).numpy(), A=(A / sa).numpy(), B=(B / sb).numpy(),
                gamw=(s[:, 0, 0] ** 2 / noise_var).numpy().astype(np.float32), x=d["Zbar"].numpy(),
                beta=np.float32(pc.num_nonzero / (2 * Gr * K)))


def vamp_slm_prior(beta):
    """The VAMP problem's prior, the spike-slab of ``vamp_mmwave``
    (``vamp.m:23-25``): ``SparsePrior(CAwgnPrior(0, 1/beta), beta)``."""
    return SparsePrior(CAwgnPrior(0.0, 1.0 / float(beta)), float(beta))


def to_device(prob: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """The arrays of a problem as tensors on ``device`` (the card unless
    named); numbers stay."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) if isinstance(v, np.ndarray) and v.ndim else v
            for k, v in prob.items()}


def nmse_db(xhat, x) -> np.ndarray:
    """Per-realization 10·log10(‖x̂ − x‖² / ‖x‖²) over all but the leading axis."""
    xhat, x = (np.asarray(v).astype(np.complex128).reshape(len(v), -1) for v in (xhat, x))
    return 10 * np.log10((np.abs(xhat - x) ** 2).sum(-1) / (np.abs(x) ** 2).sum(-1))
