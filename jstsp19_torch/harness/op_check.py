"""The structured operators, the random constructors and the state evolutions
on a device against the CPU, on the same inputs.

:func:`operator_cases` names each operator of the slice with a factory that
builds it on a device from numpy drawn once from a seed: ``HaarOp``,
``MedImageOp``, ``TVOp``, ``CenterOp``, a ``ConcatOp`` of two
``SubsetOp(FWHTOp)`` (the FWHT kernel on the card), ``BlockDiagOp`` and
``rbf_kernel_op``'s Gram.  :func:`compare_operator` applies ``mv``, ``rmv``,
``sq_mv`` and ``sq_rmv`` to the same batch on the CPU and on the device and
gives the largest |Δ| of any map relative to that map's largest |value|
(limit 1e-5, float32 roundoff in another summation order) and the adjoint
identity ⟨y, A·x⟩ = ⟨Aᴴ·y, x⟩ on the device (limit 1e-4 of |⟨y, A·x⟩|).
:func:`compare_state_evolutions` runs ``gamp_se``, ``amp_se``,
``vamp_slm_se`` and ``vamp_glm_se`` on both with the same draws (limit 1e-4
of the trajectory's largest value: means of iterated float32 sums), and
:func:`random_op_structure` checks the random constructors' structure on the
device.  ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` use them.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from jstsp19_torch.core import prng
from jstsp19_torch.ops import base, fourier, structured
from jstsp19_torch.solvers import estim as E
from jstsp19_torch.solvers import gamp_se, vamp, vamp_slm

OP_TOL, ADJ_TOL, SE_TOL = 1e-5, 1e-4, 1e-4
MAPS = ("mv", "rmv", "sq_mv", "sq_rmv")


class Comparison(NamedTuple):
    name: str
    max_rel: float  # the largest |Δ| of any map over that map's largest |value|
    adjoint_rel: float  # |⟨y, A·x⟩ − ⟨Aᴴ·y, x⟩| / |⟨y, A·x⟩| on the device
    tol: float

    @property
    def ok(self) -> bool:
        return self.max_rel <= self.tol and self.adjoint_rel <= ADJ_TOL


def _cn(rng, shape) -> np.ndarray:
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / math.sqrt(2)).astype(np.complex64)


def operator_cases(n: int = 65536, haar_levels: int = 16, image: int = 256, image_levels: int = 4,
                   m: int = 16384, blocks: Tuple[int, int, int] = (64, 128, 256), rbf: Tuple[int, int] = (1024, 16),
                   seed: int = 0) -> List[Tuple[str, Callable]]:
    """(name, factory(device) -> operator) for each operator at the sizes
    given (``chip_smoke.py`` [19d] takes the defaults), its numpy data drawn
    once from ``seed``."""
    rng = np.random.default_rng(seed)
    mask = np.sort(rng.choice(image * image, m, replace=False))
    rows = [np.sort(rng.choice(n, n // 4, replace=False)) for _ in range(2)]
    A = _cn(rng, blocks)
    X = rng.standard_normal(rbf).astype(np.float32)

    def t(x, device):
        return torch.from_numpy(x).to(device)

    return [
        (f"HaarOp({n}, {haar_levels})", lambda d: structured.HaarOp(n, haar_levels)),
        (f"MedImageOp({image}, {image}, {image_levels}, m={m})",
         lambda d: structured.MedImageOp(image, image, image_levels, t(mask, d))),
        (f"TVOp({n})", lambda d: structured.TVOp(n)),
        (f"CenterOp({n})", lambda d: structured.CenterOp(n)),
        (f"ConcatOp of two SubsetOp(FWHTOp({n}))",
         lambda d: base.ConcatOp(tuple(structured.SubsetOp(fourier.FWHTOp(n), t(r, d)) for r in rows))),
        (f"BlockDiagOp{blocks}", lambda d: base.BlockDiagOp(t(A, d))),
        (f"rbf_kernel_op(X {rbf}, gamma=1/{rbf[1]})", lambda d: structured.rbf_kernel_op(t(X, d), 1.0 / rbf[1])),
    ]


def _draw(rng, shape, batch, real=False):
    """A batch of inputs for one side of an operator: a tuple of them where
    the side is a tuple of shapes (``ConcatOp``'s outputs)."""
    if shape and isinstance(shape[0], tuple):
        return tuple(_draw(rng, s, batch, real) for s in shape)
    full = (batch,) + tuple(shape)
    return rng.random(full).astype(np.float32) if real else _cn(rng, full)


def _to(x, device):
    return tuple(_to(v, device) for v in x) if isinstance(x, tuple) else torch.from_numpy(x).to(device)


def _flat(x) -> torch.Tensor:
    """One (batch, ·) tensor on the CPU from an output or a tuple of them."""
    return torch.cat([_flat(v) for v in x], -1) if isinstance(x, tuple) else x.reshape(x.shape[0], -1).cpu()


def compare_operator(name: str, factory: Callable, device, batch: int = 4, seed: int = 1) -> Comparison:
    """The operator's four maps on the CPU and on ``device``, the same batch."""
    rng = np.random.default_rng(seed)
    cpu, dev = factory("cpu"), factory(device)
    inputs = {"mv": _draw(rng, cpu.in_shape, batch), "rmv": _draw(rng, cpu.out_shape, batch),
              "sq_mv": _draw(rng, cpu.in_shape, batch, real=True), "sq_rmv": _draw(rng, cpu.out_shape, batch, real=True)}
    worst = 0.0
    outs = {}
    for fn in MAPS:
        ref = _flat(getattr(cpu, fn)(_to(inputs[fn], "cpu")))
        got = getattr(dev, fn)(_to(inputs[fn], device))
        outs[fn] = got
        worst = max(worst, float((_flat(got) - ref).abs().max() / ref.abs().max()))
    x, y = _flat(_to(inputs["mv"], "cpu")), _flat(_to(inputs["rmv"], "cpu"))
    lhs = complex((y.conj().to(torch.complex128) * _flat(outs["mv"]).to(torch.complex128)).sum())
    rhs = complex((_flat(outs["rmv"]).conj().to(torch.complex128) * x.to(torch.complex128)).sum())
    return Comparison(name, worst, abs(lhs - rhs) / abs(lhs), OP_TOL)


def compare_state_evolutions(device, seed: int = 2) -> List[Comparison]:
    """``gamp_se``, ``amp_se``, ``vamp_slm_se`` and ``vamp_glm_se`` on the
    CPU and on ``device`` with the same draws (drawn once on the CPU): a
    Bernoulli–Gaussian prior of activity 0.1, 65536 samples for GAMP's SE,
    8192 for AMP's, 4096 for VAMP's, 40 iterations each."""
    gen = torch.Generator().manual_seed(seed)
    beta = 0.1
    x_real = gamp_se.bg_sampler(beta)(gen, 65536)
    w_real = torch.randn(65536, generator=gen)
    x_c = torch.where(torch.rand(8192, generator=gen) < beta, prng.complex_normal(gen, (8192,), var=1 / beta), 0)
    w_c = prng.complex_normal(gen, (8192,))
    d = torch.linspace(0.0, 2.0, 512)
    spike = E.SparsePrior(E.CAwgnPrior(0.0, 1.0 / beta), beta)

    def runs(dev):
        avg = gamp_se.EstimInAvg(E.SparsePrior(E.AwgnPrior(0.0, 1.0), beta), x_real.to(dev), w_real.to(dev))
        draws = (x_c.to(dev), w_c.to(dev))
        short = (x_c[:4096].to(dev), w_c[:4096].to(dev))
        return {
            "gamp_se": gamp_se.gamp_se(avg, gamp_se.AwgnOutAvg(1e-4), beta=2.0, nit=40)["mse"],
            "amp_se": vamp_slm.amp_se(None, spike, 0.5, 1e-3, nit=40, draws=draws),
            "vamp_slm_se": vamp_slm.vamp_slm_se(None, spike, d.to(dev), 100.0, nit=40, draws=short),
            "vamp_glm_se": vamp.vamp_glm_se(None, spike, vamp.cawgn_likelihood_mse(1e-2), d.to(dev), 1024, 0.5,
                                            nit=40, draws=short),
        }

    ref, got = runs("cpu"), runs(device)
    return [Comparison(k, float((got[k].cpu() - ref[k]).abs().max() / ref[k].abs().max()), 0.0, SE_TOL)
            for k in ref]


def random_op_structure(device, m: int = 4096, n: int = 16384, d: int = 8, n_unitary: int = 256,
                        seed: int = 3) -> Dict[str, Tuple[float, bool]]:
    """The random constructors drawn on ``device``: {check: (value, ok)} for
    ``expander_graph_op(m, n, d)`` (exactly d nonzeros a column, every one
    1/√d, so unit column norms) and ``random_unitary_op(n_unitary)``
    (max|QᴴQ − I| ≤ 1e-4, float32 QR roundoff of order n·eps)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    A = structured.expander_graph_op(gen, m, n, d).A
    nnz = (A != 0).sum(0)
    vals = A[A != 0]
    Q = structured.random_unitary_op(gen, n_unitary).A
    err = float((Q.mH @ Q - torch.eye(n_unitary, device=Q.device)).abs().max())
    return {
        f"expander_graph_op({m}, {n}, {d}): nonzeros a column (min, max)": (
            (int(nnz.min()), int(nnz.max())), bool((nnz == d).all())),
        f"expander_graph_op({m}, {n}, {d}): max|value - 1/sqrt(d)|": (
            float((vals - 1 / math.sqrt(d)).abs().max()), bool((vals - 1 / math.sqrt(d)).abs().max() <= 1e-7)),
        f"random_unitary_op({n_unitary}): max|Q^H Q - I|": (err, err <= 1e-4),
    }
