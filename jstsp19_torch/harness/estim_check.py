"""The estimator library on a device against the CPU, on the same inputs.

:func:`estimator_cases` makes, with numpy from a seed, one case for each of
the 45 classes of :mod:`jstsp19_torch.solvers.estim`: its parameters and its
inputs (estimates with sd 1 and variances in [0.5, 1.5], so that every tail
form stays within about 8 standard deviations, where float32 resolves its
moments), at a batch and length the caller names.  :func:`compare_devices`
runs ``estim`` and whichever of ``estim_map``, ``loglike`` and ``logscale``
the class has on the CPU and on the device and gives each class's largest
|Δ| beside the CPU's largest |value| and the tolerance: 1e-5 of it for the
closed forms, 1e-4 for the truncated-normal tails, the quadrature rules and
the particle sums.  ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` use
both.
"""
from __future__ import annotations

import contextlib
import io
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from jstsp19_torch.solvers import estim as E

CLOSED, TAIL = 1e-5, 1e-4
HOOKS = ("estim", "estim_map", "loglike", "logscale")
# the truncated-normal tails, the quadrature rules and the particle sums
TAIL_FORMS = frozenset({
    "ProbitLikelihood", "QuantizedLikelihood", "LaplacePrior", "UnifPrior", "NNGMPrior", "LogitLikelihood",
    "RobustProbitLikelihood", "RobustLogitLikelihood", "TDistLikelihood", "MultiLogitLikelihood",
    "LaplaceLikelihood", "MagnitudeLikelihood", "NNSoftThreshPrior", "HingeLikelihood", "NLLikelihood",
})


class Case(NamedTuple):
    name: str
    make: Callable  # device -> (estimator, (a, v, a2) tensors on the device)
    tol: float


class Comparison(NamedTuple):
    name: str
    hooks: Tuple[str, ...]
    max_abs_err: float
    scale: float
    tol: float

    @property
    def ok(self) -> bool:
        return self.max_abs_err <= self.tol * self.scale


def estimator_cases(batch: int = 32, n: int = 65536, seed: int = 0) -> List[Case]:
    """One case per class, its numpy data drawn once from ``seed``: inputs
    (batch, n), except the group prior's (batch, n/4, 4) and the multinomial
    channel's (batch, n/4, 4)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def draw(shape, cplx=False, scale=1.0):
        x = rng.standard_normal(shape) * scale
        if cplx:
            x = x + 1j * rng.standard_normal(shape) * scale
        return x.astype(np.complex64 if cplx else f32)

    def inputs(shape, cplx=False):
        return draw(shape, cplx), (rng.random(shape) + 0.5).astype(f32), draw(shape, cplx, 0.5)

    flat, grouped = (batch, n), (batch, n // 4, 4)
    y, yc = draw(flat), draw(flat, True)
    lab = (rng.random(flat) < 0.5).astype(f32)
    lo = (np.floor(draw(flat) * 2) / 2).astype(f32)
    mask = rng.random(flat) < 0.7
    gain = draw(flat, True)
    truth = draw(flat, True)
    labels = rng.integers(0, 4, grouped[:2]).astype(np.int64)
    w3, m3, v3 = np.array([0.5, 0.3, 0.2], f32), draw((3,), True), np.array([0.5, 1.0, 2.0], f32)
    qpsk = (np.array([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j]) / np.sqrt(2)).astype(np.complex64)
    real_in, cplx_in, group_in, ml_in = inputs(flat), inputs(flat, True), inputs(grouped), inputs(grouped)

    def cawgn(t):
        return E.CAwgnPrior(t(np.complex64(0.3 + 0.1j)), 2.0)

    def lin(r, v):
        return 0.6 * r

    specs: Dict[str, Tuple[Callable, tuple]] = {
        "CAwgnPrior": (cawgn, cplx_in),
        "AwgnPrior": (lambda t: E.AwgnPrior(0.3, 2.0), real_in),
        "SparsePrior": (lambda t: E.SparsePrior(cawgn(t), 0.1), cplx_in),
        "SoftThreshPrior": (lambda t: E.SoftThreshPrior(1.5), cplx_in),
        "CGMPrior": (lambda t: E.CGMPrior(t(w3), t(m3), t(v3)), cplx_in),
        "CAwgnLikelihood": (lambda t: E.CAwgnLikelihood(t(yc), 0.1, 1.3), cplx_in),
        "ProbitLikelihood": (lambda t: E.ProbitLikelihood(t(lab), 0.05), real_in),
        "PoissonLikelihood": (lambda t: E.PoissonLikelihood(t(np.abs(y) * 3), 1.5), real_in),
        "QuantizedLikelihood": (lambda t: E.QuantizedLikelihood(t(lo), t(lo + 0.5)), real_in),
        "OutlierLikelihood": (lambda t: E.OutlierLikelihood(t(yc), 0.01, 4.0, 0.1), cplx_in),
        "AwbgnLikelihood": (lambda t: E.AwbgnLikelihood(t(y), 0.5, 0.2), real_in),
        "TruthReporterPrior": (lambda t: E.TruthReporterPrior(cawgn(t), t(truth)), cplx_in),
        "LaplacePrior": (lambda t: E.LaplacePrior(1.2), real_in),
        "UnifPrior": (lambda t: E.UnifPrior(-0.5, 1.5), real_in),
        "NNGMPrior": (lambda t: E.NNGMPrior(t(w3), t(np.abs(m3.real)), t(v3), 0.3), real_in),
        "SNIPEPrior": (lambda t: E.SNIPEPrior(2.5), cplx_in),
        "EllpPrior": (lambda t: E.EllpPrior(0.8, 0.5), cplx_in),
        "DiscretePrior": (lambda t: E.DiscretePrior(t(qpsk), t(np.array([0.1, 0.4, 0.3, 0.2], f32))), cplx_in),
        "GroupSparsePrior": (lambda t: E.GroupSparsePrior(E.AwgnPrior(0.3, 2.0), 0.2), group_in),
        "LogitLikelihood": (lambda t: E.LogitLikelihood(t(lab), 2.0), real_in),
        "RobustProbitLikelihood": (lambda t: E.RobustProbitLikelihood(E.ProbitLikelihood(t(lab), 0.05), 0.1),
                                   real_in),
        "RobustLogitLikelihood": (lambda t: E.RobustLogitLikelihood(t(lab), 0.1, 2.0), real_in),
        "TDistLikelihood": (lambda t: E.TDistLikelihood(t(lab), 0.3), real_in),
        "MultiLogitLikelihood": (lambda t: E.MultiLogitLikelihood(t(labels), D=4, scale=1.5, n_particles=64,
                                                                  seed=3), ml_in),
        "LaplaceLikelihood": (lambda t: E.LaplaceLikelihood(t(y), 1.5), real_in),
        "MagnitudeLikelihood": (lambda t: E.MagnitudeLikelihood(t(np.abs(yc)), 0.1), cplx_in),
        "DiracPrior": (lambda t: E.DiracPrior(t(np.complex64(0.5 - 0.2j))), cplx_in),
        "NullPrior": (lambda t: E.NullPrior(), cplx_in),
        "ElasticNetPrior": (lambda t: E.ElasticNetPrior(0.7, 0.4), cplx_in),
        "NNSoftThreshPrior": (lambda t: E.NNSoftThreshPrior(1.3), real_in),
        "MixPrior": (lambda t: E.MixPrior(cawgn(t), E.CAwgnPrior(0.0, 0.1), 0.3), cplx_in),
        "ConcatPrior": (lambda t: E.ConcatPrior((cawgn(t), E.NullPrior(), E.SoftThreshPrior(1.0)),
                                                (n // 2, 2, n - n // 2 - 2)), cplx_in),
        "DiracLikelihood": (lambda t: E.DiracLikelihood(t(yc)), cplx_in),
        "MaskedLikelihood": (lambda t: E.MaskedLikelihood(E.CAwgnLikelihood(t(yc), 0.1), t(mask)), cplx_in),
        "GaussMixLikelihood": (lambda t: E.GaussMixLikelihood(t(yc), t(w3), t(v3 / 4)), cplx_in),
        "CMultAwgnLikelihood": (lambda t: E.CMultAwgnLikelihood(t(yc), t(gain), 0.2), cplx_in),
        "HingeLikelihood": (lambda t: E.HingeLikelihood(t(lab), 1.5), real_in),
        "ConcatLikelihood": (lambda t: E.ConcatLikelihood((E.CAwgnLikelihood(t(yc[:, :n - 2]), 0.1),
                                                           E.DiracLikelihood(t(np.zeros((batch, 2), np.complex64)))),
                                                          (n - 2, 2)), cplx_in),
        "BGZeroMeanPrior": (lambda t: E.BGZeroMeanPrior(2.0, 0.2), real_in),
        "EllpDMMPrior": (lambda t: E.EllpDMMPrior(1.2, 0.7), cplx_in),
        "SoftThreshDMMPrior": (lambda t: E.SoftThreshDMMPrior(1.2, True), cplx_in),
        "FxnhandlePrior": (lambda t: E.FxnhandlePrior(torch.Generator(device=t.device).manual_seed(seed),
                                                      denoise=lin, n_avg=2), real_in),
        "MultiSNIPEPrior": (lambda t: E.MultiSNIPEPrior(t(np.array([-1.0, 0.0, 2.0], np.complex64)),
                                                        t(np.array([1.0, 2.0, 0.5], f32)), xvar_big=10.0), cplx_in),
        "L1Likelihood": (lambda t: E.L1Likelihood(0.8, auto_scale=True, nit_scale=3), cplx_in),
        "NLLikelihood": (lambda t: E.NLLikelihood(t(np.tanh(y)), 0.05, out_fn=torch.tanh, n_z=40), real_in),
    }

    def case(name, ctor, data):
        def make(device):
            def t(x):
                return torch.from_numpy(np.ascontiguousarray(x)).to(device)
            t.device = torch.device(device)
            return ctor(t), tuple(t(x) for x in data)
        return Case(name, make, TAIL if name in TAIL_FORMS else CLOSED)

    return [case(name, ctor, data) for name, (ctor, data) in specs.items()]


def _outputs(est, hook, a, v, a2):
    if hook == "logscale":
        out = est.logscale(a, v, a2)
    else:
        out = getattr(est, hook)(a, v)
    return out if isinstance(out, tuple) else (out,)


def compare_devices(case: Case, device) -> Comparison:
    """The case's hooks on the CPU and on ``device``: the largest |Δ| over
    every output (NaN where either is NaN counts as a miss), and the CPU's
    largest |value|.  ``TruthReporterPrior``'s report lines are swallowed."""
    cpu_est, cpu_in = case.make("cpu")
    dev_est, dev_in = case.make(device)
    hooks = tuple(h for h in HOOKS if hasattr(cpu_est, h))
    err, scale = 0.0, 0.0
    with contextlib.redirect_stdout(io.StringIO()):
        for hook in hooks:
            for ref, got in zip(_outputs(cpu_est, hook, *cpu_in), _outputs(dev_est, hook, *dev_in)):
                got = got.cpu()
                ref, got = torch.broadcast_tensors(ref, got)
                finite = torch.isfinite(ref)
                if not torch.equal(finite, torch.isfinite(got)):
                    return Comparison(case.name, hooks, float("nan"), 0.0, case.tol)
                err = max(err, float((got[finite] - ref[finite]).abs().max()) if finite.any() else 0.0)
                scale = max(scale, float(ref[finite].abs().max()) if finite.any() else 0.0)
    return Comparison(case.name, hooks, err, scale, case.tol)
