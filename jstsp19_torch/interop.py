"""Carry arrays from the JAX package into the port and back.

The JAX package's functions return arrays that ``numpy.asarray`` turns into
numpy; these helpers turn such numpy inputs into port tensors on a given
device (and port tensors back into numpy), so both packages can compute on
the same inputs: the ``proposed_problem`` dict, a ``Channel``, an ``AdmmState``,
a batch of conventional-branch inputs and a batch of external channel taps;
and a JAX sweep's JSON artifact becomes the port's ``SweepResult``.

For the GAMP path: all 45 estimators of ``solvers/estim.py`` (nested ones
included; a callable field such as ``denoise`` or ``out_fn`` is supplied by
the caller as a torch callable, and ``FxnhandlePrior``'s JAX key becomes a
``torch.Generator``), the operators (``MatrixOp``, ``AdjointOp``,
``ScaledOp``, ``ComposedOp``, ``ConcatOp``, ``BlockDiagOp``, ``MaskOp``,
``DiagOp``, ``IdentityOp``, ``SubsetOp``, ``CenterOp``, ``TVOp``, ``HaarOp``,
``MedImageOp``, ``DemeanRCOp``, ``UnifVarOp``, ``FWHTOp``, ``DFTOp``,
``ToeplitzOp``, ``DCTOp``), a ``GampState``, so that a JAX state can
warm-start the port, and an ``EstimInAvg`` with its draws, so that the state
evolution can average over JAX's samples.  The JAX objects are read by class name and field, so
nothing here imports JAX; the ``*_to_numpy`` helpers give the same form
back as a dict with a ``"type"`` key and numpy fields.
"""
from __future__ import annotations

import json
from typing import Dict, Mapping, Sequence, Union

import numpy as np
import torch

from jstsp19_torch.channel.widemmwave import Channel
from jstsp19_torch.harness.runner import SweepResult
from jstsp19_torch.ops import base, fourier, masked, structured
from jstsp19_torch.solvers import estim
from jstsp19_torch.solvers.admm import AdmmState
from jstsp19_torch.solvers.gamp_full import GampState
from jstsp19_torch.solvers.gamp_se import EstimInAvg

PROBLEM_KEYS = ("subY", "Omega", "A", "B", "tau_Y", "tau_S", "rho", "Zbar", "rank")
CONVENTIONAL_KEYS = ("Y_c", "A_c", "B_c", "Zbar")


def to_torch(x, device=None) -> torch.Tensor:
    """A numpy array (or array-like) as a contiguous tensor of the same
    dtype; the data is copied, so the tensor owns writable memory."""
    return torch.from_numpy(np.array(x, copy=True, order="C")).to(device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _field(obj, name: str):
    """``obj[name]`` for a mapping (what the ``*_to_numpy`` helpers return),
    else ``obj.name`` (a JAX NamedTuple)."""
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def problem_to_torch(prob: Mapping[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """A (batched) ``proposed_problem`` dict: subY, Omega, A, B, tau_Y,
    tau_S, rho, Zbar and rank (int32)."""
    out = {k: to_torch(prob[k], device) for k in PROBLEM_KEYS}
    out["rank"] = out["rank"].to(torch.int32)
    return out


def problem_to_numpy(prob: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: to_numpy(prob[k]) for k in PROBLEM_KEYS}


def channel_to_torch(ch, device=None) -> Channel:
    """A ``Channel`` (a NamedTuple or a dict with its fields) as port tensors."""
    return Channel(*(to_torch(_field(ch, f), device) for f in Channel._fields))


def channel_to_numpy(ch: Channel) -> Dict[str, np.ndarray]:
    return {f: to_numpy(getattr(ch, f)) for f in Channel._fields}


def state_to_torch(state, device=None) -> AdmmState:
    """An ``AdmmState`` (a NamedTuple or a dict with its fields), including
    the tracked basis U and the iteration count ``it`` (a Python int in the
    port)."""
    fields = {f: _field(state, f) for f in AdmmState._fields}
    return AdmmState(
        **{f: to_torch(v, device) for f, v in fields.items() if f not in ("U", "it")},
        U=None if fields["U"] is None else to_torch(fields["U"], device),
        it=None if fields["it"] is None else int(np.asarray(fields["it"])),
    )


def state_to_numpy(state: AdmmState) -> Dict[str, object]:
    out = {f: to_numpy(getattr(state, f)) for f in AdmmState._fields if f not in ("U", "it")}
    out["U"] = None if state.U is None else to_numpy(state.U)
    out["it"] = state.it
    return out


def conventional_to_torch(batch: Mapping[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """A batch of conventional-branch inputs: the HBF observation Y_c, the
    dictionaries A_c and B_c under the T_hbf budget, and the true Zbar."""
    return {k: to_torch(batch[k], device) for k in CONVENTIONAL_KEYS}


def taps_to_torch(taps, device=None) -> torch.Tensor:
    """A batch of channel taps from the JAX package (``load_nyu_taps``, the
    synthetic taps of ``error_vs_snr_nyuwireless``), numpy (..., L, Nr, Nt)
    complex, as a complex64 tensor on ``device``: what ``run_point(taps=)``,
    ``channel_from_taps`` and ``normalize_taps`` take."""
    x = np.asarray(taps)
    if x.ndim < 3 or not np.iscomplexobj(x):
        raise ValueError(f"taps must be complex (..., L, Nr, Nt), got {x.dtype} of shape {x.shape}")
    return to_torch(x.astype(np.complex64, copy=False), device)


def sweep_result_from_json(doc: Union[str, Mapping]) -> SweepResult:
    """A sweep artifact written by either package's ``save_result`` (its
    JSON text or the parsed dict) as the port's ``SweepResult``; ``raw`` and
    any other extra keys land in ``extras``."""
    d = json.loads(doc) if isinstance(doc, str) else dict(doc)
    (sweep_name, sweep_values), = d["sweep"].items()
    known = ("experiment", "sweep", "n_mc", "curves", "seconds")
    return SweepResult(
        name=d["experiment"], sweep_name=sweep_name, sweep_values=list(sweep_values),
        curves={k: list(v) for k, v in d["curves"].items()}, n_mc=d["n_mc"],
        seconds=d["seconds"], extras={k: v for k, v in d.items() if k not in known},
    )


# -- the GAMP path -------------------------------------------------------------

ESTIMATOR_FIELDS = {
    "CAwgnPrior": ("mean0", "var0"),
    "AwgnPrior": ("mean0", "var0"),
    "SparsePrior": ("base", "p1"),
    "SoftThreshPrior": ("lam",),
    "CGMPrior": ("weights", "means", "variances"),
    "CAwgnLikelihood": ("y", "wvar", "scale"),
    "ProbitLikelihood": ("y", "wvar"),
    "PoissonLikelihood": ("y", "scale"),
    "QuantizedLikelihood": ("lo", "hi"),
    "OutlierLikelihood": ("y", "wvar", "wvar_out", "lam"),
    "AwbgnLikelihood": ("y", "wvar", "lam"),
    "TruthReporterPrior": ("base", "truth"),
    "LaplacePrior": ("lam",),
    "UnifPrior": ("lo", "hi"),
    "NNGMPrior": ("weights", "means", "variances", "p1"),
    "SNIPEPrior": ("omega",),
    "EllpPrior": ("lam", "p"),
    "DiscretePrior": ("atoms", "weights"),
    "GroupSparsePrior": ("base", "p1"),
    "LogitLikelihood": ("y", "scale"),
    "RobustProbitLikelihood": ("probit", "p_flip"),
    "RobustLogitLikelihood": ("y", "p_flip", "scale"),
    "TDistLikelihood": ("y", "sigma"),
    "MultiLogitLikelihood": ("y", "D", "scale", "n_particles", "seed"),
    "LaplaceLikelihood": ("y", "lam"),
    "MagnitudeLikelihood": ("y", "wvar"),
    "DiracPrior": ("x0",),
    "NullPrior": (),
    "ElasticNetPrior": ("lam1", "lam2"),
    "NNSoftThreshPrior": ("lam",),
    "MixPrior": ("base_a", "base_b", "w"),
    "ConcatPrior": ("priors", "sizes"),
    "DiracLikelihood": ("y",),
    "MaskedLikelihood": ("base", "mask"),
    "GaussMixLikelihood": ("y", "weights", "variances"),
    "CMultAwgnLikelihood": ("y", "c", "wvar"),
    "HingeLikelihood": ("y", "scale"),
    "ConcatLikelihood": ("likes", "sizes"),
    "BGZeroMeanPrior": ("var0", "p1"),
    "EllpDMMPrior": ("alpha", "p"),
    "SoftThreshDMMPrior": ("alpha", "debias"),
    "FxnhandlePrior": ("key", "denoise", "change_factor", "n_avg", "div_min", "div_max"),
    "MultiSNIPEPrior": ("thetas", "omegas", "xvar_big"),
    "L1Likelihood": ("scale", "auto_scale", "scale_min", "scale_max", "nit_scale"),
    "NLLikelihood": ("y", "wvar", "out_fn", "n_z"),
}
_NESTED = ("base", "base_a", "base_b", "probit")  # one estimator
_NESTED_TUPLES = ("priors", "likes")  # a tuple of estimators
_CALLABLES = ("denoise", "out_fn")  # supplied by the caller as torch callables
OP_FIELDS = {
    "MatrixOp": (base, ("A",)),
    "AdjointOp": (base, ("base",)),
    "ScaledOp": (base, ("base", "alpha")),
    "ComposedOp": (base, ("outer", "inner")),
    "ConcatOp": (base, ("ops",)),
    "BlockDiagOp": (base, ("A",)),
    "MaskOp": (masked, ("Omega",)),
    "DiagOp": (masked, ("d",)),
    "IdentityOp": (structured, ("n",)),
    "SubsetOp": (structured, ("base", "idx")),
    "CenterOp": (structured, ("n",)),
    "TVOp": (structured, ("n",)),
    "HaarOp": (structured, ("n", "levels")),
    "MedImageOp": (structured, ("ny", "nx", "levels", "mask_idx")),
    "DemeanRCOp": (structured, ("base", "gam", "col", "b12", "b21", "b13", "b31")),
    "UnifVarOp": (structured, ("base", "in_avg", "out_avg")),
    "FWHTOp": (fourier, ("n", "ordering")),
    "DFTOp": (fourier, ("n",)),
    "ToeplitzOp": (fourier, ("col", "row")),
    "DCTOp": (fourier, ("n",)),
}
_SUB_OPS = ("base", "outer", "inner")
_INDEX_SETS = ("idx", "mask_idx")  # JAX's static tuples, int64 tensors here
_STATIC = (bool, int, float, complex, str)


def _kind(obj) -> str:
    return obj["type"] if isinstance(obj, Mapping) else type(obj).__name__


def _value_to_torch(v, device):
    """A Python number or string stays; an array becomes a tensor."""
    return v if isinstance(v, _STATIC) else to_torch(v, device)


def _value_to_numpy(v):
    return v if isinstance(v, _STATIC) else (to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v))


def _generator(key, device) -> torch.Generator:
    """``FxnhandlePrior.key`` as a ``torch.Generator`` on ``device``: a
    generator stays; a state from :func:`estimator_to_numpy` (uint8) is
    restored; a JAX key (its uint32 words) seeds a new one.  The probes
    differ from JAX's; what they estimate does not."""
    if isinstance(key, torch.Generator):
        return key
    words = np.asarray(key)
    g = torch.Generator(device=device or "cpu")
    if words.dtype == np.uint8:
        g.set_state(torch.from_numpy(words.copy()))
    else:
        g.manual_seed(int.from_bytes(words.tobytes(), "little") % (1 << 63))
    return g


def estimator_to_torch(est, device=None, **callables):
    """A JAX estimator (or its ``estimator_to_numpy`` dict) as the port's.
    Estimators nest (``base``, ``probit``, ``base_a``/``base_b``, the
    ``priors``/``likes`` tuples); static fields (``sizes``, ``D``,
    ``n_particles``, ``seed``, ``n_avg``, …) stay Python values; the
    callables ``denoise`` and ``out_fn`` are taken from ``callables`` (a
    torch callable each, which nested estimators share; without one the
    field's own value is kept)."""
    name = _kind(est)
    kw = {}
    for f in ESTIMATOR_FIELDS[name]:
        v = _field(est, f)
        if f in _NESTED:
            kw[f] = estimator_to_torch(v, device, **callables)
        elif f in _NESTED_TUPLES:
            kw[f] = tuple(estimator_to_torch(e, device, **callables) for e in v)
        elif f in _CALLABLES:
            kw[f] = callables.get(f, v)
        elif f == "key":
            kw[f] = _generator(v, device)
        elif f == "sizes":
            kw[f] = tuple(int(k) for k in v)
        else:
            kw[f] = _value_to_torch(v, device)
    return getattr(estim, name)(**kw)


def estimator_to_numpy(est) -> Dict[str, object]:
    """The port's estimator as a dict with a ``"type"`` key: numpy arrays,
    Python values for static fields, nested dicts for nested estimators, the
    callables themselves, and a generator's state as a uint8 array."""
    name = _kind(est)
    out = {"type": name}
    for f in ESTIMATOR_FIELDS[name]:
        v = getattr(est, f)
        if f in _NESTED:
            out[f] = estimator_to_numpy(v)
        elif f in _NESTED_TUPLES:
            out[f] = tuple(estimator_to_numpy(e) for e in v)
        elif f in _CALLABLES or f == "sizes":
            out[f] = v
        elif f == "key":
            out[f] = v.get_state().numpy()
        else:
            out[f] = _value_to_numpy(v)
    return out


def op_to_torch(op, device=None):
    """A JAX operator (or its ``op_to_numpy`` dict) as the port's; a
    ``SubsetOp``'s or ``MedImageOp``'s static index tuple becomes an int64
    tensor, a ``ConcatOp``'s operators a tuple of the port's."""
    name = _kind(op)
    module, fields = OP_FIELDS[name]
    kw = {}
    for f in fields:
        v = _field(op, f)
        if f in _SUB_OPS:
            kw[f] = op_to_torch(v, device)
        elif f == "ops":
            kw[f] = tuple(op_to_torch(o, device) for o in v)
        elif f in _INDEX_SETS:
            kw[f] = torch.as_tensor(np.asarray(v, dtype=np.int64), device=device)
        else:
            kw[f] = _value_to_torch(v, device)
    return getattr(module, name)(**kw)


def op_to_numpy(op) -> Dict[str, object]:
    """The port's operator as a dict of numpy fields (``idx`` and
    ``mask_idx`` int64 arrays, which the JAX operators take as tuples; a
    ``ConcatOp``'s ``ops`` a tuple of dicts)."""
    name = _kind(op)
    out = {"type": name}
    for f in OP_FIELDS[name][1]:
        v = getattr(op, f)
        if f in _SUB_OPS:
            out[f] = op_to_numpy(v)
        elif f == "ops":
            out[f] = tuple(op_to_numpy(o) for o in v)
        else:
            out[f] = _value_to_numpy(v)
    return out


def estim_in_avg_to_torch(avg, device=None) -> EstimInAvg:
    """A JAX ``EstimInAvg`` (or its :func:`estim_in_avg_to_numpy` dict) as the
    port's, with JAX's draws x and w and its prior as the port's."""
    return EstimInAvg(prior=estimator_to_torch(_field(avg, "prior"), device),
                      x=to_torch(_field(avg, "x"), device), w=to_torch(_field(avg, "w"), device))


def estim_in_avg_to_numpy(avg: EstimInAvg) -> Dict[str, object]:
    return {"type": "EstimInAvg", "prior": estimator_to_numpy(avg.prior), "x": to_numpy(avg.x),
            "w": to_numpy(avg.w)}


def _stack_states(states: Sequence) -> Dict[str, object]:
    """One JAX ``GampState`` per realization as one batched numpy dict: the
    per-problem scalars become (B, 1), the vectors and the window (B, …);
    the likelihood's y is stacked and its wvar becomes (B, 1)."""
    out: Dict[str, object] = {}
    for f in GampState._fields:
        if f == "likelihood":
            continue
        vals = [np.asarray(_field(s, f)) for s in states]
        out[f] = np.stack([v[None] if v.ndim == 0 else v for v in vals])
    like = _field(states[0], "likelihood")
    out["likelihood"] = {
        "type": _kind(like),
        "y": np.stack([np.asarray(_field(_field(s, "likelihood"), "y")) for s in states]),
        "wvar": np.stack([np.asarray(_field(_field(s, "likelihood"), "wvar")).reshape(1) for s in states]),
        "scale": _field(like, "scale") if isinstance(_field(like, "scale"), _STATIC)
        else np.asarray(_field(like, "scale")),
    }
    return out


def gamp_state_to_torch(state, device=None) -> GampState:
    """A ``GampState``: one JAX state (a batch of one), a sequence of JAX
    states (one per realization, stacked), or the dict of
    :func:`gamp_state_to_numpy`."""
    if not isinstance(state, Mapping):
        state = _stack_states(list(state) if isinstance(state, (list, tuple)) and not hasattr(state, "_fields")
                              else [state])
    fields = {f: to_torch(state[f], device) for f in GampState._fields if f != "likelihood"}
    return GampState(**fields, likelihood=estimator_to_torch(state["likelihood"], device))


def gamp_state_to_numpy(state: GampState) -> Dict[str, object]:
    out = {f: to_numpy(getattr(state, f)) for f in GampState._fields if f != "likelihood"}
    out["likelihood"] = estimator_to_numpy(state.likelihood)
    return out
