"""Carry arrays from the JAX package into the port and back.

The JAX package's functions return arrays that ``numpy.asarray`` turns into
numpy; these helpers turn such numpy inputs into port tensors on a given
device (and port tensors back into numpy), so both packages can compute on
the same inputs: the ``proposed_problem`` dict, a ``Channel``, an ``AdmmState``
and a batch of conventional-branch inputs; and a JAX sweep's JSON artifact
becomes the port's ``SweepResult``.
"""
from __future__ import annotations

import json
from typing import Dict, Mapping, Union

import numpy as np
import torch

from jstsp19_torch.channel.widemmwave import Channel
from jstsp19_torch.harness.runner import SweepResult
from jstsp19_torch.solvers.admm import AdmmState

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
