"""The proposed branch's front end replayed as one CUDA graph per point shape.

``harness.pipeline.proposed_problem`` draws a point's realizations and builds
its solver problem in about 160 small launches; on the card the host issuing
them, not the device, sets their pace.  :func:`problem` runs that code
(``pipeline._problem``: the draws, the oracle order and rank, the
dictionaries, τ_Y, τ_S and the Gram of the hyper-parameters) eagerly at the
first call of each shape, captures it into a ``torch.cuda.CUDAGraph`` at
the second, and from then on replays it: one launch in place of the
stream.  A shape called once (a one-pass sweep, a smoke check) thus costs
no capture and holds no graph memory; the capture and the graph's pool pay
off only where a shape's calls repeat.  ``eigvalsh`` and ρ stay eager,
after the replay: ``eigvalsh`` reads its error flag back, which a capture
may not hold.

What the graph reads at a replay, and so what may vary between the points of
one shape:

- the random streams: each graph draws from one generator per role of its
  own, registered with it, and reseeded from the caller's generators' seeds
  before each replay.  Philox takes its seed and offset at the replay, so
  the draws are those the caller's fresh generators would make eagerly, and
  the caller's generators are then advanced as those draws advance them;
- the noise variance, a float32 device scalar filled before each replay.

Everything else the graph's code sees is in its key (:func:`key`): the
device, the batch and the whole ``PointConfig``.  The outputs are copied
out of the graph's buffers, so a later replay leaves a result alone.  ``problem.captures`` and ``problem.replays`` count the
process's captures and replays.
"""
from __future__ import annotations

import numbers
from typing import Dict, NamedTuple, Optional

import torch

from jstsp19_torch.core import prng
from jstsp19_torch.core.config import REAL_DTYPE
from jstsp19_torch.core.trace import span


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    gens: Dict[int, torch.Generator]  # one per role, registered with ``graph``
    noise_var: torch.Tensor  # the float32 scalar the noise's scale reads
    outputs: Dict[str, torch.Tensor]  # the graph's own buffers


_GRAPHS: Dict[tuple, Optional[_Graph]] = {}  # None: the shape was called once, eagerly


def takes(gens, noise_var, H_ext=None, rows=None) -> bool:
    """Whether :func:`problem` may answer this ``proposed_problem`` call:
    one fresh CUDA generator (offset 0) of every role on one device, a
    noise variance given as a number, and neither external taps nor a slice
    of rows.  Every other call runs the front end eagerly."""
    if H_ext is not None or rows is not None or not isinstance(noise_var, numbers.Real):
        return False
    if not set(prng.ROLES) <= set(gens):
        return False
    device = gens[prng.ROLE_CHANNEL].device
    return device.type == "cuda" and all(
        gens[r].device == device and gens[r].get_offset() == 0 for r in prng.ROLES)


def key(pc, batch: int, device) -> tuple:
    """What the captured code sees of a call besides its random streams and
    noise variance: the device, the batch and the point's configuration."""
    return torch.device(device), batch, pc


def _capture(pc, batch: int, device: torch.device) -> _Graph:
    """Capture the front end of ``pc``'s shape, after one eager run on the
    capture's stream, which makes the lazy initialisations (the QAM alphabet
    on the device, cuBLAS's handle and workspace for that stream) that a
    capture may not."""
    from jstsp19_torch.harness import pipeline

    gens = prng.realization_generators(0, 0, device)  # reseeded before each replay
    noise_var = torch.ones((), dtype=REAL_DTYPE, device=device)
    graph = torch.cuda.CUDAGraph()
    for g in gens.values():
        graph.register_generator_state(g)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        pipeline._problem(gens, pc, noise_var, batch)
    torch.cuda.current_stream(device).wait_stream(stream)
    with torch.cuda.graph(graph, stream=stream):
        outputs = pipeline._problem(gens, pc, noise_var, batch)
    problem.captures += 1
    return _Graph(graph, gens, noise_var, outputs)


def problem(gens, pc, noise_var: float, batch: int) -> Dict[str, torch.Tensor]:
    """``pipeline._problem(gens, pc, noise_var, batch)`` for a call
    :func:`takes`, bit for bit: eagerly at the first call of its shape, from
    the graph of its shape at every later one (captured at the second).
    The caller's generators end where the eager call would leave them."""
    from jstsp19_torch.harness import pipeline

    device = gens[prng.ROLE_CHANNEL].device
    k = key(pc, batch, device)
    if k not in _GRAPHS:
        _GRAPHS[k] = None
        return pipeline._problem(gens, pc, noise_var, batch)
    entry = _GRAPHS[k]
    if entry is None:
        entry = _GRAPHS[k] = _capture(pc, batch, device)
    with span("replay"):
        for role, g in entry.gens.items():
            g.manual_seed(gens[role].initial_seed())
        entry.noise_var.fill_(noise_var)
        entry.graph.replay()
        for role, g in entry.gens.items():
            gens[role].set_offset(g.get_offset())
        problem.replays += 1
        # G goes straight to eigvalsh, on this stream, before any later replay can write it
        return {name: t if name == "G" else t.clone() for name, t in entry.outputs.items()}


problem.captures = 0
problem.replays = 0
