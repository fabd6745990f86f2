"""The tracked route's ADMM solve replayed as one CUDA graph per shape.

``solvers.admm.proposed_admm`` with ``svt_method='tracked'`` issues about
139 launches an iteration, Imax iterations a solve.  Even where each launch
moves a large iterate (51 MB at 10⁴ realizations of errorVSnrf's N = 32,
M = 20), the host issues them only about as fast as the card runs them, so
a solve's time follows the host's speed and whatever else the host is
doing.  :func:`solve` runs a solve eagerly at the first call of its key
(:func:`key`), which makes the lazy initialisations a capture may not (the
kernels' libraries, the tracked step's tables), captures the same code into
a ``torch.cuda.CUDAGraph`` at the second call, and from then on replays
it: one launch from the host in place of the stream, the same kernels in
the same order, the same bits.  A key called once (a one-pass sweep, a
smoke check) costs no capture and holds no graph memory.

What a replay reads, and so what may vary between calls of one key: the
tensors of ``INPUTS``, copied into the graph's own buffers (of the same
strides) first.  Their shapes, strides and dtypes and every option are in
the key.  The graphs of a device are captured on one stream into one
memory pool, which they share as they run one at a time, on the caller's
stream, and a result is copied out of the graph's buffers, so a later
replay leaves it alone.  The kernel wrappers' launch counts (``kernels.launch_counts``) rise
by a replay's launches as they would eagerly.  ``solve.captures`` and
``solve.replays`` count the process's captures and replays.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from jstsp19_torch import kernels
from jstsp19_torch.core.trace import span

INPUTS = ("subY", "Omega", "A", "B", "tau_Y", "tau_S", "rho", "support_rank")


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: Dict[str, torch.Tensor]  # the buffers the graph reads
    result: tuple  # the AdmmResult in the graph's own buffers
    launches: Dict[str, int]  # the kernel wrappers' launches of one replay


_GRAPHS: Dict[tuple, Optional[_Graph]] = {}  # None: the key was called once, eagerly
_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}  # the stream a device's captures run on


def options_take(options: dict) -> bool:
    """Whether a solve with these options can be captured: the tracked route
    in approximate mode with the kernels, no convergence log (its spectral
    norm reads ``eigvalsh``'s error flag back, which a capture may not hold)
    and no warm start."""
    return (options["svt_method"] == "tracked" and options["mode"] == "approximate"
            and not options["track_convergence"] and options["init_state"] is None and options["use_kernels"])


def takes(inputs: dict, options: dict) -> bool:
    """Whether :func:`solve` may answer this ``proposed_admm`` call: options
    that :func:`options_take`, and every input a dense (:func:`_dense`),
    resolved tensor on one CUDA device (``support_rank`` may be None),
    outside any capture.  Every other call runs eagerly."""
    y = inputs["subY"]
    if not (options_take(options) and isinstance(y, torch.Tensor) and y.is_cuda):
        return False
    if torch.cuda.is_current_stream_capturing():
        return False
    return all(isinstance(t, torch.Tensor) and t.device == y.device and _dense(t) and not t.is_conj()
               for name, t in inputs.items() if not (name == "support_rank" and t is None))


def _dense(t: torch.Tensor) -> bool:
    """Whether t's elements fill its storage span once each, in some order of
    its dimensions (a contiguous tensor, or a transpose of one): a buffer of
    the same strides then holds it exactly."""
    expected = 1
    for stride, size in sorted((st, sz) for st, sz in zip(t.stride(), t.shape) if sz != 1):
        if stride != expected:
            return False
        expected *= size
    return True


def key(inputs: dict, options: dict) -> tuple:
    """What the captured code sees of a call besides its inputs' values: the
    device, each input's shape, strides and dtype (or its absence), every
    option, and whether CUDA float32 products may use TF32."""
    shapes = tuple((name, None if t is None else (tuple(t.shape), t.stride(), t.dtype))
                   for name, t in inputs.items())
    return (inputs["subY"].device, shapes, tuple(sorted(options.items())),
            torch.backends.cuda.matmul.allow_tf32)


def _copy(res):
    """``res`` (an AdmmResult) with every tensor copied, a tensor that
    appears twice copied once."""
    copies: Dict[int, torch.Tensor] = {}

    def c(t):
        if not isinstance(t, torch.Tensor):
            return t
        if id(t) not in copies:
            copies[id(t)] = t.clone()
        return copies[id(t)]

    st = res.state
    return res._replace(S=c(res.S), Y=c(res.Y), state=st._replace(**{f: c(getattr(st, f)) for f in st._fields}))


def _capture(run: Callable, inputs: dict, options: dict) -> _Graph:
    """The graph of ``run`` on buffers of its own, captured on the device's
    capture stream into the memory pool of the device's graphs (a new pool
    for its first; a pool is shared through a graph that holds it, so it
    lives as long as one does).  The key's first call, eagerly, made the
    lazy initialisations a capture may not (the kernels' libraries, the
    tracked step's tables); the capture stream's first capture gives cuBLAS
    its workspace for that stream from the pool."""
    device = inputs["subY"].device
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    stream = _STREAMS[device]
    pool = next((g.graph.pool() for k, g in _GRAPHS.items() if g is not None and k[0] == device), None)
    static = {name: None if t is None else torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=device)
              for name, t in inputs.items()}  # filled before each replay
    before = kernels.launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool)
        try:
            out = run(**static, **options)
        finally:
            graph.capture_end()
    launches = {k: n - before[k] for k, n in kernels.launch_counts().items() if n != before[k]}
    kernels.add_launches({k: -n for k, n in launches.items()})  # recorded, not run
    solve.captures += 1
    return _Graph(graph, {n: t for n, t in static.items() if t is not None}, out, launches)


def solve(run: Callable, inputs: dict, options: dict):
    """``run(**inputs, **options)`` (the eager solve) for a call
    :func:`takes`, bit for bit: eagerly at the first call of its key,
    captured at the second, and from the graph of its key from the second
    on."""
    k = key(inputs, options)
    if k not in _GRAPHS:
        _GRAPHS[k] = None
        return run(**inputs, **options)
    entry = _GRAPHS[k]
    if entry is None:
        entry = _GRAPHS[k] = _capture(run, inputs, options)
    with span("replay"):
        for name, buf in entry.inputs.items():
            buf.copy_(inputs[name])
        entry.graph.replay()
        kernels.add_launches(entry.launches)
        solve.replays += 1
        return _copy(entry.result)


solve.captures = 0
solve.replays = 0
