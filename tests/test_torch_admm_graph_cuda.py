"""Card-only tests of the tracked solve replayed as a CUDA graph (``solvers/admm_graph.py``).

A graph replays on the card only, so these tests skip where no CUDA device
is present.  Each holds ``solvers.admm.proposed_admm``, which runs a key's
first call eagerly, captures the graph of that key at its second and
replays it from then on, against ``solvers.admm._proposed_admm``, the same code run
eagerly, bit for bit, at errorVSnrf's shapes (``plot_errorVSnrf.m:20-23``:
Mr ∈ {4, 8, 12, 16}, T = 5; N = 32 > M = 20, the tracked route) with the
chain's products in TF32 (``track_precision='tensorfloat32'``): in float32
these calls go to the fused kernel on the transpose
(``solvers/admm_transposed.py``), which the graph never sees.  This file
imports no JAX; on the GPU machine run it alone, without the JAX suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_admm_graph_cuda.py
"""
import pytest
import torch

from jstsp19_torch.core import prng, trace
from jstsp19_torch.core.config import use_full_fp32
from jstsp19_torch.harness import pipeline, runner
from jstsp19_torch.harness.pipeline import PointConfig
from jstsp19_torch.kernels import dictionary, softthresh
from jstsp19_torch.solvers import admm, admm_graph

pytestmark = pytest.mark.cuda

NV = 10.0 ** (-5 / 10)  # plot_errorVSnrf.m:23
MR = (4, 8, 12, 16)
SEED = 3_000_000_019


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph replays on the card only")
    use_full_fp32()
    monkeypatch.setattr(admm_graph, "_GRAPHS", {})
    return torch.device("cuda")


def _pc(mr):
    return PointConfig(Mr=mr, T=5, methods=("proposed", "proposed_angles"), svt_method="tracked",
                       track_precision="tensorfloat32")


def _problem(device, k, batch):
    """The arguments ``realization_errors`` passes ``proposed_admm`` at
    point k of the sweep (Mr cycling as the benchmark's cell runs it), and
    the angles variant's support rank."""
    pc = _pc(MR[k % len(MR)])
    gens = prng.realization_generators(SEED, k, device)
    draws = pipeline.point_draws(gens, pc, NV, batch)
    _, obs, A, B, tau_Y, tau_S, rho = pipeline._proposed_frontend(gens, pc, NV, batch, draws=draws)
    rank = admm.support_rank_from_order(pipeline._oracle_order(draws[0].Zbar), A.shape[-1] * B.shape[-2])
    args = (obs.Y, obs.Omega, A, B, pc.Imax, tau_Y, tau_S, rho)
    kw = dict(mode=pc.admm_mode, svt_method="tracked", track_rounds=pc.track_rounds,
              track_precision=pc.track_precision)
    return args, kw, rank.reshape(*rank.shape[:-1], A.shape[-1], B.shape[-2]), pc.Imax


def _equal(got, want):
    for name in ("S", "Y"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for name in want.state._fields:
        a, b = getattr(got.state, name), getattr(want.state, name)
        assert torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b, name


@pytest.mark.parametrize("batch", [256, 10_000])
@pytest.mark.parametrize("angles", [False, True], ids=["proposed", "proposed_angles"])
def test_a_tracked_solve_replays_its_eager_bits(cuda, batch, angles):
    """Four calls of one key (Mr 4, 8, 12, 16: the same solver shapes): the
    first eager, the second captured and replayed, the third and fourth
    replayed, each equal to the eager code on its own inputs, the replays'
    results still equal after the later replays; the kernels' launch counts
    rise by Imax a call whichever way it ran."""
    got, want = [], []
    captures, replays = admm_graph.solve.captures, admm_graph.solve.replays
    launches = dictionary.dict_correlation.launches, softthresh.fused_soft_threshold.launches
    for k in range(len(MR)):
        args, kw, rank, imax = _problem(cuda, k, batch)
        if angles:
            kw["support_rank"] = rank
        got.append(admm.proposed_admm(*args, **kw))
        want.append(admm._proposed_admm(*args, **kw))
    for g, w in zip(got, want):
        _equal(g, w)
    n = len(got)
    assert (admm_graph.solve.captures - captures, admm_graph.solve.replays - replays) == (1, n - 1)
    assert dictionary.dict_correlation.launches - launches[0] == 2 * n * imax
    assert softthresh.fused_soft_threshold.launches - launches[1] == 2 * n * imax


def test_tracked_points_capture_at_their_second_and_replay_from_it(cuda):
    """Three errorVSnrf points through ``run_point``: the point spans'
    counters show no graph at the first, the two methods' captures and
    replays at the second and their replays at the third, each replay inside
    its ``solve`` span; 2·Imax ``dict_correlation`` and ``soft_threshold``
    launches every point."""
    pc = _pc(8)
    with trace.recording() as spans:
        answers = [runner.run_point(pc, NV, 64, seed=SEED, sweep_index=k, device=cuda) for k in range(3)]
    points = [s for s in spans if s.name == "point"]
    assert [(p.attrs["captures"], p.attrs["replays"]) for p in points] == [(0, 0), (2, 2), (0, 2)]
    for p in points:
        assert p.attrs["launches"]["dict_correlation"] == p.attrs["launches"]["soft_threshold"] == 2 * pc.Imax
    solves = [s.id for s in spans if s.name == "solve" and s.point in (points[1].id, points[2].id)]
    assert len(solves) == 4
    assert sorted(s.parent for s in spans if s.name == "replay") == sorted(solves)
    again = runner.run_point(pc, NV, 64, seed=SEED, sweep_index=2, device=cuda)
    for name in answers[2]:
        assert (answers[2][name] == again[name]).all(), name
