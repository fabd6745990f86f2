"""Card-only tests of the tracked route's N > M solve as one fused-kernel
launch on the transpose (``solvers/admm_transposed.py``).

At errorVSnrf's shapes (``plot_errorVSnrf.m:20-23``: Mr ∈ {4, 8, 12, 16},
T = 5; N = 32 > M = 20) ``solvers.admm.proposed_admm`` answers a float32
tracked call with one ``fused_tracked_admm`` launch on the transposed
problem.  Each answer is held to the benchmark check's own limits
(``perfbench/limits``: ``s_rel_err`` ≤ 3e-3 per realization, NMSE gap ≤
1e-3) against ``solvers.admm._proposed_admm``, the tracked chain run
eagerly, and two calls are bit-equal.  This file imports no JAX; on the GPU
machine run it alone, without the JAX suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_admm_transposed_cuda.py
"""
import pytest
import torch

from jstsp19_torch import kernels
from jstsp19_torch.core import prng, trace
from jstsp19_torch.core.config import use_full_fp32
from jstsp19_torch.core.metrics import clamped_nmse
from jstsp19_torch.harness import pipeline, runner
from jstsp19_torch.harness.pipeline import PointConfig
from jstsp19_torch.solvers import admm, admm_graph, admm_transposed

pytestmark = pytest.mark.cuda

NV = 10.0 ** (-5 / 10)  # plot_errorVSnrf.m:23
SEED = 3_000_000_023
S_REL_ERR, NMSE_GAP = 3e-3, 1e-3  # perfbench/limits/nrf_tracked_b10000's limits


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernel runs on the card only")
    use_full_fp32()
    monkeypatch.setattr(admm_graph, "_GRAPHS", {})
    return torch.device("cuda")


def _pc(mr):
    return PointConfig(Mr=mr, T=5, methods=("proposed", "proposed_angles"), svt_method="tracked")


def _problem(device, mr, batch, angles):
    """The arguments ``realization_errors`` passes ``proposed_admm`` at an
    errorVSnrf point, and the true beamspace channel."""
    pc = _pc(mr)
    gens = prng.realization_generators(SEED, mr, device)
    draws = pipeline.point_draws(gens, pc, NV, batch)
    _, obs, A, B, tau_Y, tau_S, rho = pipeline._proposed_frontend(gens, pc, NV, batch, draws=draws)
    kw = dict(mode=pc.admm_mode, svt_method="tracked", track_rounds=pc.track_rounds,
              track_precision=pc.track_precision)
    if angles:
        rank = admm.support_rank_from_order(pipeline._oracle_order(draws[0].Zbar), A.shape[-1] * B.shape[-2])
        kw["support_rank"] = rank.reshape(batch, A.shape[-1], B.shape[-2])
    return (obs.Y, obs.Omega, A, B, pc.Imax, tau_Y, tau_S, rho), kw, draws[0].Zbar


@pytest.mark.parametrize("batch", [256, 10_000])
@pytest.mark.parametrize("angles", [False, True], ids=["proposed", "proposed_angles"])
def test_an_n_greater_than_m_tracked_solve_is_one_fused_launch_within_the_check_s_limits(cuda, batch, angles):
    args, kw, Zbar = _problem(cuda, 16, batch, angles)
    before, calls = kernels.launch_counts(), admm_transposed.solve.calls
    got = admm.proposed_admm(*args, **kw)
    again = admm.proposed_admm(*args, **kw)
    torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in kernels.launch_counts().items()}
    assert launched == {"fused_tracked_admm": 2, "dict_correlation": 0, "soft_threshold": 0, "fwht": 0}
    assert admm_transposed.solve.calls == calls + 2 and admm_graph._GRAPHS == {}
    assert torch.equal(got.S, again.S) and torch.equal(got.Y, again.Y)
    assert got.state is None and got.convergence is None
    want = admm._proposed_admm(*args, **kw)
    s_rel_err = (got.S - want.S).abs().amax(dim=(-2, -1)) / want.S.abs().amax(dim=(-2, -1))
    assert float(s_rel_err.max()) <= S_REL_ERR
    gap = (clamped_nmse(got.S, Zbar) - clamped_nmse(want.S, Zbar)).abs()
    assert float(gap.max()) <= NMSE_GAP


def test_a_tensorfloat32_call_keeps_the_chain(cuda):
    args, kw, _ = _problem(cuda, 8, 64, angles=False)
    before, calls = kernels.launch_counts(), admm_transposed.solve.calls
    admm.proposed_admm(*args, **{**kw, "track_precision": "tensorfloat32"})
    torch.cuda.synchronize()
    assert admm_transposed.solve.calls == calls
    assert kernels.launch_counts()["fused_tracked_admm"] == before["fused_tracked_admm"]
    assert kernels.launch_counts()["dict_correlation"] == before["dict_correlation"] + args[4]


def test_errorvsnrf_points_run_one_fused_launch_a_method(cuda):
    """Two errorVSnrf points through ``run_point``: each point span counts two
    transposed solves, two ``fused_tracked_admm`` launches, no per-op
    launch and no graph; each ``solve`` span holds the kernel wrapper's
    ``pack`` and ``launch``; a point run again gives the same answers."""
    pc = _pc(12)
    with trace.recording() as spans:
        answers = [runner.run_point(pc, NV, 64, seed=SEED, sweep_index=k, device=cuda) for k in range(2)]
    points = [s for s in spans if s.name == "point"]
    for p in points:
        assert p.attrs["transposed"] == 2 and (p.attrs["captures"], p.attrs["replays"]) == (0, 0)
        assert p.attrs["launches"]["fused_tracked_admm"] == 2
        assert p.attrs["launches"]["dict_correlation"] == p.attrs["launches"]["soft_threshold"] == 0
    solves = {s.id for s in spans if s.name == "solve"}
    assert len(solves) == 4
    for name in ("pack", "launch"):
        assert sorted(s.parent for s in spans if s.name == name) == sorted(solves)
    again = runner.run_point(pc, NV, 64, seed=SEED, sweep_index=1, device=cuda)
    for name in answers[1]:
        assert (answers[1][name] == again[name]).all(), name
