"""Card-only tests of the front end replayed as a CUDA graph (``harness/frontend_graph.py``).

A graph replays on the card only, so these tests skip where no CUDA device
is present.  Each holds ``pipeline.proposed_problem``, which runs a shape's
first call eagerly, captures the graph of that shape at its second and
replays it from then on, against ``pipeline._problem``, the same code run
eagerly, and ρ after it, bit for bit, at the shapes of the benchmark's cells
(``perfbench/configs/``).  This file imports no JAX; on the GPU machine run
it alone, without the JAX suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_frontend_graph_cuda.py
"""
import pytest
import torch

from jstsp19_torch.core import prng, trace
from jstsp19_torch.core.config import use_full_fp32
from jstsp19_torch.core.metrics import clamped_nmse
from jstsp19_torch.harness import frontend_graph, pipeline, runner
from jstsp19_torch.harness.pipeline import PointConfig
from jstsp19_torch.kernels.admm_fused import fused_tracked_admm
from jstsp19_torch.solvers.admm import admm_rho

pytestmark = pytest.mark.cuda

N_MC = 256
SEEDS = (2**31 + 5, 3_000_000_017)
KEYS = {"subY", "Omega", "A", "B", "tau_Y", "tau_S", "rho", "Zbar", "rank"}
SNR = PointConfig()  # plot_errorVSsnr.m:8-25
POINTS = {f"snr_{db}db": (SNR, 10.0 ** (-db / 10.0)) for db in (-15, 0, 15)}
POINTS.update({  # plot_errorVSnt.m:7-23: Nt = Gt, the FFT combiner, 15 dB
    f"nt_{nt}": (PointConfig(Nt=nt, Gt=nt, T=t, beamformer="fft", num_nonzero=50), 10.0 ** -1.5)
    for nt, t in ((4, 35), (6, 35), (8, 35), (12, 35), (16, 25))})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph replays on the card only")
    use_full_fp32()
    return torch.device("cuda")


def _gens(seed, k, device):
    return prng.realization_generators(seed, k, device)


def _replays():
    return frontend_graph.problem.captures, frontend_graph.problem.replays


def _eager(gens, pc, noise_var, batch, **kw):
    prob = pipeline._problem(gens, pc, noise_var, batch, **kw)
    prob["rho"] = admm_rho(prob.pop("G"), prob["tau_Y"]) * pc.rho_scale
    return prob


def _warm(pc, batch, device):
    """Call the shape twice, so that it is captured whatever ran before."""
    for k in (1 << 40, (1 << 40) + 1):
        pipeline.proposed_problem(_gens(SEEDS[0], k, device), pc, 1.0, batch)


def _assert_same(got, want):
    assert set(got) == set(want) == KEYS
    for name in KEYS:
        assert got[name].dtype == want[name].dtype and got[name].shape == want[name].shape, name
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("point", list(POINTS))
def test_the_graph_front_end_is_bit_equal_to_the_eager_one(cuda, point, seed):
    pc, noise_var = POINTS[point]
    _, replays = _replays()
    for k in (0, 1, 2):  # a new shape runs eagerly, then captures, then replays what was captured
        gens = _gens(seed, k, cuda)
        got = pipeline.proposed_problem(gens, pc, noise_var, N_MC)
        eager_gens = _gens(seed, k, cuda)
        _assert_same(got, _eager(eager_gens, pc, noise_var, N_MC))
        for role in prng.ROLES:  # the caller's generators end where the eager draws leave them
            assert gens[role].get_offset() == eager_gens[role].get_offset()
        assert gens[prng.ROLE_CHANNEL].get_offset() > 0
    assert _replays()[1] >= replays + 2


def test_a_replay_draws_its_own_point_not_the_captured_one(cuda):
    pc = SNR
    _warm(pc, N_MC, cuda)
    first = pipeline.proposed_problem(_gens(SEEDS[0], 0, cuda), pc, 1.0, N_MC)
    other_seed = pipeline.proposed_problem(_gens(SEEDS[1], 7, cuda), pc, 10.0 ** -1.5, N_MC)
    _assert_same(other_seed, _eager(_gens(SEEDS[1], 7, cuda), pc, 10.0 ** -1.5, N_MC))
    assert not torch.equal(other_seed["Zbar"], first["Zbar"])
    other_noise = pipeline.proposed_problem(_gens(SEEDS[0], 0, cuda), pc, 10.0 ** 1.5, N_MC)
    _assert_same(other_noise, _eager(_gens(SEEDS[0], 0, cuda), pc, 10.0 ** 1.5, N_MC))
    assert torch.equal(other_noise["Zbar"], first["Zbar"]) and torch.equal(other_noise["Omega"], first["Omega"])
    assert not torch.equal(other_noise["subY"], first["subY"])


def test_a_result_outlives_the_next_replay_of_its_shape(cuda):
    pc = SNR
    _warm(pc, N_MC, cuda)
    first = pipeline.proposed_problem(_gens(SEEDS[0], 3, cuda), pc, 1.0, N_MC)
    kept = {name: t.clone() for name, t in first.items()}
    pipeline.proposed_problem(_gens(SEEDS[1], 4, cuda), pc, 10.0, N_MC)
    torch.cuda.synchronize()
    _assert_same(first, kept)


@pytest.mark.parametrize("case", ["advanced", "rows", "H_ext", "tensor_noise"])
def test_other_calls_run_the_front_end_eagerly(cuda, case):
    pc = SNR
    noise_var, kw = 0.5, {}
    gens, eager_gens = _gens(SEEDS[0], 1, cuda), _gens(SEEDS[0], 1, cuda)
    if case == "advanced":
        for g in (gens, eager_gens):
            torch.randn(3, generator=g[prng.ROLE_NOISE], device=cuda)
    elif case == "rows":
        kw = dict(rows=slice(16, 80))
    elif case == "H_ext":
        kw = dict(H_ext=prng.complex_normal(torch.Generator(cuda).manual_seed(9), (N_MC, pc.L, pc.Nr, pc.Nt)))
    else:
        noise_var = torch.tensor(0.5, device=cuda)
    before = _replays()
    got = pipeline.proposed_problem(gens, pc, noise_var, N_MC, **kw)
    assert _replays() == before
    _assert_same(got, _eager(eager_gens, pc, noise_var, N_MC, **kw))


def test_a_shape_runs_eagerly_once_then_is_captured_once_and_replayed(cuda):
    pc = PointConfig(Nt=6, Gt=6)
    batch = 24  # a shape no other test uses
    captures, replays = _replays()
    pipeline.proposed_problem(_gens(SEEDS[0], 0, cuda), pc, 1.0, batch)
    assert _replays() == (captures, replays)  # a shape called once holds no graph
    for k in range(1, 4):
        pipeline.proposed_problem(_gens(SEEDS[0], k, cuda), pc, 1.0, batch)
        assert _replays() == (captures + 1, replays + k)


def test_a_fused_point_replays_once_and_answers_as_the_eager_front_end(cuda):
    pc = PointConfig(methods=("proposed", "proposed_angles"), svt_method="fused", Imax=30)
    for k in (0, 1):  # its shape captured, if not yet
        runner.run_point(pc, 1.0, N_MC, seed=SEEDS[0], sweep_index=k, device=cuda)
    with trace.recording() as spans:
        got = runner.run_point(pc, 1.0, N_MC, seed=SEEDS[1], sweep_index=2, device=cuda)
    (point,) = [s for s in spans if s.name == "point"]
    assert (point.attrs["captures"], point.attrs["replays"]) == (0, 1)
    frontend = [s.name for s in spans if s.name in ("replay", "draws", "hyperparams")]
    assert sorted(frontend) == ["hyperparams", "replay"]
    prob = _eager(_gens(SEEDS[1], 2, cuda), pc, 1.0, N_MC)
    args = [prob[k] for k in ("subY", "Omega", "A", "B", "tau_Y", "tau_S", "rho")]
    for method, rank in (("proposed", None), ("proposed_angles", prob["rank"])):
        S, _ = fused_tracked_admm(*args, Imax=pc.Imax, support_rank=rank)
        assert torch.equal(torch.as_tensor(got[method]), clamped_nmse(S, prob["Zbar"]).cpu()), method
