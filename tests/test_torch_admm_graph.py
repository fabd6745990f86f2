"""The tracked solve's CUDA-graph path (``solvers/admm_graph.py``), on the CPU.

The rule that sends a call to the graph sends every CPU call, and every
call with options a capture cannot hold, to the eager solve; the graph's key
tells apart every option and each input's shape, strides and dtype; a key's
first call runs eagerly while its second is the one that captures; a
replayed result is copied out of the graph's buffers whole.  The replay
itself runs on the card only: ``tests/test_torch_admm_graph_cuda.py``.
"""
import pytest
import torch

from jstsp19_torch import kernels
from jstsp19_torch.core import prng, trace
from jstsp19_torch.harness import pipeline, runner
from jstsp19_torch.harness.pipeline import PointConfig
from jstsp19_torch.ops import tracked
from jstsp19_torch.solvers import admm, admm_graph

# N = Mr_e = 8 > M = T·Nt = 6: the tracked route
TINY = dict(Nt=2, Nr=8, Mr_e=8, Mr=4, Gr=8, Gt=2, L=2, n_clusters=1, n_rays=2, T=3, Imax=6,
            methods=("proposed", "proposed_angles"), svt_method="tracked")
SEED = 2**31 + 23
OPTIONS = dict(Imax=6, mode="approximate", support_base=10, support_step=5, track_convergence=False,
               conv_norm="spectral", init_state=None, svt_method="tracked", track_rounds=1,
               track_precision="default", use_kernels=True)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny batches: one intra-op thread, so that the suite's parallel workers
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(k=0, batch=3, angles=False):
    """The tensors ``realization_errors`` hands ``proposed_admm`` at a tiny
    N > M point, under :data:`admm_graph.INPUTS`' names."""
    pc = PointConfig(**TINY)
    gens = prng.realization_generators(SEED, k, "cpu")
    draws = pipeline.point_draws(gens, pc, 0.3, batch)
    _, obs, A, B, tau_Y, tau_S, rho = pipeline._proposed_frontend(gens, pc, 0.3, batch, draws=draws)
    rank = None
    if angles:
        order = pipeline._oracle_order(draws[0].Zbar)
        rank = admm.support_rank_from_order(order, A.shape[-1] * B.shape[-2]).reshape(batch, A.shape[-1], -1)
    return dict(subY=obs.Y, Omega=obs.Omega, A=A, B=B, tau_Y=tau_Y, tau_S=tau_S, rho=rho, support_rank=rank)


def test_the_inputs_are_the_solve_arguments():
    assert set(admm_graph.INPUTS) == set(_inputs())


def test_the_tracked_options_may_be_captured():
    assert admm_graph.options_take(OPTIONS)


@pytest.mark.parametrize("option,value", [
    ("svt_method", "eigh"), ("svt_method", "jacobi"), ("mode", "exact"), ("track_convergence", True),
    ("init_state", "a state"), ("use_kernels", False)])
def test_options_a_capture_cannot_hold_run_eagerly(option, value):
    assert not admm_graph.options_take({**OPTIONS, option: value})


@pytest.mark.parametrize("angles", [False, True])
def test_cpu_calls_run_eagerly(angles):
    assert not admm_graph.takes(_inputs(angles=angles), OPTIONS)


@pytest.mark.parametrize("case", ["contiguous", "transposed", "a slice", "broadcast"])
def test_a_buffer_of_the_same_strides_holds_only_dense_inputs(case):
    x = torch.zeros(3, 8, 6)
    t = {"contiguous": x, "transposed": x.transpose(-1, -2), "a slice": x[:, :4],
         "broadcast": torch.zeros(8, 6).expand(3, 8, 6)}[case]
    assert admm_graph._dense(t) == (case in ("contiguous", "transposed"))


@pytest.mark.parametrize("option,value", [
    ("Imax", 7), ("support_base", 11), ("support_step", 4), ("track_rounds", 2), ("track_precision", "highest"),
    ("conv_norm", "fro")])
def test_the_graph_key_holds_every_option(option, value):
    inputs = _inputs()
    assert admm_graph.key(inputs, OPTIONS) != admm_graph.key(inputs, {**OPTIONS, option: value})


@pytest.mark.parametrize("change", ["batch", "strides", "dtype", "support_rank"])
def test_the_graph_key_holds_each_input_s_layout(change):
    inputs = _inputs()
    other = dict(inputs)
    if change == "batch":
        other = _inputs(batch=4)
    elif change == "strides":
        other["subY"] = inputs["subY"].contiguous() if not inputs["subY"].is_contiguous() \
            else inputs["subY"].transpose(-1, -2).contiguous().transpose(-1, -2)
    elif change == "dtype":
        other["rho"] = inputs["rho"].double()
    else:
        other["support_rank"] = _inputs(angles=True)["support_rank"]
    assert admm_graph.key(inputs, OPTIONS) != admm_graph.key(other, OPTIONS)


class _Captured(Exception):
    pass


@pytest.mark.parametrize("angles", [False, True])
def test_a_key_runs_eagerly_at_its_first_call_and_is_captured_at_its_second(monkeypatch, angles):
    """A key called once is never captured: :func:`admm_graph.solve` answers
    its first call from the eager solve and only marks the key; the second
    call captures (faked here: the CPU cannot)."""
    monkeypatch.setattr(admm_graph, "_GRAPHS", {})
    captured = []

    def capture(run, inputs, options):
        captured.append(admm_graph.key(inputs, options))
        raise _Captured

    monkeypatch.setattr(admm_graph, "_capture", capture)
    counts = admm_graph.solve.captures, admm_graph.solve.replays
    inputs = _inputs(angles=angles)
    got = admm_graph.solve(admm._proposed_admm, inputs, OPTIONS)
    want = admm._proposed_admm(**inputs, **OPTIONS)
    assert torch.equal(got.S, want.S) and torch.equal(got.Y, want.Y)
    admm_graph.solve(admm._proposed_admm, _inputs(batch=4, angles=angles), OPTIONS)  # another key's first
    assert captured == []
    assert set(admm_graph._GRAPHS) == {admm_graph.key(inputs, OPTIONS),
                                       admm_graph.key(_inputs(batch=4, angles=angles), OPTIONS)}
    assert all(v is None for v in admm_graph._GRAPHS.values())
    second = _inputs(k=1, angles=angles)
    with pytest.raises(_Captured):
        admm_graph.solve(admm._proposed_admm, second, OPTIONS)
    assert captured == [admm_graph.key(second, OPTIONS)] == [admm_graph.key(inputs, OPTIONS)]
    assert (admm_graph.solve.captures, admm_graph.solve.replays) == counts


def test_a_copied_result_shares_no_tensor_with_the_graph_s_and_keeps_its_aliases():
    res = admm._proposed_admm(**_inputs(), **OPTIONS)
    assert res.Y is res.state.Y and res.S is res.state.S
    out = admm_graph._copy(res)
    assert out.Y is out.state.Y and out.S is out.state.S
    assert out.state.it == res.state.it
    for name in res.state._fields:
        a, b = getattr(out.state, name), getattr(res.state, name)
        if isinstance(b, torch.Tensor):
            assert a is not b and a.data_ptr() != b.data_ptr() and torch.equal(a, b), name


@pytest.mark.parametrize("kernel", ["dict_correlation", "soft_threshold", "fused_tracked_admm", "fwht"])
def test_launch_counts_rise_and_fall_by_what_is_added(kernel):
    before = kernels.launch_counts()
    kernels.add_launches({kernel: 5})
    assert kernels.launch_counts() == {**before, kernel: before[kernel] + 5}
    kernels.add_launches({kernel: -5})
    assert kernels.launch_counts() == before


def test_the_tracked_step_s_tables_are_made_once_a_size_and_device():
    first = tracked._tables(6, torch.device("cpu"))
    tracked.make_tracked_svt(8, 6)
    tracked.make_tracked_svt(6, 8, device="cpu")
    assert all(a is b for a, b in zip(tracked._tables(6, torch.device("cpu")), first))


def test_cpu_tracked_points_neither_capture_nor_replay(monkeypatch):
    monkeypatch.setattr(admm_graph, "_GRAPHS", {})
    pc = PointConfig(**TINY)
    with trace.recording() as spans:
        for k in range(3):
            runner.run_point(pc, 0.3, 3, seed=SEED, sweep_index=k, device="cpu")
    assert admm_graph._GRAPHS == {}
    assert [(s.attrs["captures"], s.attrs["replays"]) for s in spans if s.name == "point"] == [(0, 0)] * 3
    assert not [s for s in spans if s.name == "replay"]
