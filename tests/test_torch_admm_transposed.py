"""The tracked route's N > M solve as one fused-kernel launch on the transpose
(``solvers/admm_transposed.py``), on the CPU.

The identity the path rests on: at errorVSnrf's shapes (N = Mr_e = 32 > M =
T·Nt = 20, Gr = 32, K = 16), with and without the support rank, the tracked
ADMM is the transpose of the fused kernel's plain version on the transposed
operands, and both are near JAX's tracked ``proposed_admm`` on the same
inputs; :func:`admm_transposed.solve` answers so (on the CPU the kernel's
wrapper takes its plain version).  The rule that sends a call there takes
the benchmark cell's call and declines every other.  The launch itself runs
on the card only: ``tests/test_torch_admm_transposed_cuda.py``.
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

from jstsp19_torch.core import prng, trace
from jstsp19_torch.harness import pipeline, runner
from jstsp19_torch.harness.pipeline import PointConfig
from jstsp19_torch.kernels import admm_fused
from jstsp19_torch.solvers import admm, admm_transposed

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import torch_precision_shapes  # noqa: E402

NV = 10.0 ** (-5 / 10)  # plot_errorVSnrf.m:23
SEED = 2**31 + 29
BATCH = 3
OPTIONS = dict(Imax=100, mode="approximate", support_base=10, support_step=5, track_convergence=False,
               conv_norm="spectral", init_state=None, svt_method="tracked", track_rounds=1,
               track_precision="default", use_kernels=True)
RTOL = 2e-4  # max|ΔS| over max|S| per realization: float32 sums in other orders (A·S·B associated otherwise)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny batches: one intra-op thread, so that the suite's parallel workers
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(mr=16, angles=False, batch=BATCH):
    """What ``realization_errors`` hands ``proposed_admm`` at an errorVSnrf
    point (``plot_errorVSnrf.m:20-23``: Mr of Mr_e = 32, T = 5)."""
    pc = PointConfig(Mr=mr, T=5, methods=("proposed", "proposed_angles"), svt_method="tracked")
    gens = prng.realization_generators(SEED, mr, "cpu")
    draws = pipeline.point_draws(gens, pc, NV, batch)
    _, obs, A, B, tau_Y, tau_S, rho = pipeline._proposed_frontend(gens, pc, NV, batch, draws=draws)
    rank = None
    if angles:
        order = pipeline._oracle_order(draws[0].Zbar)
        rank = admm.support_rank_from_order(order, A.shape[-1] * B.shape[-2]).reshape(batch, A.shape[-1], -1)
    return dict(subY=obs.Y, Omega=obs.Omega, A=A, B=B, tau_Y=tau_Y, tau_S=tau_S, rho=rho, support_rank=rank)


def _close(got, want):
    """max|got − want| ≤ RTOL·max|want|, realization by realization."""
    err = (got - want).abs().amax(dim=(-2, -1))
    return bool((err <= RTOL * want.abs().amax(dim=(-2, -1))).all())


def test_errorvsnrf_is_an_n_greater_than_m_problem_the_kernel_holds_on_the_transpose():
    inputs = _inputs()
    assert tuple(inputs["subY"].shape[-2:]) == (32, 20) and inputs["A"].shape[-1] == 32 and inputs["B"].shape[-2] == 16
    ops = admm_transposed.operands(inputs)
    assert tuple(ops["subY"].shape[-2:]) == (20, 32) and tuple(ops["A"].shape[-2:]) == (20, 16)
    assert tuple(ops["B"].shape[-2:]) == (32, 32)
    assert admm_fused.plan(20, 32, 16, 32).smem_bytes == 61_168


@pytest.mark.parametrize("angles", [False, True], ids=["proposed", "proposed_angles"])
@pytest.mark.parametrize("mr", [4, 16])
def test_the_tracked_solve_is_the_transpose_of_the_fused_kernel_s_plain_version(mr, angles):
    """The chain (N > M on the transpose of each W) against the kernel's
    plain version on the transposed operands, transposed back; and
    :func:`admm_transposed.solve` is exactly the latter, with no state."""
    inputs = _inputs(mr, angles)
    want = admm._proposed_admm(**inputs, **OPTIONS)
    ops = admm_transposed.operands(inputs)
    S_t, Y_t = admm_fused.fused_tracked_admm_plain(
        ops["subY"], ops["Omega"], ops["A"], ops["B"], ops["tau_Y"], ops["tau_S"], ops["rho"], OPTIONS["Imax"],
        ops["support_rank"])
    assert _close(S_t.mT, want.S) and _close(Y_t.mT, want.Y)
    got = admm_transposed.solve(inputs, OPTIONS)
    assert torch.equal(got.S, S_t.mT) and torch.equal(got.Y, Y_t.mT)
    assert got.S.is_contiguous() and got.Y.is_contiguous()
    assert got.convergence is None and got.state is None


@pytest.mark.parametrize("angles", [False, True], ids=["proposed", "proposed_angles"])
def test_the_transposed_solve_is_near_jax_s_tracked_admm(angles):
    """JAX's tracked ``proposed_admm`` (``jstsp19_tpu/solvers/admm.py``) on
    the same numpy inputs, Mr 4 and 16, within the same float32 tolerance."""
    jax = pytest.importorskip("jax")
    from jstsp19_tpu.solvers import admm as jadmm

    for mr in (4, 16):
        inputs = _inputs(mr, angles)
        got = admm_transposed.solve(inputs, OPTIONS).S
        args = [inputs[k].numpy() for k in ("subY", "Omega", "A", "B", "tau_Y", "tau_S", "rho")]
        kw = dict(svt_method="tracked", track_rounds=1, track_precision="highest")
        if angles:
            f = lambda sy, om, a, b, ty, ts, rh, rk: jadmm.proposed_admm(  # noqa: E731
                sy, om, a, b, OPTIONS["Imax"], ty, ts, rh, support_rank=rk, **kw).S
            args.append(inputs["support_rank"].numpy())
        else:
            f = lambda sy, om, a, b, ty, ts, rh: jadmm.proposed_admm(  # noqa: E731
                sy, om, a, b, OPTIONS["Imax"], ty, ts, rh, **kw).S
        ref = torch.from_numpy(np.array(jax.vmap(f)(*args)))
        assert _close(got, ref), mr


def test_shared_dictionaries_and_one_hyperparameter_value_are_expanded():
    """A dictionary shared by the batch and a τ or ρ given once answer as the
    same values given per realization."""
    inputs = _inputs(angles=True)
    shared = dict(inputs, A=inputs["A"][0], B=inputs["B"][0], rho=float(inputs["rho"][0]))
    per = dict(inputs, A=inputs["A"][:1].expand(BATCH, -1, -1), B=inputs["B"][:1].expand(BATCH, -1, -1),
               rho=inputs["rho"][:1].expand(BATCH))
    assert admm_transposed.call_takes(shared, OPTIONS) and admm_transposed.call_takes(per, OPTIONS)
    a, b = admm_transposed.solve(shared, OPTIONS), admm_transposed.solve(per, OPTIONS)
    assert torch.equal(a.S, b.S) and torch.equal(a.Y, b.Y)


@pytest.mark.parametrize("angles", [False, True], ids=["proposed", "proposed_angles"])
def test_the_rule_takes_the_cell_s_call_but_not_on_the_cpu(angles):
    inputs = _inputs(angles=angles)
    assert admm_transposed.call_takes(inputs, OPTIONS)
    assert not admm_transposed.takes(inputs, OPTIONS)


@pytest.mark.parametrize("option,value", [
    ("use_kernels", False), ("track_precision", "tensorfloat32"), ("init_state", "a state"),
    ("track_convergence", True), ("svt_method", "eigh"), ("svt_method", "jacobi"), ("mode", "exact")])
def test_the_rule_declines_options_the_kernel_does_not_run(option, value):
    assert not admm_transposed.call_takes(_inputs(), {**OPTIONS, option: value})


def _declined(case, inputs):
    """The cell's inputs changed as ``case`` says."""
    y, om, A, B = inputs["subY"], inputs["Omega"], inputs["A"], inputs["B"]
    if case == "N <= M":
        return dict(admm_transposed.operands(inputs))
    if case == "odd M":
        return dict(inputs, subY=y[..., :19], Omega=om[..., :19], B=B[..., :19])
    if case == "shapes the kernel cannot hold":  # K = 160: Gr' × Gr' planes past a block's shared memory
        return dict(inputs, B=torch.cat([B] * 10, dim=-2))
    if case == "complex128":
        return dict(inputs, subY=y.to(torch.complex128))
    if case == "Omega float64":
        return dict(inputs, Omega=om.double())
    if case == "two batch dimensions":
        return {k: v[None] if isinstance(v, torch.Tensor) and v.dim() > 0 else v for k, v in inputs.items()}
    if case == "a dictionary of another batch":
        return dict(inputs, A=A[:2])
    if case == "rho of another batch":
        return dict(inputs, rho=inputs["rho"][:2])
    if case == "complex rho":
        return dict(inputs, rho=inputs["rho"].to(torch.complex64))
    assert case == "a real support rank"
    return dict(inputs, support_rank=_inputs(angles=True)["support_rank"].float())


@pytest.mark.parametrize("case", [
    "N <= M", "odd M", "shapes the kernel cannot hold", "complex128", "Omega float64", "two batch dimensions",
    "a dictionary of another batch", "rho of another batch", "complex rho", "a real support rank"])
def test_the_rule_declines_inputs_the_kernel_does_not_take(case):
    inputs = _inputs()
    assert admm_transposed.call_takes(inputs, OPTIONS)
    assert not admm_transposed.call_takes(_declined(case, inputs), OPTIONS)


def test_the_kernel_cannot_hold_the_widened_shapes():
    """The case above that :func:`admm_fused.fits` refuses is refused for its
    shapes alone."""
    assert admm_fused.fits(20, 32, 16, 32) and not admm_fused.fits(20, 32, 160, 32)


@pytest.mark.parametrize("angles", [False, True], ids=["proposed", "proposed_angles"])
def test_proposed_admm_answers_a_taken_call_from_the_transposed_solve(monkeypatch, angles):
    """With the rule's device check lifted (the CPU cannot launch),
    ``proposed_admm`` answers the cell's call from :func:`admm_transposed.solve`
    once, state and all; the kernel's plain version inside it calls
    ``proposed_admm`` with the kernels off, which the rule declines."""
    monkeypatch.setattr(admm_transposed, "takes", admm_transposed.call_takes)
    inputs = _inputs(angles=angles)
    calls = admm_transposed.solve.calls
    got = admm.proposed_admm(**inputs, **OPTIONS)
    assert admm_transposed.solve.calls == calls + 1
    want = admm_transposed.solve(inputs, OPTIONS)
    assert torch.equal(got.S, want.S) and torch.equal(got.Y, want.Y) and got.state is None


def test_cpu_tracked_points_keep_the_chain():
    """On the CPU an errorVSnrf point runs the chain: its point span counts
    no transposed solve and no fused launch."""
    calls = admm_transposed.solve.calls
    pc = PointConfig(Mr=4, T=5, Imax=4, methods=("proposed", "proposed_angles"), svt_method="fused")
    assert runner.svt_route(pc) == "tracked"
    with trace.recording() as spans:
        runner.run_point(pc, NV, 2, seed=SEED, device="cpu")
    point = next(s for s in spans if s.name == "point")
    assert point.attrs["transposed"] == 0 and point.attrs["launches"]["fused_tracked_admm"] == 0
    assert admm_transposed.solve.calls == calls


def test_the_precision_protocol_compares_the_chain_where_the_card_would_take_the_kernel(monkeypatch):
    """``tools/torch_precision_shapes.py`` compares the tracked chain's
    precisions: inside its ``chain_only`` a call that the rule takes on the
    card (the device check lifted, as above) runs the chain, bit for bit,
    and outside it the transposed solve answers again."""
    monkeypatch.setattr(admm_transposed, "takes", admm_transposed.call_takes)
    inputs = _inputs(mr=4, angles=True)
    calls = admm_transposed.solve.calls
    with torch_precision_shapes.chain_only():
        got = admm.proposed_admm(**inputs, **OPTIONS)
    assert admm_transposed.solve.calls == calls
    want = admm._proposed_admm(**inputs, **OPTIONS)
    assert torch.equal(got.S, want.S) and torch.equal(got.Y, want.Y)
    assert admm_transposed.takes is admm_transposed.call_takes
    admm.proposed_admm(**inputs, **OPTIONS)
    assert admm_transposed.solve.calls == calls + 1
