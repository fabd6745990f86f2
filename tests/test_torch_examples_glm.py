"""The port's worked examples of the nonlinear-channel and classification
family (``nonlinear_channels``, ``probit_classification``,
``robust_classification``) against the JAX scripts' printout
(``results/torch_examples_jax.json``) on the scripts' own draws, as in
``tests/test_torch_examples_cs.py``: deterministic given the draws (rtol
1e-3, 0.05 dB, printed integers exact), plus half the last printed digit.

| example | label | class | why |
|---|---|---|---|
| probit_classification | empirical column | 0.05 dB | printed in dB without the unit on the line |
| probit_classification | SE column | Monte Carlo, 4 × 0.093 dB | the output average draws with the port's own generator (32768 samples); 0.093 dB is the spread of the final SE over 8 seeds of both samplers (the port on the CPU) |
"""
import importlib
import pathlib
import sys

import pytest
import torch

pytest.importorskip("jax")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import torch_examples_reference as ref  # noqa: E402

EXAMPLES = ("nonlinear_channels", "probit_classification", "robust_classification")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small problems: one intra-op thread each, so that the suite's parallel
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_matches_the_jax_script_on_its_draws(name, monkeypatch):
    assert ref.load()[name]["draws_bit_equal"]
    ref.patch_port_prng(monkeypatch)
    got = importlib.import_module(f"jstsp19_torch.examples.{name}").solve(ref.port_problem(name))
    assert ref.held(name, got) == []


def test_gamp_takes_a_wrapped_likelihoods_observation():
    """``gamp`` finds the batch in a wrapper's inner observation
    (``RobustProbitLikelihood.probit.y``), as JAX's does without one."""
    from jstsp19_torch.ops import MatrixOp
    from jstsp19_torch.solvers import AwgnPrior, ProbitLikelihood, RobustProbitLikelihood
    from jstsp19_torch.solvers.gamp import gamp

    g = torch.Generator().manual_seed(0)
    A = torch.randn(3, 20, 8, generator=g)
    y = (torch.randn(3, 20, generator=g) > 0).float()
    lik = RobustProbitLikelihood(ProbitLikelihood(y, torch.tensor(0.04)), torch.tensor(0.05))
    res = gamp(AwgnPrior(torch.tensor(0.0), torch.tensor(1.0)), lik, MatrixOp(A), nit=5)
    assert res.x.shape == (3, 8) and res.x.dtype == torch.float32 and torch.isfinite(res.x).all()


@pytest.mark.parametrize("remove_mean", (False, True))
def test_gamp_est_state_follows_a_float64_observation(remove_mean):
    """A float64 observation gives a float64 state, which the float64
    card-against-CPU comparison of ``nonlinear_channels`` needs; float32
    keeps JAX's float32 state, and the two runs agree to float32's
    roundoff."""
    from jstsp19_torch.ops import MatrixOp
    from jstsp19_torch.solvers import GampOptions, NNGMPrior, PoissonLikelihood, gamp_est

    g = torch.Generator().manual_seed(1)
    A = torch.rand(2, 60, 30, generator=g) * (torch.rand(2, 60, 30, generator=g) < 0.3)
    x = torch.rand(2, 30, generator=g) * (torch.rand(2, 30, generator=g) < 0.2)
    y = torch.poisson(8.0 * (A @ x[..., None])[..., 0], generator=g)
    opts = GampOptions(nit=10, adapt_step=False, step=0.5, tol=-1.0, remove_mean=remove_mean)
    out = {}
    for dt in (torch.float32, torch.float64):
        t = lambda v: torch.tensor(v, dtype=dt)  # noqa: E731
        fin, state, _ = gamp_est(NNGMPrior(t([1.0]), t([1.0]), t([1.0]), p1=t(0.2)),
                                 PoissonLikelihood(y=y.to(dt), scale=8.0), MatrixOp(A.to(dt)), opts)
        assert fin.xhat.dtype == state.xhat.dtype == state.xvar.dtype == state.val.dtype == dt
        out[dt] = fin.xhat
    assert torch.isfinite(out[torch.float64]).all()
    torch.testing.assert_close(out[torch.float32].double(), out[torch.float64], rtol=1e-3, atol=1e-4)
