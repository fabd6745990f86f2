"""The port's worked examples of the GAMP, AMP and VAMP family
(``jstsp19_torch/examples/``) against the JAX scripts' printout
(``results/torch_examples_jax.json``, ``tools/torch_examples_reference.py``),
on the scripts' own draws: the tool's copies of the ``jax.random`` lines
through ``interop``, or for the numpy-drawn scripts the port's own
``build``, which must equal the script's arrays.

Each number is held to the one the script printed, plus half its last
printed digit, under its class (``held``): deterministic given the draws,
rtol 1e-3, 0.05 dB for a number printed in dB, printed integers exact.
Per example, where a class differs:

| example | label | class | why |
|---|---|---|---|
| basic_gamp | ‖GAMP − LMMSE‖/‖LMMSE‖, ‖GAMP − LS‖/‖LS‖ | abs 1e-5 | the distance of two float32 solutions of one problem is roundoff: JAX 3.19e-7 and 2.34e-6, the port 8.4e-7 and 2.0e-6 |
| state_evolution | the table's SE and empirical columns | 0.05 dB | printed in dB without the unit on the line (the SE on JAX's samples) |
| snipe | the SNIPE column | 0.05 dB | the same |
"""
import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import torch_examples_reference as ref  # noqa: E402

EXAMPLES = ("basic_gamp", "cs_mri", "em_learning", "gamp_options", "impulsive_noise", "s_amp", "snipe",
            "sparse_recovery", "state_evolution", "structured_sparsity")
NUMPY_DRAWN = [n for n in EXAMPLES if n in ref.NUMPY_DRAWN]


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


@pytest.mark.parametrize("name", NUMPY_DRAWN)
def test_numpy_build_equals_the_scripts_arrays(name):
    """The port draws a numpy script's problem with the script's calls: its
    ``build`` equals the tool's copy, which the tool found bit-equal to the
    arrays the script hands its solvers."""
    built = importlib.import_module(f"jstsp19_torch.examples.{name}").build(torch.device("cpu"))
    want = ref.draws(name)
    assert set(built) == set(want)
    for k, v in want.items():
        got = built[k].numpy()
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)
