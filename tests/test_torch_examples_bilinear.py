"""The port's worked examples of the completion and factorization family
(``matrix_completion``, ``dictionary_learning``, ``rank_one_factorization``,
``self_calibration``, ``hyperspectral_unmixing``, ``applications``) against
the JAX scripts' printout (``results/torch_examples_jax.json``) on the
scripts' own draws, the solvers' initialization keys JAX's (the port's prng
patched), as in ``tests/test_torch_examples_cs.py``: deterministic given the
draws (rtol 1e-3, 0.05 dB, printed integers exact), plus half the last
printed digit.

| example | label | class | why |
|---|---|---|---|
| rank_one_factorization | SE corr(u), corr(v) | Monte Carlo, 4 × (0.056, 0.129) at 0 dB, (0.0081, 0.0048) at 5, (0.0033, 0.0012) at 10 | ``mc_prior_mse`` draws its 8192 samples with the port's generator; the standard errors are the spread over 16 seeds (the port on the CPU) |
| hyperspectral_unmixing | scene NMSE, spectral angles | 1.5 dB; abs 3° | the reference's own fault (ROADMAP Queue 3): on this scene HUTAMP's iterates pass more than 12 σ into the non-negative priors' tail, where JAX's float32 moments are roundoff (the port with JAX's formula there returns NaN); with its Mills-ratio series the port reads −21.09 dB against JAX's −20.40 (0.69 dB apart), angles 10.25, 12.71 and 16.08° against 10.32, 12.41 and 14.09 (at most 1.99° apart) |
| hyperspectral_unmixing | abundance minimum | abs 1e-4 | the same trajectory: JAX 4.03e-5, the port 6.5e-5 |
| applications | unmixing Z-NMSE | rtol 5e-2 | the same scene family: JAX 2.69e-3, the port 2.649e-3 (1.5% apart) |
"""
import importlib
import pathlib
import sys

import pytest
import torch

pytest.importorskip("jax")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import torch_examples_reference as ref  # noqa: E402

EXAMPLES = ("applications", "dictionary_learning", "hyperspectral_unmixing", "matrix_completion",
            "rank_one_factorization", "self_calibration")


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


def test_dictionary_learning_build_equals_the_scripts_arrays():
    """The numpy-drawn part of ``dictionary_learning`` equals the tool's copy
    (bit-equal to the script's solver inputs); its two solver keys are
    generators."""
    import numpy as np

    built = importlib.import_module("jstsp19_torch.examples.dictionary_learning").build(
        torch.device("cpu"), torch.Generator().manual_seed(0))
    want = ref.draws("dictionary_learning")
    assert set(built) == set(want) | {"key0", "key1"}
    for k, v in want.items():
        assert built[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(built[k].numpy(), v, err_msg=k)
