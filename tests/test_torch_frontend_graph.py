"""The front end's CUDA-graph path (``harness/frontend_graph.py``), on the CPU.

The draws that the graph replays keep their bits: ``qam4_mod`` and
``complex_normal`` against the formulas they replaced, written out here.
The rule that sends a call to the graph sends every CPU call to the eager
front end, the graph's key tells apart every field of the point's
configuration, and a shape's first call runs eagerly while its second is
the one that captures.  The replay itself runs on the card only:
``tests/test_torch_frontend_graph_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from jstsp19_torch.core import prng
from jstsp19_torch.frontend import modulation
from jstsp19_torch.frontend.modulation import QAM4_ALPHABET, qam4_mod
from jstsp19_torch.harness import frontend_graph, pipeline
from jstsp19_torch.harness.pipeline import PointConfig
from jstsp19_torch.solvers.admm import admm_gram, admm_hyperparams, admm_rho

TINY = dict(Nt=2, Nr=8, Mr_e=8, Mr=4, Gr=8, Gt=2, L=2, n_clusters=1, n_rays=2, T=6, Imax=12)
SEED = 2**31 + 11


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny batches: one intra-op thread, so that the suite's parallel workers
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("shape", [(5,), (3, 4, 35)])
def test_qam4_mod_keeps_its_bits(shape):
    got = qam4_mod(_gen(7), shape)
    idx = torch.randint(0, 4, shape, generator=_gen(7))
    want = torch.from_numpy(QAM4_ALPHABET).to("cpu")[idx]
    assert got.dtype == want.dtype == torch.complex64
    assert torch.equal(got, want)


def test_the_qam4_alphabet_is_copied_to_a_device_once():
    first = modulation._alphabet(torch.device("cpu"))
    assert modulation._alphabet(torch.device("cpu")) is first
    assert torch.equal(first, torch.from_numpy(QAM4_ALPHABET))
    qam4_mod(_gen(1), (4,))[0] = 0  # a draw is a new tensor: the cached alphabet stays whole
    assert torch.equal(modulation._alphabet(torch.device("cpu")), torch.from_numpy(QAM4_ALPHABET))


VARS = {
    "default": None,
    "float": 0.5,
    "snr_15db": 10 ** (-15 / 10),
    "numpy_float64": np.float64(10 ** -1.5),
    "numpy_float32": np.float32(0.3),
    "int": 2,
    "tensor_scalar": torch.tensor(0.7),
    "tensor_float64": torch.tensor(0.7, dtype=torch.float64),
    "tensor_broadcast": torch.tensor([[0.25], [4.0], [1e-3]]),
}


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("name", list(VARS))
def test_complex_normal_keeps_its_bits(name, dtype):
    var = VARS[name]
    shape = (3, 5)
    kw = {} if var is None else dict(var=var)
    got = prng.complex_normal(_gen(3), shape, dtype=dtype, **kw)
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    x = torch.randn((2, *shape), generator=_gen(3), dtype=rdt)
    want = torch.complex(x[0], x[1]) * torch.sqrt(torch.as_tensor(1.0 if var is None else var, dtype=rdt) / 2)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["whole", "H_ext", "rows", "tensor_noise", "advanced"])
def test_cpu_generators_take_the_eager_path(case):
    gens = prng.realization_generators(SEED, 0, "cpu")
    noise_var, H_ext, rows = 0.5, None, None
    if case == "H_ext":
        H_ext = torch.zeros(4, 2, 8, 2, dtype=torch.complex64)
    elif case == "rows":
        rows = slice(0, 2)
    elif case == "tensor_noise":
        noise_var = torch.tensor(0.5)
    elif case == "advanced":
        torch.randn(3, generator=gens[prng.ROLE_NOISE])
    assert not frontend_graph.takes(gens, noise_var, H_ext, rows)


def test_missing_roles_take_the_eager_path():
    gens = prng.realization_generators(SEED, 0, "cpu")
    del gens[prng.ROLE_MASK]
    assert not frontend_graph.takes(gens, 0.5)


SHAPE_FIELDS = dict(Nt=3, Nr=16, Mr_e=16, Mr=2, Gr=16, Gt=3, L=3, n_clusters=2, n_rays=3, T=7,
                    beamformer="fft", channel_quirks=True)
OTHER_FIELDS = dict(Imax=50, num_nonzero=7, methods=("proposed",), svt_method="tracked", admm_mode="exact",
                    track_rounds=2, track_precision="highest", rho_scale=2.0, vamp_nit=3)


@pytest.mark.parametrize("field", list(SHAPE_FIELDS))
def test_the_graph_key_holds_each_field_that_sets_a_shape(field):
    pc = PointConfig(**TINY)
    assert frontend_graph.key(pc, 4, "cpu") != frontend_graph.key(
        dataclasses.replace(pc, **{field: SHAPE_FIELDS[field]}), 4, "cpu")


def test_the_graph_key_holds_the_batch_and_the_device():
    pc = PointConfig(**TINY)
    assert frontend_graph.key(pc, 4, "cpu") == frontend_graph.key(pc, 4, torch.device("cpu"))
    assert frontend_graph.key(pc, 4, "cpu") != frontend_graph.key(pc, 5, "cpu")
    assert frontend_graph.key(pc, 4, "cpu") != frontend_graph.key(pc, 4, "meta")


@pytest.mark.parametrize("field", list(OTHER_FIELDS))
def test_the_graph_key_holds_every_other_field_too(field):
    """The key is the whole configuration: a field added later cannot be
    left out of it and replay a stale graph."""
    pc = PointConfig(**TINY)
    assert frontend_graph.key(pc, 4, "cpu") == frontend_graph.key(PointConfig(**TINY), 4, "cpu")
    assert frontend_graph.key(pc, 4, "cpu") != frontend_graph.key(
        dataclasses.replace(pc, **{field: OTHER_FIELDS[field]}), 4, "cpu")


def test_admm_hyperparams_is_its_gram_then_its_rho():
    Y = prng.complex_normal(_gen(5), (3, 6, 9))
    Z = prng.complex_normal(_gen(6), (3, 8, 4))
    tau_Y, tau_S, G = admm_gram(Y, Z)
    want = admm_hyperparams(Y, Z)
    assert G.shape == (3, 6, 6)
    for got, w in zip((tau_Y, tau_S, admm_rho(G, tau_Y)), want):
        assert torch.equal(got, w)
    # a Gram smaller than top_k clamps it, as the recipe does
    assert torch.equal(admm_rho(G[..., :4, :4], tau_Y), torch.sqrt(
        torch.clamp(torch.linalg.eigvalsh(G[..., :4, :4])[..., 0], min=0.0) * tau_Y))


class _Captured(Exception):
    pass


def test_a_shape_runs_eagerly_at_its_first_call_and_is_captured_at_its_second(monkeypatch):
    """A shape called once is never captured: :func:`frontend_graph.problem`
    answers its first call from the eager front end and only marks the
    shape; the second call captures (faked here: the CPU cannot)."""
    monkeypatch.setattr(frontend_graph, "_GRAPHS", {})
    captured = []

    def capture(pc, batch, device):
        captured.append((pc, batch, device))
        raise _Captured

    monkeypatch.setattr(frontend_graph, "_capture", capture)
    counts = (frontend_graph.problem.captures, frontend_graph.problem.replays)
    pc = PointConfig(**TINY)
    gens = prng.realization_generators(SEED, 1, "cpu")
    got = frontend_graph.problem(gens, pc, 0.3, 4)
    eager_gens = prng.realization_generators(SEED, 1, "cpu")
    want = pipeline._problem(eager_gens, pc, 0.3, 4)
    assert set(got) == set(want) == {"subY", "Omega", "A", "B", "tau_Y", "tau_S", "G", "Zbar", "rank"}
    for name in want:
        assert torch.equal(got[name], want[name]), name
    for role in prng.ROLES:
        assert torch.equal(gens[role].get_state(), eager_gens[role].get_state())
    frontend_graph.problem(prng.realization_generators(SEED, 2, "cpu"), pc, 0.3, 5)  # another shape's first
    assert captured == []
    assert frontend_graph._GRAPHS == {frontend_graph.key(pc, 4, "cpu"): None, frontend_graph.key(pc, 5, "cpu"): None}
    with pytest.raises(_Captured):
        frontend_graph.problem(prng.realization_generators(SEED, 3, "cpu"), pc, 0.3, 4)
    assert captured == [(pc, 4, torch.device("cpu"))]
    assert (frontend_graph.problem.captures, frontend_graph.problem.replays) == counts


def test_cpu_points_neither_capture_nor_replay():
    before = (frontend_graph.problem.captures, frontend_graph.problem.replays)
    pc = PointConfig(**TINY, methods=("proposed", "proposed_angles"), svt_method="fused")
    pipeline.fused_point_errors(prng.realization_generators(SEED, 0, "cpu"), pc, 0.5, 4)
    assert (frontend_graph.problem.captures, frontend_graph.problem.replays) == before
