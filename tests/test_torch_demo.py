"""``python -m jstsp19_torch demo``, the two examples that need no solver
slice (``channel_estimation``, the errorVSsnr pipeline, and
``large_array_sharded``, the realizations shared over ranks), and
``KronDictOp.rmv``'s route: the dictionary-correlation kernel for complex64
operands whose A its shared memory holds, ``torch.matmul`` for any other,
decided from dtypes and shapes before any launch.

``channel_estimation`` is held to the JAX script's printout
(``results/torch_examples_jax.json``) on the script's draws as in
``tests/test_torch_examples_cs.py``, but for one label:

| example | label | class | why |
|---|---|---|---|
| channel_estimation | vamp NMSE | rtol 5e-2 | VAMP's 100 damped float32 iterations: JAX's own jitted and eager runs of the same realization give 0.17300 and 0.16602 (4.0%); the port 0.17506 |
"""
import importlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import torch_examples_reference as ref  # noqa: E402

from jstsp19_torch.__main__ import main  # noqa: E402
from jstsp19_torch.examples import NAMES, _common  # noqa: E402
from jstsp19_torch.kernels import dictionary  # noqa: E402
from jstsp19_torch.ops import KronDictOp  # noqa: E402
from jstsp19_tpu.ops.kron import KronDictOp as JKronDictOp  # noqa: E402

SCRIPTS = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small problems: one intra-op thread each, so that the suite's parallel
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_demo_lists_exactly_the_jax_scripts(capsys):
    assert main(["demo"]) == 0
    out = capsys.readouterr().out.splitlines()
    listed = [line.split()[0] for line in out[1:]]
    assert listed == SCRIPTS == list(NAMES)
    for line, name in zip(out[1:], listed):  # the JAX launcher's first docstring line
        first = (ROOT / "examples" / f"{name}.py").read_text().splitlines()[0].strip().strip('"').rstrip(".")
        assert line.split(None, 1)[1] == first


def test_demo_runs_one_example_on_the_cpu_with_the_scripts_labels(capsys):
    assert main(["demo", "cs_mri", "--cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert set(_common.parse(lines)) == set(ref.load()["cs_mri"]["numbers"])
    assert len(lines) == len(ref.load()["cs_mri"]["lines"])


def test_demo_errors_name_what_to_do(capsys):
    assert main(["demo", "nope"]) == 1
    assert "run `demo` to list" in capsys.readouterr().err
    assert main(["demo", "cs_mri", "--ranks", "2", "--cpu"]) == 1


def test_examples_need_cuda_without_cpu_flag(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["demo", "cs_mri"]) == 1
    assert "CUDA" in capsys.readouterr().err
    for name in ("s_amp", "large_array_sharded"):
        assert importlib.import_module(f"jstsp19_torch.examples.{name}").main([]) == 1
        assert "CUDA" in capsys.readouterr().err


def test_channel_estimation_matches_the_jax_script_on_its_draws():
    assert ref.load()["channel_estimation"]["draws_bit_equal"]
    got = importlib.import_module("jstsp19_torch.examples.channel_estimation").solve(
        ref.port_problem("channel_estimation"))
    assert ref.held("channel_estimation", got) == []


def test_large_array_sharded_matches_the_jax_script_on_its_draws():
    """Every line but the header (JAX names its mesh, the port its ranks)."""
    mod = importlib.import_module("jstsp19_torch.examples.large_array_sharded")
    p = ref.port_problem("large_array_sharded")
    assert ref.load()["large_array_sharded"]["draws_bit_equal"]
    assert ref.held("large_array_sharded", mod.solve(p), skip_lines=(0,)) == []
    header = _common.printed(mod.lines(p))[0]
    assert header.startswith("ranks 1, ") and header.split(", ", 1)[1] == \
        ref.load()["large_array_sharded"]["lines"][0].split("}, ", 1)[1]


def test_large_array_sharded_over_two_cpu_ranks_prints_what_one_process_prints():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"

    def run(*extra):
        proc = subprocess.run([sys.executable, "-m", "jstsp19_torch", "demo", "large_array_sharded", "--cpu", *extra],
                              cwd=ROOT, capture_output=True, text=True, timeout=60, env=env)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout.splitlines()

    one, two = run(), run("--ranks", "2")
    assert one[0].startswith("ranks 1, ") and two[0].startswith("ranks 2, ")
    assert one[1:] == two[1:] and len(one) == 5


# -- KronDictOp.rmv's route -------------------------------------------------------------------------


def test_fits_reads_the_kernels_layout():
    """``fits`` is false where ``plan`` raises: sparse_recovery's A (128×256,
    313536 B of shared memory); true at every shape the port launches, among
    them VAMP's adjoint at [19c] (K (·, Mr, 16), A (·, Mr, 32), B (·, 16, 16))
    and the ADMM's (32×20, 32×80, 32×140 with Gr 32, Kd 16)."""
    assert not dictionary.fits(128, 1, 256, 1)
    with pytest.raises(ValueError, match="shared memory"):
        dictionary.plan(128, 1, 256, 1)
    for N, M, Gr, Kd in [(mr, 16, 32, 16) for mr in (4, 8, 12, 16)] + [(32, m, 32, 16) for m in (20, 80, 140)]:
        assert dictionary.fits(N, M, Gr, Kd)
        dictionary.plan(N, M, Gr, Kd)


@pytest.mark.parametrize("dtype", ["float32", "complex64"])
def test_kron_rmv_takes_matmul_where_the_kernel_cannot_and_equals_jax(dtype):
    """s_amp's real 128×256 operator and sparse_recovery's complex one (with
    a 1×1 B): the port's ``rmv`` on a batch equals JAX's on each element, by
    the matmul route."""
    rng = np.random.default_rng(3)
    cplx = dtype == "complex64"
    A = rng.standard_normal((128, 256)) + (1j * rng.standard_normal((128, 256)) if cplx else 0)
    Y = rng.standard_normal((3, 128, 1)) + (1j * rng.standard_normal((3, 128, 1)) if cplx else 0)
    A, Y, B = A.astype(dtype), Y.astype(dtype), np.eye(1, dtype=dtype)
    before = (KronDictOp.kernel_rmvs, KronDictOp.matmul_rmvs)
    got = KronDictOp(torch.from_numpy(A), torch.from_numpy(B)).rmv(torch.from_numpy(Y)).numpy()
    assert (KronDictOp.kernel_rmvs, KronDictOp.matmul_rmvs) == (before[0], before[1] + 1)
    jop = JKronDictOp(jnp.asarray(A), jnp.asarray(B))
    for b in range(3):
        want = np.asarray(jop.rmv(jnp.asarray(Y[b])))
        assert got[b].dtype == want.dtype
        np.testing.assert_allclose(got[b], want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_kron_rmv_keeps_the_kernel_route_at_vamps_shapes():
    rng = np.random.default_rng(4)

    def c(*shape):
        return torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64))

    op = KronDictOp(c(2, 8, 32), c(2, 16, 16))
    before = (KronDictOp.kernel_rmvs, KronDictOp.matmul_rmvs)
    got = op.rmv(c(2, 8, 16))
    assert (KronDictOp.kernel_rmvs, KronDictOp.matmul_rmvs) == (before[0] + 1, before[1])
    assert got.shape == (2, 32, 16)
