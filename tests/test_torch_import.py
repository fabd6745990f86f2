"""The port stands alone: importing it (and chip_smoke) loads neither JAX
nor the JAX package, and chip_smoke refuses to run without a CUDA device."""
import os
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(code: str, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True, timeout=120, env=env)


def test_import_leaves_jax_out():
    code = (
        "import sys, importlib, pkgutil, jstsp19_torch\n"
        "for m in pkgutil.walk_packages(jstsp19_torch.__path__, 'jstsp19_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jstsp19_tpu'))]\n"
        "print('BAD', bad)\n"
        "print('LOADED', sorted(m for m in sys.modules if m.startswith('jstsp19_torch')))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout
    # the GAMP slice's modules are among those imported
    for mod in ("ops.masked", "ops.structured", "ops.fourier", "kernels.wht", "solvers.gamp",
                "solvers.gamp_full", "harness.hadamard_cs", "interop"):
        assert f"'jstsp19_torch.{mod}'" in proc.stdout, mod


def test_sources_import_neither_jax_nor_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jstsp19_tpu)\b", re.M)
    files = list((ROOT / "jstsp19_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        assert not pat.search(f.read_text()), f


def test_bench_refuses_to_measure_without_cuda():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "jstsp19_torch.bench", "4"], cwd=ROOT, capture_output=True,
        text=True, timeout=120, env=env)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a card it exits non-zero and prints no result line — both in
    the checkout and alone in an empty directory."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (ROOT, tmp_path):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["CUDA_VISIBLE_DEVICES"] = ""
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
            timeout=120, env=env)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
