"""BENCHMARK.json, the files it names, and what the benchmark imports."""
import ast
import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from perfbench import cells, check

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "jstsp19_tpu"}


def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    assert all(w["chips"] in (1, 4) for w in b["workloads"])
    assert {w["config"] for w in b["workloads"]} == {c["name"] for c in b["configs"]}
    assert len(json.dumps(b)) <= 64 * 1024


def test_names_and_units_use_only_allowed_characters():
    b = bench()
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in b[key]]
    names += [w["config"] for w in b["workloads"]] + [w["traffic"] for w in b["workloads"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for key in ("end_to_end", "per_layer"):
        assert len({m["name"] for m in b[key]}) == len(b[key])
        assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in b[key])
    texts = [x["why"] for key in ("configs", "workloads") for x in b[key]] + [c["source"] for c in b["configs"]]
    texts += [m["layer"] for m in b["per_layer"]] + b["command"]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_every_cell_resolves_to_its_files(workload):
    cell = cells.load(workload)
    assert cell.config["point"] and cell.config["sweep"]
    assert cell.traffic["n_mc"] > 0 and cell.traffic["methods"]
    assert set(cell.limits) == set(check.numbers(cell.traffic["methods"]))
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cells.reader(m["name"]))
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer


def test_a_new_cell_is_added_by_files_and_entries_alone(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    pb = tmp_path / "perfbench"
    config = json.loads((pb / "configs" / "errorvssnr.json").read_text())
    config["sweep"] = {"snr_db": [0]}
    (pb / "configs" / "one_point.json").write_text(json.dumps(config))
    (pb / "traffic" / "b32.json").write_text(json.dumps(dict(json.loads(
        (pb / "traffic" / "fused_b256.json").read_text()), n_mc=32)))
    (pb / "limits" / "one_b32.json").write_text((pb / "limits" / "snr_fused_b256.json").read_text())
    (pb / "metrics" / "points_done.py").write_text("def read(record):\n    return float(len(record.points))\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "one_point", "source": "a test", "file": "perfbench/configs/one_point.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "one_b32", "config": "one_point", "traffic": "b32", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "points_done", "unit": "points", "better": "higher", "source": "host_clock",
                           "layer": "a test", "moves": "realizations_per_s", "workloads": ["one_b32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    cell = cells.load("one_b32", root=tmp_path)
    assert cell.config["sweep"] == {"snr_db": [0]} and cell.traffic["n_mc"] == 32
    assert [m["name"] for m in cell.per_layer][-1] == "points_done"
    assert cells.reader("points_done", root=tmp_path)(type("R", (), {"points": [1, 2]})()) == 2.0
    assert "points_done" not in {m["name"] for m in cells.load("snr_fused_b256", root=tmp_path).per_layer}
    assert all(p.read_bytes() == data for p, data in before.items())


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_in_the_harness_and_nothing_of_the_program_in_the_reference():
    for path in (ROOT / "perfbench").rglob("*.py"):
        found = set(_imports(path)) & FORBIDDEN
        assert not found, (path, found)
    for path in (ROOT / "perfbench" / "reference").rglob("*.py"):
        found = set(_imports(path)) & (FORBIDDEN | {"jstsp19_torch"})
        assert not found, (path, found)


def test_a_run_loads_no_jax_module():
    """What the port loads in the process, which a scan of sources cannot see:
    the harness's modules and a whole run on the CPU, then ``sys.modules``."""
    code = (
        "import sys, time\n"
        "from perfbench import bench, calibrate, cells, check, roofline, run, spread, system, trace\n"
        "import perfbench.reference\n"
        "ref_only = sorted({m.split('.')[0] for m in sys.modules} & {'jstsp19_torch', 'jax', 'jaxlib', 'flax', "
        "'jstsp19_tpu'})\n"
        "cell = cells.load('snr_fused_b256')\n"
        "cell.config['point'].update(Nt=2, Nr=8, Mr_e=8, Mr=4, Gr=8, Gt=2, L=2, n_clusters=1, n_rays=2, T=6, Imax=4)\n"
        "cell.config['sweep'] = {'snr_db': [0]}\n"
        "cell.traffic['n_mc'] = 2\n"
        "bench.run_cell(cell, system.Port('cpu', 3), 3, 0.05, False, time.time())\n"
        "print(ref_only, run.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"
