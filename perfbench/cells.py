"""A cell of ``BENCHMARK.json``, found by name, and the files that belong to it.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one metric sits in a file of its own, found by its name:

- ``configs[].file`` (``perfbench/configs/<config>.json``): the deployment;
- ``perfbench/traffic/<traffic>.json``: the mix;
- ``perfbench/limits/<workload>.json``: the limit of each number the
  correctness check compares;
- ``perfbench/metrics/<metric>.py``: the metric's reader, a ``read(record)``
  that returns the number or None where it finds nothing to read.

A later cell or metric is added by adding files and entries; no file here
names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Callable, Dict, List, Optional

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = pathlib.Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; raises KeyError for
    a name it does not hold and FileNotFoundError for a file it names that
    is missing."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    base = root / "perfbench"
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config_name=w["config"],
        config=_load_json(root / configs[w["config"]]["file"]),
        traffic_name=w["traffic"],
        traffic=_load_json(base / "traffic" / f"{w['traffic']}.json"),
        limits=_load_json(base / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
    )


def reader(metric: str, root: pathlib.Path = ROOT) -> Callable[[object], Optional[float]]:
    """The ``read`` function of ``perfbench/metrics/<metric>.py``."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{metric}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
