"""The errorVSnrf cell, ``nrf_tracked_b10000``, cut to a tiny n_mc and
nothing else: every point on the tracked route at the published shapes, a
sound run correct, and the control and each fault of the tracked route not
correct, here on the CPU; a traced run on the card reads the cell's two
per-layer metrics."""
import time

import pytest
import torch
from test_perfbench_run import _answer_altered, _HostEvent, _tracked_half_the_batch, _tracked_state_unchanged

from perfbench import bench, cells, trace
from perfbench.system import Control, Port
from perfbench.traffic import Schedule

WORKLOAD = "nrf_tracked_b10000"
SEED = 2**31 + 54321
N_MC = 2


@pytest.fixture
def tiny_nrf_cell():
    """The cell as ``BENCHMARK.json`` gives it, its own limits included, at
    n_mc 2 in place of 10⁴."""
    cell = cells.load(WORKLOAD)
    cell.traffic = dict(cell.traffic, n_mc=N_MC)
    return cell


def run(cell, system_cls, device="cpu", traced=False):
    return bench.run_cell(cell, system_cls(device, SEED), SEED, 0.3, traced, time.time())


def test_every_point_runs_the_tracked_route_at_the_published_shapes():
    cell = cells.load(WORKLOAD)
    assert cell.traffic["n_mc"] == 10000 and cell.traffic["svt_method"] == "tracked"
    schedule = Schedule(cell.config, cell.traffic)
    port = Port("cpu", SEED)
    warmups = schedule.warmups()
    assert sorted({pt.params["Mr"] for pt in warmups}) == [4, 8, 12, 16]
    assert {port.route(pt) for pt in warmups} == {"tracked"}
    for pt in warmups:
        p = pt.params
        assert (p["Mr_e"], p["T"] * p["Nt"], p["Gr"], p["L"] * p["Gt"], p["Imax"]) == (32, 20, 32, 16, 100)
        assert pt.noise_var == pytest.approx(10 ** (-5 / 10))


def test_the_cut_cell_is_correct(tiny_nrf_cell):
    result = run(tiny_nrf_cell, Port)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] % N_MC == 0


def test_the_control_is_not_correct_in_the_cut_cell(tiny_nrf_cell):
    result = run(tiny_nrf_cell, Control)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", [_tracked_state_unchanged, _tracked_half_the_batch, _answer_altered])
def test_a_fault_makes_the_cut_cell_not_correct(tiny_nrf_cell, monkeypatch, fault):
    fault(monkeypatch)
    result = run(tiny_nrf_cell, Port)
    assert not result["correct"], result["checks"]


def test_the_cells_readers_read_its_spans(tiny_nrf_cell, monkeypatch):
    """One point under ``trace.spans``, with the card's synchronisation and
    events on the host: the front end is its ``draws`` and ``frontend`` spans
    together, the roofline share reads its two ``tracked_admm`` calls, and
    the fused kernel's share has nothing to read."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    schedule = Schedule(tiny_nrf_cell.config, tiny_nrf_cell.traffic)
    spans = []
    with trace.spans(spans):
        Port("cpu", SEED).run_point(next(schedule.window()))
    record = bench.Record(0.0, 1.0, [], spans, None)
    host = sum(s.seconds for s in spans if s.name in ("draws", "frontend"))
    assert cells.reader("tracked_frontend_ms")(record) == pytest.approx(1e3 * host)
    assert [s.name for s in spans if s.name == "tracked_admm"] == ["tracked_admm"] * 2
    assert 0 < cells.reader("tracked_admm_roofline")(record) < 100
    assert cells.reader("fused_admm_roofline")(record) is None


@pytest.mark.cuda
def test_a_traced_run_of_the_cut_cell_on_the_card(tiny_nrf_cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result = run(tiny_nrf_cell, Port, "cuda", traced=True)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"tracked_frontend_ms", "tracked_admm_roofline", "device_idle_pct"}
    assert 0 < result["metrics"]["tracked_admm_roofline"]["value"] <= 100
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert not run(tiny_nrf_cell, Control, "cuda")["correct"]
