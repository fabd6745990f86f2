"""The benchmark's own tests: run from the root of a checkout with
``python3 -m pytest -q perfbench/tests``.  Tests that need the card are
marked ``cuda`` and decide inside the test whether there is one."""
import sys
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skipped where none is present")


@pytest.fixture
def tiny_cell():
    """A cell of the errorVSsnr kind at a size the CPU runs in milliseconds,
    held to the limits of ``snr_fused_b256``."""
    from perfbench import cells

    cell = cells.load("snr_fused_b256")
    cell.name = "tiny"
    cell.config = dict(cell.config, point=dict(cell.config["point"], Nt=2, Nr=8, Mr_e=8, Mr=4, Gr=8, Gt=2, L=2,
                                               n_clusters=1, n_rays=2, T=6, Imax=12),
                       sweep={"snr_db": [-6, 0, 6]})
    cell.traffic = dict(cell.traffic, n_mc=4)
    return cell


@pytest.fixture
def tiny_tracked_cell(tiny_cell):
    """The tiny cell at T = 3, so that N = Mr_e = 8 > M = T·Nt = 6: every point
    runs on the tracked route, the SVT on the transpose."""
    tiny_cell.name = "tiny_tracked"
    tiny_cell.config["point"]["T"] = 3
    tiny_cell.traffic = dict(tiny_cell.traffic, svt_method="tracked")
    return tiny_cell
