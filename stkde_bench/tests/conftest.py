"""Fixtures of the benchmark's CPU tests: tiny cells, and the card marker."""
import sys
from pathlib import Path

import pytest

# the port, as the benchmark's run puts it on the path
SRC = str(Path(__file__).resolve().parents[2] / "src")
if SRC not in sys.path:
    sys.path.append(SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; decides inside the test and "
        "skips without one")


@pytest.fixture
def card():
    """Skip the test unless a CUDA card is present (decided here, at run
    time, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def tiny():
    """``tiny(workload)``: the manifest's cell with a grid and a point count
    that the CPU runs in a second, the bandwidths cut to fit. Torch keeps
    one CPU thread meanwhile, so that tests running side by side do not
    slow each other's windows down to a query or two."""
    import torch

    from stkde_bench import harness

    def make(name, n=2500, grid=(40, 30, 20), hs=3, ht=2, **traffic):
        cell = harness.load_cell(name)
        cell.config.update(n=n, Gx=grid[0], Gy=grid[1], Gt=grid[2])
        cell.traffic.update(dict(bandwidths=[[hs, ht]], trace_queries=3,
                                 staged_queries=2), **traffic)
        return cell
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield make
    torch.set_num_threads(threads)
