"""Tests of the benchmark. Most run on the CPU at tiny sizes; those marked
``card`` need a CUDA card, decide so in the ``card`` fixture, and run on
the chip with ``python3 -m pytest benchmark/tests -m card``."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# tiny sizes of each cell for the CPU: the cell's own code paths, few rows
TINY = {
    "higgs.train": {"data": {"train_rows": 12000, "valid_rows": 3000},
                    "params": {"num_leaves": 15,
                               "min_sum_hessian_in_leaf": 5}},
    "mslr.train": {"data": {"train_rows": 9000, "valid_rows": 2400,
                            "train_queries": 75, "valid_queries": 20},
                   "params": {"num_leaves": 15,
                              "min_sum_hessian_in_leaf": 1}},
    "higgs.score": {"data": {"batch_rows": 20000},
                    "params": {"num_trees": 60, "num_leaves": 31}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (runs on the chip; skips here)")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the chip")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def run_tiny(cell, seed=5, seconds=0.5, trace=False, control=False,
             root=ROOT):
    """``report.run_cell`` of a cell on the CPU at its tiny size."""
    import time
    import torch
    from benchmark.harness.report import run_cell
    return run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                    time.perf_counter(), control=control, root=root,
                    overrides=TINY[cell])
