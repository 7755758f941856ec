"""CPU tests of the benchmark: `python -m pytest benchmark/tests -o addopts=""`.
The tests marked `cuda` run a cell on the card and skip where torch sees
none (decided inside the test)."""

import dataclasses

import pytest
import torch

from benchmark import cells


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def toy_cell(name: str) -> cells.Cell:
    """A workload of BENCHMARK.json at a size the CPU proves in seconds."""
    c = cells.cell(name)
    traffic = dict(c.traffic, statements=4, warmup=1, verify_count=2, check_count=3,
                   traced_requests=2)
    if "steps" in traffic:
        traffic["steps"] = 64
    else:
        traffic["depth"] = 2
    return dataclasses.replace(c, traffic=traffic)
