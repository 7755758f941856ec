"""One short run of each cell on the card (marked `cuda`; skips where torch
sees none): `python -m pytest benchmark/tests -o addopts="" -m cuda`."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("workload", ["mimc128-2p20", "poseidon-merkle-d16"])
def test_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload,
                          "--seed", "4294967311", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
