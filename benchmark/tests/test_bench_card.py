"""The cells on the card (marked ``cuda``; they skip without one): each run at a short
window is correct and prints the result line the contract asks for.

    python -m pytest benchmark/tests/test_bench_card.py -m cuda
"""

import json
import subprocess
import sys

import pytest

from benchsupport import CELLS, ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_cell_on_the_card(card, cell, trace):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(2**31 + 977), "--seconds", "3", "--trace", str(trace)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    if trace:
        assert line["device"]["busy_s"] > 0 and line["breakdown"]["device_ops"]
