"""The command itself, without a card: it exits non-zero and prints no result."""

import os
import subprocess
import sys

import pytest

from benchsupport import CELLS, ROOT


@pytest.mark.parametrize("cell", CELLS)
def test_no_card_no_result(cell):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(2**31 + 5), "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"metrics"' not in out.stdout and out.stdout.strip() == ""


def test_unknown_cell_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "no.such-cell",
                          "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
