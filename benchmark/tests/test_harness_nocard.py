"""Without a card the benchmark prints no result and exits non-zero."""

import subprocess
import sys

import pytest

import cells


def test_exits_nonzero_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "bench4cam_k30.dense22", "--seed", "5000000000", "--seconds", "1",
         "--trace", "0"], cwd=cells.ROOT, capture_output=True, text=True)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr
