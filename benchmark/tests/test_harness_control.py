"""The control comes out not correct: the reference computed in bfloat16
(its gray frames, window scores and weights rounded to it), standing in
the program's place, fails the cell's limits.

Needs the card (marked `cuda`; skips without one): the cell's real
configuration and mix on a 30-second window, three seeds.  On the card:

    python -m pytest benchmark/tests/test_harness_control.py -m cuda -q
"""

import pytest

import cells
import check
import run

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_fails_the_limits(cell_name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w = cells.cell(cells.benchmark(), cell_name)
    limits = cells.limits(cell_name)
    for seed in (6_000_000_001, 6_000_000_002, 6_000_000_003):
        res = run.run(cells.config(w["config"]), cells.traffic(w["traffic"]),
                      limits, seed, 30.0, False, controls=("bf16",))
        assert res["correct"], res["rows"]
        ok, rows = check.verdict(res["control_numbers"]["bf16"], limits)
        assert not ok, rows
