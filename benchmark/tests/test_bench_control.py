"""The control on the card: the reference in the precision below the
configuration's (check.Judge.control) fails at least one compared number
on every seed, while the program passes every one, at 64 cells a side
(a test run's size; benchmark/calibrate.py reads both at the cell's own
size). Skips without a CUDA card."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", ["tgv192-dnn-bf16.kernel",
                                       "tgv192-dnn-f32.kernel"])
def test_control_fails_where_the_program_passes(cell_name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import calibrate
    from harness import spec
    cell = spec.load_cell(cell_name)
    cell.config["n"] = 64
    for seed in (21, 22, 2147483653):
        r = calibrate.readings(cell, seed, True, 0, "cuda")
        assert all(r["program"][k] <= v for k, v in cell.limits.items()), r
        assert any(r["control"][k] > v for k, v in cell.limits.items()), r
