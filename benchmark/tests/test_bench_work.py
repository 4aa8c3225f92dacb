"""The yardstick's operation and byte counts reproduce the bounds of
PERF.md's kernel table at the cells' shapes."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from harness import work  # noqa: E402

WIDTHS = (11, 1600, 800, 400, 1)


@pytest.mark.parametrize("precision,wsize,ms", [("bfloat16", 2, 23.16),
                                                ("float32", 4, 341.85)])
def test_mlp_bound_at_the_cells_shape(precision, wsize, ms):
    n_bytes, flops = work.mlp_work(884_736, 8, WIDTHS, wsize, 4)
    assert flops == 2.0 * 884_736 * 8 * (11 * 1600 + 1600 * 800 + 800 * 400 + 400)
    assert flops == pytest.approx(2.290e13, rel=5e-4)
    t, by = work.least_time(n_bytes, flops, work.PEAK_FLOP_PER_S[precision])
    assert by == "operations"
    assert t * 1e3 == pytest.approx(ms, abs=0.01)


def test_stencil_and_helmholtz_bounds_at_96_cubed():
    n_bytes, flops = work.stencil7_work(9, 96, 96, 96, 4)
    t, by = work.least_time(n_bytes, flops, work.simt_rate(4))
    assert by == "bytes" and t * 1e3 == pytest.approx(0.0856, abs=5e-5)
    n_bytes, flops = work.helmholtz_bc_work((96, 96, 96), 4)
    t, by = work.least_time(n_bytes, flops, work.simt_rate(4))
    assert by == "bytes" and t * 1e3 == pytest.approx(0.00637, abs=5e-6)


def test_bytes_bind_with_no_operations():
    assert work.least_time(3.35e12, 0.0, 1.0) == (1.0, "bytes")
