"""The least times (bounds) that chip_smoke.py prints beside the fused MLP's
device times, checked on the CPU at the shapes the smoke times: one call is
two operations per multiply-add of the four layers, over the peak of the
units that do them (bf16 and f64 on the tensor cores, f32 on the CUDA
cores, 67 and 989 TFLOP/s on the H100 data sheet). chip_smoke.py imports
only the standard library at module level."""
import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode,B,flops,ms", [
    ("f32", 1 << 14, 424.1e9, 6.33),
    ("f64", 1 << 12, 106.0e9, 1.58),
    ("bf16", 884_736, 22.9e12, 23.16),
    ("f32", 884_736, 22.9e12, 341.9)])
def test_mlp_bound_at_path_shapes(mode, B, flops, ms):
    """_mlp_work's operations and bound_ms at the widths 11 -> 1600 -> 800
    -> 400 -> 1, S = 8, to the digits given; operations bind every one."""
    cs = _smoke()
    wsize, xsize, rate = cs.MLP_MODES[mode]
    n_bytes, n_flops = cs._mlp_work(B, 8, (11, 1600, 800, 400, 1), wsize,
                                    xsize)
    assert n_flops == 2.0 * B * 8 * (11 * 1600 + 1600 * 800 + 800 * 400 + 400)
    assert n_flops == pytest.approx(flops, rel=5e-4)
    b_ms, by = cs.bound_ms(n_bytes, n_flops, rate)
    assert by == "operations"
    assert b_ms == pytest.approx(ms, abs=5e-3 if ms < 100 else 0.05)
    assert cs.mlp_bound(mode, B) == (n_bytes, n_flops, b_ms, by)


def test_mlp_bound_counts_bytes_once():
    """Bytes: x, the weights, the biases and out, each once, in the mode's
    types (bf16 weights beside float32 x, biases and out)."""
    cs = _smoke()
    widths = (11, 1600, 800, 400, 1)
    macs = 11 * 1600 + 1600 * 800 + 800 * 400 + 400
    for mode, (w, x) in (("bf16", (2, 4)), ("f32", (4, 4)), ("f64", (8, 8))):
        n_bytes, _, _, _ = cs.mlp_bound(mode, 1000)
        assert n_bytes == (1000 * 11 * x + 8 * macs * w + 8 * 2801 * x
                           + 1000 * 8 * x)
        # with no operations to do, bytes bind
        assert cs.bound_ms(n_bytes, 0.0) == (n_bytes / cs.HBM_BYTES_PER_S
                                             * 1e3, "bytes")
    assert sum(widths[1:]) == 2801


@pytest.mark.parametrize("n,L,size,ms,by", [
    (10, 1 << 17, 4, 0.0313, "bytes"),
    (10, 1 << 17, 8, 0.0626, "bytes"),
    (10, 4096, 4, 0.00098, "bytes"),
    (54, 4096, 4, 0.0285, "bytes"),
    (54, 4096, 8, 0.0570, "bytes")])
def test_gj_bound_at_smoke_shapes(n, L, size, ms, by):
    """gj_bound: n^2 values read and written per lane; float32 also
    (2 n^3 + 3 n^2) operations per lane at the FP32 peak, which bind at no
    shape the smoke times; float64 by its bytes alone."""
    import types
    cs = _smoke()
    dtype = types.SimpleNamespace(itemsize=size)
    b_ms, b_by = cs.gj_bound(n, L, dtype)
    assert b_by == by
    assert b_ms == pytest.approx(ms, rel=2e-3)
    assert b_ms == pytest.approx(2 * n * n * L * size / cs.HBM_BYTES_PER_S
                                 * 1e3)


@pytest.mark.parametrize("size,rate,ms,by", [
    (4, 67e12, 0.1898, "operations"),
    (8, 34e12, 0.3741, "operations")])
def test_thermo_bound_at_the_benchmark_shape(size, rate, ms, by):
    """correctThermo's Newton kernel at 192^3 cells x 9 species, 8 steps:
    h, T_guess and 9 mass fractions read, T and psi written (13 values a
    cell); 1,797 operations a cell over the SIMT peak of the type (67
    TFLOP/s float32, 34 float64)."""
    cs = _smoke()
    cells = 192 ** 3
    n_bytes, n_ops = cs.thermo_work(cells, 9, 8, size)
    assert n_bytes == 13 * size * cells
    assert n_ops == (2 * 9 + 1 + 8 * (24 * 9 + 6) + 2) * cells == 1797 * cells
    b_ms, b_by = cs.bound_ms(n_bytes, n_ops, rate)
    assert b_by == by
    assert b_ms == pytest.approx(ms, abs=5e-4)
    assert cs.FP64_FLOP_PER_S == 34e12
