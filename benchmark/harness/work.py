"""The yardstick's arithmetic: peaks of one H100 and the operations and bytes
of each layer's work, computed from the shapes that ran.

Frozen copies: `least_time` and `mlp_work` are chip_smoke.py's `bound_ms`
and `_mlp_work` (held there by tests/test_torch_smoke_bounds.py);
`stencil7_work` is the bound of chip_smoke.py's `_stencil_row` and
`helmholtz_bc_work` its `helmholtz_bc_bound` (PERF.md's kernel table).
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {
    "bfloat16": 989e12,     # bf16 on the tensor cores
    "float32": 67e12,       # float32 outside the tensor cores
    "float64": 67e12,       # float64 on the tensor cores
}
FP64_SIMT_FLOP_PER_S = 34e12


def least_time(n_bytes: float, n_flops: float, flop_rate: float):
    """(seconds, what binds): bytes over HBM bandwidth against operations
    over the peak of the units that do them, the larger."""
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, n_flops / flop_rate
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def macs(widths) -> int:
    return sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def mlp_work(B: int, S: int, widths, wsize: int, xsize: int):
    """(bytes, operations) of S stacked nets F -> ... -> 1 on B lanes: x,
    weights, biases and out once; two operations per multiply-add
    (unpadded widths)."""
    n_bytes = (B * widths[0] * xsize + S * macs(widths) * wsize
               + S * sum(widths[1:]) * xsize + B * S * xsize)
    return n_bytes, 2.0 * B * S * macs(widths)


def stencil7_work(batch: int, nx: int, ny: int, nz: int, itemsize: int):
    """x, D, three lo and three hi coefficient arrays read once, out
    written once; 13 operations a cell."""
    cells = batch * nx * ny * nz
    return 9 * itemsize * cells, 13.0 * cells


def helmholtz_bc_work(shape, itemsize: int):
    """x, diag and out once, the face arrays of the axes longer than one
    cell once; 1 + 7 operations a cell per such axis."""
    cells = math.prod(shape)
    active = [ax for ax, n in enumerate(shape) if n > 1]
    faces = sum(cells // shape[ax] * (shape[ax] + 1) for ax in active)
    return itemsize * (3 * cells + faces), (1.0 + 7 * len(active)) * cells


def simt_rate(itemsize: int) -> float:
    return PEAK_FLOP_PER_S["float32"] if itemsize == 4 else FP64_SIMT_FLOP_PER_S
