"""Compensated (error-free-transform) float32 reductions.

Port of deepflame_tpu/ops/compensated.py. Two-float (Knuth/Dekker)
arithmetic: `sum2` and `dot2` reduce in two stages, plain block sums of
`block` values (a tree inside each block loses at most log2(block) ulps),
then a compensated combination of the block sums that carries each
addition's rounding error exactly (TwoSum) and adds the errors back at the
end. The JAX package combines the blocks in a sequential Neumaier scan;
here the combination is a pairwise TwoSum tree, log2 of the block count
deep instead of one step per block, with the same float64-class bound for
float32 inputs: the error terms of a level are at most one ulp of its sums.

`nd` reduces over the last `nd` dimensions only and keeps the leading ones,
so a batch of fields gets one compensated sum per lane (the Krylov
solvers' per-lane dot products and norms under
`parallel.context.compensated()`).
"""
from __future__ import annotations

import torch

__all__ = ["two_sum", "sum2", "dot2"]


def two_sum(a, b):
    """Knuth TwoSum: s = fl(a + b) and err with a + b == s + err exactly (in
    the absence of overflow)."""
    s = a + b
    bp = s - a
    err = (a - (s - bp)) + (b - bp)
    return s, err


def _combine(blocks):
    """Compensated sum over the last dimension: a pairwise TwoSum tree with
    the rounding errors summed alongside and added at the end."""
    s = blocks
    c = torch.zeros_like(s)
    while s.shape[-1] > 1:
        if s.shape[-1] % 2:
            s = torch.nn.functional.pad(s, (0, 1))
            c = torch.nn.functional.pad(c, (0, 1))
        s, err = two_sum(s[..., 0::2], s[..., 1::2])
        c = c[..., 0::2] + c[..., 1::2] + err
    return s[..., 0] + c[..., 0]


def sum2(x, block: int = 4096, nd: int | None = None):
    """Compensated sum: of every element (nd None), else over the last nd
    dimensions per lane. Accuracy ~ float64 for float32 inputs at 1e6+
    elements."""
    lead = () if nd is None else tuple(x.shape[:x.dim() - nd])
    xf = x.reshape(lead + (-1,))
    pad = (-xf.shape[-1]) % block
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    blocks = xf.reshape(lead + (-1, block)).sum(-1)
    return _combine(blocks)


def dot2(x, y, block: int = 4096, nd: int | None = None):
    """Compensated dot product <x, y> (per lane with nd, as sum2)."""
    return sum2(x * y, block, nd)
