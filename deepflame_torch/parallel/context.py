"""Global reductions of the solver (diagnostics, residual norms).

Port of deepflame_tpu/parallel/context.py for one device: the JAX helpers
become collectives over a shard axis when the step runs distributed; here
they are plain reductions over every element. Multi-device execution is a
later slice of the port.

`with compensated():` routes gsum and gmean, and the Krylov solvers'
per-lane dot products and norms (ops/linsolve.py), through the compensated
two-float reduction (ops/compensated.sum2): float64-class accumulation of
float32 fields.
"""
from __future__ import annotations

import contextlib

__all__ = ["gsum", "gmax", "gmin", "gmean", "compensated",
           "compensated_on"]

_COMP: list[bool] = [False]


@contextlib.contextmanager
def compensated(on: bool = True):
    """Use the compensated reductions inside the block (or not, on=False)."""
    _COMP.append(on)
    try:
        yield
    finally:
        _COMP.pop()


def compensated_on() -> bool:
    """Whether the innermost `compensated` block is on."""
    return _COMP[-1]


def gsum(x):
    if _COMP[-1]:
        from ..ops.compensated import sum2
        return sum2(x)
    return x.sum()


def gmax(x):
    return x.max()


def gmin(x):
    return x.min()


def gmean(x):
    return gsum(x) / x.numel() if _COMP[-1] else x.mean()
