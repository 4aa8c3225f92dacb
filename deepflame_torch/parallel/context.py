"""Global reductions of the solver (diagnostics, residual norms).

Port of deepflame_tpu/parallel/context.py for one device: the JAX helpers
become collectives over a shard axis when the step runs distributed; here
they are plain reductions over every element. Multi-device execution is a
later slice of the port.
"""
from __future__ import annotations

__all__ = ["gsum", "gmax", "gmin", "gmean"]


def gsum(x):
    return x.sum()


def gmax(x):
    return x.max()


def gmin(x):
    return x.min()


def gmean(x):
    return x.mean()
