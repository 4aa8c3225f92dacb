"""Distributed execution: domain decomposition over torch.distributed ranks.

Port of deepflame_tpu/parallel: the reductions and the shard group
(`context`), the structured low-Mach solver over a (px, py, pz) grid of
ranks (`distributed`) and the face-list one over ranks of cell slabs
(`distributed_fl`). The caller starts the ranks and the process group.
"""
from .context import (ShardGroup, cell_weight, current_axis,
                      current_cell_weight, gmax, gmean, gmin, gsize, gsum,
                      shard_axis)

__all__ = ["ShardGroup", "shard_axis", "current_axis", "gsum", "gmax",
           "gmin", "gmean", "gsize", "cell_weight", "current_cell_weight",
           "DistributedLowMach", "DistLowMachState", "localize_bcs",
           "localize_solver", "DistributedLowMachFL", "FLDecomp",
           "block_order"]

_LAZY = {"DistributedLowMach": "distributed", "DistLowMachState":
         "distributed", "localize_bcs": "distributed", "localize_solver":
         "distributed", "DistributedLowMachFL": "distributed_fl",
         "FLDecomp": "distributed_fl", "block_order": "distributed_fl"}


def __getattr__(name):
    # the distributed modules import the solvers, which import this
    # package's context module: resolve them on first use
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(name)
