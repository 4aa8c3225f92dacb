"""Global reductions and the shard group of a distributed step.

Port of deepflame_tpu/parallel/context.py. The JAX package runs a
distributed step as one `shard_map` program and names the mesh axis it
reduces over; here each shard is one process of a `torch.distributed`
group, and the active "axis" is a `ShardGroup`: the process group, the grid
of shards along each named axis, this rank's coordinate on it and its
neighbours. The caller starts the processes and the process group
(`torchrun`, or `torch.multiprocessing` and `init_process_group`); nothing
here starts one or picks a backend.

With a group active (`with shard_axis(group):`), `gsum`, `gmax`, `gmin`,
`gmean` and `gsize` reduce locally and then `all_reduce` over the group, as
the JAX helpers `psum`/`pmax` over the shard axis; halo planes and buffers
travel point to point between neighbour ranks (`ShardGroup.sendrecv`, the
JAX package's `ppermute`) and the chemistry balance's lanes by `all_to_all`.
With none active, every helper is the plain local reduction.

Gloo's send and recv take host tensors only (with a CUDA tensor its
transport fails: "writev ... Bad address", tools/gloo_cuda_probe.py on
the H100): with the gloo backend and tensors on a CUDA card, the
point-to-point messages are staged through the host (the fields stay on
the card; `comm_stats["staged"]` counts them). Gloo's all_reduce,
all_gather and all_to_all take CUDA tensors (the probe), as NCCL takes
every one.

`with compensated():` routes gsum and gmean, and the Krylov solvers'
per-lane dot products and norms (ops/linsolve.py), through the compensated
two-float reduction (ops/compensated.sum2): float64-class accumulation of
float32 fields. `with cell_weight(w):` makes gmean, gmax and gmin over a
shard-local cell array (leading dimension len(w)) take only the cells with
w > 0, the cells a face-list shard owns (the JAX package weights its gmean
only).
"""
from __future__ import annotations

import contextlib
import math

import torch

__all__ = ["ShardGroup", "shard_axis", "current_axis", "gsum", "gmax",
           "gmin", "gmean", "gsize", "cell_weight", "current_cell_weight",
           "compensated", "compensated_on", "comm_stats",
           "reset_comm_stats"]

_AXIS: list = [None]
_WEIGHT: list = [None]
_COMP: list[bool] = [False]

# collectives of the active groups since the last reset: count and bytes
# of each kind, and the messages staged through the host
comm_stats = {"p2p": 0, "p2p_bytes": 0, "all_reduce": 0,
              "all_reduce_bytes": 0, "all_to_all": 0, "all_to_all_bytes": 0,
              "all_gather": 0, "all_gather_bytes": 0, "staged": 0}


def reset_comm_stats() -> None:
    for k in comm_stats:
        comm_stats[k] = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ShardGroup:
    """The ranks of a distributed step and their layout.

    `grid`: shards along each named axis (`names`), ranks in C order of
    the grid (rank = the flat index of its coordinate, as the JAX
    package's device array reshaped to the mesh shape); `group`: the
    torch.distributed process group (None: the default one), whose size
    must be prod(grid). The group must be initialized by the caller."""

    def __init__(self, grid, names, group=None):
        import torch.distributed as dist
        self.grid = tuple(int(p) for p in grid)
        self.names = tuple(names)
        if len(self.grid) != len(self.names):
            raise ValueError(f"grid {self.grid} and names {self.names}")
        self.group = group
        self.size = dist.get_world_size(group)
        if math.prod(self.grid) != self.size:
            raise ValueError(f"grid {self.grid} needs {math.prod(self.grid)} "
                             f"ranks, the group has {self.size}")
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self.coord = self.coord_of(self.rank)

    def coord_of(self, rank: int) -> tuple:
        """Grid coordinate of a group rank (C order)."""
        coord = []
        for p in reversed(self.grid):
            coord.append(rank % p)
            rank //= p
        return tuple(reversed(coord))

    def _axis(self, name) -> int:
        return self.names.index(name)

    def axis_size(self, name) -> int:
        return self.grid[self._axis(name)]

    def axis_index(self, name) -> int:
        return self.coord[self._axis(name)]

    def rank_at(self, coord) -> int:
        """Group rank of a grid coordinate (each entry taken modulo its
        axis)."""
        r = 0
        for c, p in zip(coord, self.grid):
            r = r * p + c % p
        return r

    def neighbour(self, name, offset: int) -> int:
        """Group rank `offset` shards along axis `name` (ring-wrapped)."""
        c = list(self.coord)
        c[self._axis(name)] += offset
        return self.rank_at(c)

    def _global(self, group_rank: int) -> int:
        import torch.distributed as dist
        if self.group is None:
            return group_rank
        return dist.get_global_rank(self.group, group_rank)

    def stages(self, t: torch.Tensor) -> bool:
        """Whether a point-to-point message of tensor t goes through the
        host here: gloo's send and recv take host tensors only (its
        collectives take the card's, tools/gloo_cuda_probe.py)."""
        return self.backend == "gloo" and t.device.type != "cpu"

    # ------------------------------------------------------- collectives
    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """t reduced over the group (sum, max or min), in place."""
        import torch.distributed as dist
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}[op]
        comm_stats["all_reduce"] += 1
        comm_stats["all_reduce_bytes"] += _nbytes(t)
        if t.dtype == torch.bool:
            u = t.to(torch.uint8)
            dist.all_reduce(u, red, group=self.group)
            t.copy_(u.bool())
            return t
        dist.all_reduce(t, red, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> list:
        """[t of each group rank], on t's device."""
        import torch.distributed as dist
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        comm_stats["all_gather"] += 1
        comm_stats["all_gather_bytes"] += _nbytes(t) * self.size
        dist.all_gather(out, t, group=self.group)
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """t (P, ...) -> out (P, ...) with out[i] = rank i's t[rank]: the
        JAX package's `lax.all_to_all(split_axis=0, concat_axis=0)`."""
        import torch.distributed as dist
        src = t.contiguous()
        out = torch.empty_like(src)
        comm_stats["all_to_all"] += 1
        comm_stats["all_to_all_bytes"] += _nbytes(src)
        dist.all_to_all_single(out, src, group=self.group)
        return out

    def p2p(self, sends=(), recvs=()) -> list:
        """Point-to-point messages in one batch: sends = [(tensor,
        destination group rank, tag)], recvs = [(tensor of the shape and
        type to receive, source group rank, tag)]; returns the received
        tensors, on the devices of the given ones. The two ends of a
        message use one tag; messages between one pair of ranks in one
        direction are posted in one order on both ends."""
        import torch.distributed as dist
        ops, outs = [], []
        for t, dst, tag in sends:
            stage = self.stages(t)
            s = (t.cpu() if stage else t).contiguous()
            comm_stats["p2p"] += 1
            comm_stats["p2p_bytes"] += _nbytes(s)
            comm_stats["staged"] += int(stage)
            ops.append(dist.P2POp(dist.isend, s, self._global(dst),
                                  self.group, tag))
        for like, src, tag in recvs:
            stage = self.stages(like)
            r = torch.empty(like.shape, dtype=like.dtype,
                            device="cpu" if stage else like.device)
            ops.append(dist.P2POp(dist.irecv, r, self._global(src),
                                  self.group, tag))
            outs.append((r, like.device, stage))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return [r.to(dev) if stage else r for r, dev, stage in outs]

    def sendrecv(self, msgs) -> list:
        """msgs = [(tensor, destination, source, tag)]: each tensor goes to
        its destination and one of its shape comes from its source (sent
        there under the same tag); returns the received tensors."""
        return self.p2p([(t, dst, tag) for t, dst, _, tag in msgs],
                        [(t, src, tag) for t, _, src, tag in msgs])


@contextlib.contextmanager
def shard_axis(group: ShardGroup | None):
    """Make `group` the active shard group inside the block (None: no
    group, local reductions)."""
    _AXIS.append(group)
    try:
        yield
    finally:
        _AXIS.pop()


def current_axis() -> ShardGroup | None:
    """The innermost active shard group, or None."""
    return _AXIS[-1]


@contextlib.contextmanager
def cell_weight(w):
    """Per-cell ownership weight (1 = a cell the shard owns, 0 = a halo or
    pad slot): gmean over an array whose leading dimension is len(w)
    averages only the owned cells, the single-device mean up to summation
    order. Other arrays keep the plain mean."""
    _WEIGHT.append(w)
    try:
        yield
    finally:
        _WEIGHT.pop()


def current_cell_weight():
    return _WEIGHT[-1]


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
    """Sum of every element, over the active group's shards."""
    if _COMP[-1]:
        from ..ops.compensated import sum2
        s = sum2(x)
    else:
        s = x.sum()
    g = current_axis()
    return g.all_reduce(s) if g is not None else s


def _owned(x, fill: float):
    """x with the cells a `cell_weight` marks as not owned set to fill
    (x unchanged where no weight applies)."""
    w = _WEIGHT[-1]
    if w is None or x.dim() < 1 or x.shape[0] != w.shape[0]:
        return x
    wb = w.reshape(w.shape + (1,) * (x.dim() - 1))
    return torch.where(wb > 0, x, torch.full((), fill, dtype=x.dtype,
                                             device=x.device))


def gmax(x):
    """Largest element over the active group's shards (owned cells only
    under a cell_weight: halo and pad slots hold copies or stale values)."""
    m = _owned(x, float("-inf")).max()
    g = current_axis()
    return g.all_reduce(m, "max") if g is not None else m


def gmin(x):
    m = _owned(x, float("inf")).min()
    g = current_axis()
    return g.all_reduce(m, "min") if g is not None else m


def gsize(x) -> int:
    """Element count of x over the active group's shards (every shard
    holds a block of one shape)."""
    g = current_axis()
    return x.numel() * (g.size if g is not None else 1)


def gmean(x):
    w = _WEIGHT[-1]
    if w is not None and x.dim() >= 1 and x.shape[0] == w.shape[0]:
        wb = w.reshape(w.shape + (1,) * (x.dim() - 1))
        num = gsum(torch.where(wb > 0, x, torch.zeros_like(x)))
        cnt = gsum(wb * torch.ones_like(x, dtype=w.dtype))
        return num / cnt
    if current_axis() is not None:
        return gsum(x) / gsize(x)
    return gsum(x) / x.numel() if _COMP[-1] else x.mean()
