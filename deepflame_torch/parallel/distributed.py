"""Domain decomposition of the structured low-Mach solver over ranks.

Port of deepflame_tpu/parallel/distributed.py (the reference's decomposePar,
processor patches and NCCL halo exchange). The JAX package runs the step as
one `shard_map` program over a device mesh; here every rank of a
torch.distributed group runs the step on its block of the mesh, in lockstep
with the others:

- the mesh is split into (px, py, pz) blocks, rank r holding the block at
  the C-order coordinate of r (`parallel.context.ShardGroup`);
- every split axis carries processor BCs (`localize_bcs`): ghost planes come
  point to point from the neighbour ranks (the JAX package's `ppermute`),
  the first and last block taking the domain-edge BCs;
- Krylov dot products, norms and diagnostics are `all_reduce`s (psum/pmax);
- each rank bins and drains its own cells' chemistry, or with
  `Laminar(dlb_cross_shard=True)` balances the stiff cells across the ranks
  by `all_to_all`.

Face fluxes: every rank owns the low face of each of its cells along each
axis; the one domain-top plane of an axis is carried by every rank of that
axis' line (`DistLowMachState.phi_top`). A step takes each block's high
faces from the next rank's low faces (or the top plane on the last rank of
a non-cyclic axis) and afterwards copies the last rank's new top plane to
the others of its line.

The caller starts the ranks and the process group; each rank builds the
global solver and state on its own device (`cuda:<local rank>` with one card
per rank and NCCL; one card shared by several ranks takes gloo):

    dist = DistributedLowMach(solver, mesh_shape=(4, 1, 1))
    ds = dist.shard_state(state)          # this rank's block
    ds, diag = dist.step(ds, dt)          # diag equal on every rank
    s = dist.gather_state(ds)             # the global state, on every rank
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from ..mesh.structured import processor
from ..solvers.low_mach import LowMachState
from .context import ShardGroup, shard_axis

__all__ = ["DistributedLowMach", "DistLowMachState", "localize_bcs",
           "localize_solver"]


class DistLowMachState(NamedTuple):
    """One rank's block of a LowMachState, each axis' face fluxes split
    into the low face of every cell (the block's shape) and the domain-top
    plane (extent 1 along the axis, the block's extent along the others)."""
    rho: torch.Tensor
    U: torch.Tensor
    p: torch.Tensor
    ha: torch.Tensor
    Y: torch.Tensor
    T: torch.Tensor
    phi_low: tuple
    phi_top: tuple
    dpdt: torch.Tensor
    time: torch.Tensor
    turb: tuple = ()
    cscalars: tuple = ()
    chem_dt: Any = None


def localize_bcs(bcs, axis_name: str, mesh_axis: int = 0):
    """The FieldBCs with axis `mesh_axis`'s pair replaced by processor BCs
    of shard axis `axis_name` carrying the original (domain-edge) BCs."""
    out = []
    for ax in range(3):
        lo, hi = bcs[ax]
        if ax == mesh_axis:
            out.append((processor(axis_name, lo), processor(axis_name, hi)))
        else:
            out.append((lo, hi))
    return tuple(out)


def _check_unsplit(value, bc_axis: int, mesh_shape, what: str) -> None:
    """Raise if a BC value (a number, an array, or a tuple of them) is an
    array with more than one entry along a split axis other than the BC's
    own: it spans the global mesh there and would not fit the block. (The
    JAX package's localize_solver keeps such a value as it is.)"""
    if isinstance(value, (tuple, list)):
        for v in value:
            if isinstance(v, str):
                continue
            _check_unsplit(v.value if hasattr(v, "kind") else v, bc_axis,
                           mesh_shape, what)
        return
    shape = tuple(getattr(value, "shape", ()))
    if not shape:
        return
    shape = ((1,) * 3 + shape)[-3:]
    for a in range(3):
        if a != bc_axis and mesh_shape[a] > 1 and shape[a] > 1:
            raise ValueError(f"{what}: a BC value of shape {tuple(value.shape)}"
                             f" spans mesh axis {a}, which is split over "
                             f"{mesh_shape[a]} ranks; give per-block values")


def localize_solver(solver, n_shards: int | None = None,
                    axis_name: str = "x", mesh_axis: int = 0,
                    mesh_shape=None, names=("x", "y", "z"), coord=None):
    """One rank's LowMachSolver: its block of the mesh (spacing kept, the
    block's own origin when `coord`, its grid coordinate, is given) and
    processor BCs on every split axis (decomposePar and processor patches).
    mesh_shape = (px, py, pz); the (n_shards, axis_name, mesh_axis) form is
    a slab along one axis. Each split extent must divide, and its block
    extent be even (the diagonal coloring across blocks). Raises where a BC
    value is an array spanning a split axis."""
    if mesh_shape is None:
        mesh_shape = [1, 1, 1]
        mesh_shape[mesh_axis] = n_shards
        names = tuple(axis_name if a == mesh_axis else n
                      for a, n in enumerate(("x", "y", "z")))
    m = solver.mesh
    sizes = [m.nx, m.ny, m.nz]
    for ax in range(3):
        p_ax = mesh_shape[ax]
        if p_ax == 1:
            continue
        if sizes[ax] % p_ax != 0:
            raise ValueError(f"mesh axis {ax} extent {sizes[ax]} not "
                             f"divisible by {p_ax} shards")
        sizes[ax] //= p_ax
        if sizes[ax] % 2 != 0:
            raise ValueError(f"local extent {sizes[ax]} on axis {ax} must "
                             "be even (diagonal coloring consistency "
                             "across shard boundaries)")
    coord = (0, 0, 0) if coord is None else coord
    origin = [o + c * n * h for o, c, n, h in
              zip((m.x0, m.y0, m.z0), coord, sizes, m.spacing)]
    local_mesh = dataclasses.replace(m, nx=sizes[0], ny=sizes[1],
                                     nz=sizes[2], x0=origin[0],
                                     y0=origin[1], z0=origin[2])

    def loc(b, what):
        for ax in range(3):
            for bc in b[ax]:
                _check_unsplit(bc.value, ax, mesh_shape, what)
        for ax in range(3):
            if mesh_shape[ax] > 1:
                b = localize_bcs(b, names[ax], ax)
        return b

    turb = solver.turbulence
    if dataclasses.is_dataclass(turb) and any(mesh_shape[a] > 1
                                              for a in range(3)):
        for f in dataclasses.fields(turb):
            v = getattr(turb, f.name)
            if (isinstance(v, torch.Tensor) and v.dim() >= 3
                    and tuple(v.shape[-3:]) == m.shape):
                raise ValueError(f"turbulence.{f.name} is a field of the "
                                 "global mesh; build the model per block")
    bcs_Y = solver.bcs_Y
    bcs_Y = ([loc(b, f"bcs_Y[{i}]") for i, b in enumerate(bcs_Y)]
             if isinstance(bcs_Y, list) else loc(bcs_Y, "bcs_Y"))
    return dataclasses.replace(
        solver,
        mesh=local_mesh,
        bcs_U=tuple(loc(b, f"bcs_U[{c}]") for c, b in enumerate(solver.bcs_U)),
        bcs_p=loc(solver.bcs_p, "bcs_p"),
        bcs_h=loc(solver.bcs_h, "bcs_h"),
        bcs_Y=bcs_Y,
        bcs_rho=loc(solver.bcs_rho, "bcs_rho"),
        bcs_Z=(loc(solver.bcs_Z, "bcs_Z") if solver.bcs_Z is not None
               else None),
    )


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device
    return (a.index if a.index is not None else cur()) == \
        (b.index if b.index is not None else cur())


class DistributedLowMach:
    """A LowMachSolver decomposed over the ranks of a process group.

    mesh_shape = (px, py, pz) (default (n_shards or the group's size, 1,
    1)); group: a torch.distributed process group (None: the default one),
    of prod(mesh_shape) ranks, initialized by the caller; device: this
    rank's device, which must be the solver's (default: the solver's).
    Rank r holds the block at the C-order coordinate of r."""

    def __init__(self, solver, n_shards: int | None = None, mesh_shape=None,
                 group=None, device=None):
        import torch.distributed as dist
        if mesh_shape is None:
            if n_shards is None:
                n_shards = dist.get_world_size(group)
            mesh_shape = (n_shards, 1, 1)
        self.mesh_shape = tuple(int(p) for p in mesh_shape)
        self.n_shards = math.prod(self.mesh_shape)
        self.names = ("x", "y", "z")
        self.part_axes = tuple(a for a in range(3) if self.mesh_shape[a] > 1)
        dev = solver.device if device is None else torch.device(device)
        if not _same_device(dev, solver.device):
            raise ValueError(f"device {dev}: the solver is on "
                             f"{solver.device}; build it on the rank's "
                             "device")
        self.device = dev
        self.solver = solver
        self.shard = ShardGroup(self.mesh_shape, self.names, group)
        self.local_solver = localize_solver(
            solver, mesh_shape=self.mesh_shape, names=self.names,
            coord=self.shard.coord)
        self._cyclic = tuple(solver.bcs_p[a][0].kind == "cyclic"
                             for a in range(3))
        m = self.local_solver.mesh
        self.block = tuple(slice(c * n, (c + 1) * n)
                           for c, n in zip(self.shard.coord, m.shape))

    # ------------------------------------------------------------- layout
    def _cells(self, x):
        """This rank's block of a global field (..., nx, ny, nz)."""
        return x[(Ellipsis,) + self.block]

    def shard_state(self, s: LowMachState) -> DistLowMachState:
        """This rank's block of the global state s (on the rank's device)."""
        low, top = [], []
        for ax in range(3):
            n = s.phi[ax].shape[ax]
            low.append(self._cells(s.phi[ax].narrow(ax, 0, n - 1))
                       .contiguous())
            sl = list(self.block)
            sl[ax] = slice(n - 1, n)
            top.append(s.phi[ax][tuple(sl)].contiguous())
        cell = lambda x: self._cells(x).contiguous()
        return DistLowMachState(
            rho=cell(s.rho), U=cell(s.U), p=cell(s.p), ha=cell(s.ha),
            Y=cell(s.Y), T=cell(s.T), phi_low=tuple(low), phi_top=tuple(top),
            dpdt=cell(s.dpdt), time=s.time,
            turb=tuple(cell(t) for t in s.turb),
            cscalars=tuple(cell(t) for t in s.cscalars),
            chem_dt=(cell(s.chem_dt) if isinstance(s.chem_dt, torch.Tensor)
                     else s.chem_dt))

    def _assemble(self, x, top_axis=None):
        """The global field from every rank's block x (all_gather); with
        top_axis, x is that axis' top plane and the result the global
        plane."""
        g = self.shard
        parts = g.all_gather(x)
        lead = x.shape[:-3]
        shape = list(self.solver.mesh.shape)
        if top_axis is not None:
            shape[top_axis] = 1
        out = x.new_empty(lead + tuple(shape))
        for r, blk in enumerate(parts):
            sl = [slice(ci * n, (ci + 1) * n)
                  for ci, n in zip(g.coord_of(r), blk.shape[-3:])]
            if top_axis is not None:
                sl[top_axis] = slice(0, 1)
            out[(Ellipsis,) + tuple(sl)] = blk
        return out

    def gather_state(self, ds: DistLowMachState) -> LowMachState:
        """The global state, on every rank (all_gather of every block)."""
        phi = tuple(torch.cat([self._assemble(ds.phi_low[ax]),
                               self._assemble(ds.phi_top[ax], ax)], dim=ax)
                    for ax in range(3))
        a = self._assemble
        return LowMachState(
            rho=a(ds.rho), U=a(ds.U), p=a(ds.p), ha=a(ds.ha), Y=a(ds.Y),
            T=a(ds.T), phi=phi, dpdt=a(ds.dpdt), time=ds.time,
            turb=tuple(a(t) for t in ds.turb),
            cscalars=tuple(a(t) for t in ds.cscalars),
            chem_dt=(a(ds.chem_dt) if isinstance(ds.chem_dt, torch.Tensor)
                     else ds.chem_dt))

    # --------------------------------------------------------------- step
    def _is_last(self, ax: int) -> bool:
        return self.shard.coord[ax] == self.mesh_shape[ax] - 1

    def _faces(self, ds: DistLowMachState) -> tuple:
        """Each axis' local faces 0..n: the block's low faces, then the
        next rank's first low face (ring), or the domain-top plane on the
        last rank of a non-cyclic axis."""
        g = self.shard
        phi = []
        for ax in range(3):
            low = ds.phi_low[ax]
            low0 = low.narrow(ax, 0, 1)
            if self.mesh_shape[ax] > 1:
                name = self.names[ax]
                nxt = g.sendrecv([(low0, g.neighbour(name, -1),
                                   g.neighbour(name, +1), 3)])[0]
            else:
                nxt = low0
            if self._cyclic[ax]:
                top = nxt
            elif self.mesh_shape[ax] > 1 and not self._is_last(ax):
                top = nxt
            else:
                top = ds.phi_top[ax]
            phi.append(torch.cat([low, top], dim=ax))
        return tuple(phi)

    def _replicate_top(self, top: torch.Tensor, ax: int) -> torch.Tensor:
        """The last rank's top plane of axis ax, on every rank of its
        line along ax (point to point from the last rank)."""
        g = self.shard
        p_ax = self.mesh_shape[ax]
        line = [list(g.coord) for _ in range(p_ax)]
        for i, c in enumerate(line):
            c[ax] = i
        last = g.rank_at(line[-1])
        if g.rank == last:
            g.p2p(sends=[(top, g.rank_at(c), 4) for c in line[:-1]])
            return top
        return g.p2p(recvs=[(top, last, 4)])[0]

    def step(self, ds: DistLowMachState, dt, sources=None):
        """One PIMPLE step of every block: (new state, diagnostics); the
        diagnostics are all_reduce(MAX)ed, equal on every rank. sources:
        this block's spray sources (LowMachSolver.step), or None."""
        g = self.shard
        with shard_axis(g):
            s = LowMachState(
                rho=ds.rho, U=ds.U, p=ds.p, ha=ds.ha, Y=ds.Y, T=ds.T,
                phi=self._faces(ds), dpdt=ds.dpdt, time=ds.time,
                turb=ds.turb, cscalars=ds.cscalars, chem_dt=ds.chem_dt)
            s2, diag = self.local_solver.step(s, dt, sources=sources)
            low, tops = [], []
            for ax in range(3):
                n = s2.phi[ax].shape[ax]
                low.append(s2.phi[ax].narrow(ax, 0, n - 1).contiguous())
                top = s2.phi[ax].narrow(ax, n - 1, 1).contiguous()
                if self.mesh_shape[ax] > 1:
                    top = self._replicate_top(top, ax)
                tops.append(top)
            diag = {k: g.all_reduce(torch.as_tensor(v, device=self.device)
                                    .clone(), "max")
                    for k, v in diag.items()}
        ds2 = DistLowMachState(
            rho=s2.rho, U=s2.U, p=s2.p, ha=s2.ha, Y=s2.Y, T=s2.T,
            phi_low=tuple(low), phi_top=tuple(tops), dpdt=s2.dpdt,
            time=s2.time, turb=s2.turb, cscalars=s2.cscalars,
            chem_dt=s2.chem_dt)
        return ds2, diag
