"""Structured block mesh + boundary-condition system.

Port of deepflame_tpu/mesh/structured.py. A uniform structured block; stencil
operations are slices of ghost-padded tensors. Fields are (..., nx, ny, nz):
every operator acts on the last three dimensions, so a leading batch
dimension (species, velocity components) rides along.

Boundary conditions are affine ghost relations ghost = a * owner + b, which
splits every discrete operator into an implicit part (homogeneous ghosts) and
a source part (b). Kinds: fixedValue, zeroGradient, fixedGradient, cyclic,
symmetry, empty, inletOutlet, affine, and processor: the inter-shard
boundary of a mesh axis split over the ranks of a distributed step
(`processor(axis_name, domain_bc)`), whose ghost plane comes from the
neighbour shard, point to point over the active shard group
(parallel.context.ShardGroup), where the JAX package's comes by `ppermute`;
the first and last shard take the domain-edge BC instead, unless it is
cyclic (then the ring is the periodic wrap).

Fields that share one batched solve but not their BCs (one FieldBCs per
species, per velocity component) take `stack_bcs`: the BCs of the lanes
stacked into affine BCs whose (a, b) carry the lane axis, so that one padded
tensor holds every lane's ghosts.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from ..device import resolve_device

__all__ = ["StructuredMesh", "BC", "FieldBCs", "pad_field", "pad_n",
           "extend_padded",
           "stack_bcs", "bcs_batch_shape", "fixed_value", "zero_gradient",
           "cyclic", "fixed_gradient", "symmetry", "empty", "processor",
           "processor_parts"]


@dataclasses.dataclass(frozen=True)
class StructuredMesh:
    """Uniform structured block mesh (3D; 1D/2D cases use size-1 axes with
    'empty' BCs). `device` is where its fields live."""
    nx: int
    ny: int
    nz: int
    dx: float
    dy: float
    dz: float
    x0: float = 0.0
    y0: float = 0.0
    z0: float = 0.0
    device: torch.device = torch.device("cpu")

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.nx, self.ny, self.nz)

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def volume(self) -> float:
        return self.dx * self.dy * self.dz

    @property
    def spacing(self) -> tuple[float, float, float]:
        return (self.dx, self.dy, self.dz)

    def cell_centers(self, dtype=torch.float64):
        ar = lambda n, o, h: o + (torch.arange(n, dtype=dtype,
                                               device=self.device) + 0.5) * h
        return torch.meshgrid(ar(self.nx, self.x0, self.dx),
                              ar(self.ny, self.y0, self.dy),
                              ar(self.nz, self.z0, self.dz), indexing="ij")

    @staticmethod
    def box(lengths: Sequence[float], cells: Sequence[int],
            origin: Sequence[float] = (0.0, 0.0, 0.0),
            device=None) -> "StructuredMesh":
        """Box mesh on `device` (default: the CUDA card, which must exist)."""
        nx, ny, nz = cells
        Lx, Ly, Lz = lengths
        return StructuredMesh(nx, ny, nz, Lx / nx, Ly / ny, Lz / nz,
                              origin[0], origin[1], origin[2],
                              device=resolve_device(device))


@dataclasses.dataclass(frozen=True)
class BC:
    """Affine ghost boundary condition: ghost = a * owner + b.

    `value`: field units for fixedValue/inletOutlet, field units per metre for
    fixedGradient, the (a, b) pair itself for 'affine'."""
    kind: str
    value: Any = 0.0

    def coeffs(self, h: float, side: int):
        """(a, b) for ghost = a*owner + b; side: -1 low face, +1 high face."""
        if self.kind == "fixedValue":
            return -1.0, 2.0 * self.value
        if self.kind in ("zeroGradient", "symmetry", "empty", "extrapolated"):
            return 1.0, 0.0
        if self.kind == "fixedGradient":
            return 1.0, side * self.value * h
        if self.kind == "symmetryNegate":   # normal velocity at a symmetry plane
            return -1.0, 0.0
        if self.kind == "inletOutlet":
            return -1.0, 2.0 * self.value
        if self.kind == "affine":
            return self.value
        raise ValueError(f"BC kind {self.kind} has no affine ghost")


def fixed_value(v) -> BC:
    return BC("fixedValue", v)


def zero_gradient() -> BC:
    return BC("zeroGradient")


def cyclic() -> BC:
    return BC("cyclic")


def fixed_gradient(g) -> BC:
    return BC("fixedGradient", g)


def symmetry(negate: bool = False) -> BC:
    return BC("symmetryNegate" if negate else "symmetry")


def empty() -> BC:
    return BC("empty")


def processor(axis_name: str, global_bc: BC) -> BC:
    """Processor (inter-shard) boundary of a mesh axis split over the shard
    group's axis `axis_name`; `global_bc` is the domain-edge BC, taken on
    the first and last shard unless it is cyclic."""
    return BC("processor", (axis_name, global_bc))


def processor_parts(bc: BC) -> tuple[str, BC]:
    """(shard axis name, domain-edge BC) of a processor BC."""
    assert bc.kind == "processor"
    return bc.value


def _ring_planes(plane_lo, plane_hi, axis_name: str):
    """Halo exchange of one boundary plane per side over the shard ring of
    `axis_name`: (ghost_lo, ghost_hi) = (the lower neighbour's plane_hi,
    the upper neighbour's plane_lo), ring-wrapped at the ends. A ring of
    one wraps onto itself."""
    from ..parallel.context import current_axis
    g = current_axis()
    if g is None:
        raise RuntimeError("processor boundary outside an active shard "
                           "group (parallel.context.shard_axis)")
    if g.axis_size(axis_name) == 1:
        return plane_hi, plane_lo
    lo, hi = g.neighbour(axis_name, -1), g.neighbour(axis_name, +1)
    return tuple(g.sendrecv([(plane_hi, hi, lo, 1), (plane_lo, lo, hi, 2)]))


def _edge_masks(axis_name: str) -> tuple[bool, bool]:
    """(is the first shard, is the last shard) of the ring of
    `axis_name`."""
    from ..parallel.context import current_axis
    g = current_axis()
    i, n = g.axis_index(axis_name), g.axis_size(axis_name)
    return i == 0, i == n - 1


def _edge_ghost(bc: BC, own, h: float, side: int, homogeneous: bool,
                bc_only: bool):
    a, b = bc.coeffs(h, side)
    if homogeneous:
        return a * own
    if bc_only:
        return torch.zeros_like(own) + b
    return a * own + b


def _pad_axis_processor(out, axis: int, lo: BC, hi: BC, h: float,
                        homogeneous: bool, bc_only: bool):
    """Pad one split axis with the neighbour shards' planes, the first and
    last shard taking the domain-edge BC's ghost."""
    name, gbc_lo = processor_parts(lo)
    name_hi, gbc_hi = processor_parts(hi)
    assert name == name_hi, "processor axis names must match"
    n = out.shape[axis - 3]
    own_lo, own_hi = _slab(out, axis, 0, 1), _slab(out, axis, n - 1, n)
    g_lo, g_hi = _ring_planes(own_lo, own_hi, name)
    if gbc_lo.kind != "cyclic" or gbc_hi.kind != "cyclic":
        first, last = _edge_masks(name)
        if gbc_lo.kind != "cyclic" and first:
            g_lo = _edge_ghost(gbc_lo, own_lo, h, -1, homogeneous, bc_only)
        if gbc_hi.kind != "cyclic" and last:
            g_hi = _edge_ghost(gbc_hi, own_hi, h, +1, homogeneous, bc_only)
    return torch.cat([g_lo, out, g_hi], dim=axis - 3)


# FieldBCs: ((x_lo, x_hi), (y_lo, y_hi), (z_lo, z_hi))
FieldBCs = tuple


def _same_bc(a: BC, b: BC) -> bool:
    """Same kind and the same value (one object, or equal numbers; a
    processor BC: the same axis and the same domain-edge BC)."""
    if a.kind != b.kind:
        return False
    if a.value is b.value:
        return True
    if a.kind == "processor":
        return a.value[0] == b.value[0] and _same_bc(a.value[1], b.value[1])
    return (isinstance(a.value, (int, float))
            and isinstance(b.value, (int, float)) and a.value == b.value)


def _as_slab(v, mesh: StructuredMesh, dtype):
    """A ghost coefficient (number or array) as a 3-D tensor on the mesh."""
    t = torch.as_tensor(v, dtype=dtype, device=mesh.device)
    return t.reshape((1,) * (3 - t.dim()) + tuple(t.shape))


def stack_bcs(bc_sets, mesh: StructuredMesh, dtype) -> FieldBCs:
    """One FieldBCs for a batch of fields (S, nx, ny, nz) from the FieldBCs
    of each lane. A face whose BCs agree on every lane keeps that BC; any
    other becomes BC("affine", (a, b)) with a and b of shape (S, ...)
    holding each lane's ghost relation, as BC.coeffs gives it (for an x face
    (S, 1, ny, nz) or (S, 1, 1, 1)). Cyclic faces must be cyclic on every
    lane."""
    return tuple(tuple(_stack_side([b[ax][side] for b in bc_sets], mesh,
                                   dtype, ax, side)
                       for side in (0, 1)) for ax in range(3))


def _stack_side(bcs, mesh: StructuredMesh, dtype, ax: int, side: int) -> BC:
    """One BC for a face from the BC of each lane (stack_bcs). Processor
    faces must be processor faces of one axis on every lane; their
    domain-edge BCs are stacked in turn."""
    for kind in ("cyclic", "processor"):
        hit = [bc.kind == kind for bc in bcs]
        if any(hit) and not all(hit):
            raise ValueError(f"axis {ax} side {side}: {kind} on some lanes "
                             "and not on others")
    if all(_same_bc(bcs[0], bc) for bc in bcs):
        return bcs[0]
    if bcs[0].kind == "processor":
        names = {processor_parts(bc)[0] for bc in bcs}
        if len(names) != 1:
            raise ValueError(f"axis {ax} side {side}: processor axes {names}")
        return processor(names.pop(), _stack_side(
            [processor_parts(bc)[1] for bc in bcs], mesh, dtype, ax, side))
    ab = [bc.coeffs(mesh.spacing[ax], 2 * side - 1) for bc in bcs]
    stacked = []
    for k in range(2):
        vals = [_as_slab(c[k], mesh, dtype) for c in ab]
        shape = torch.broadcast_shapes(*(v.shape for v in vals))
        stacked.append(torch.stack([v.expand(shape) for v in vals]))
    return BC("affine", tuple(stacked))


def bcs_batch_shape(bcs: FieldBCs) -> tuple:
    """Leading (lane) dimensions that stacked BCs give a padded field."""
    shape = ()
    for pair in bcs:
        for bc in pair:
            if bc.kind == "processor":
                bc = processor_parts(bc)[1]
            if bc.kind == "affine":
                for v in bc.value:
                    if isinstance(v, torch.Tensor) and v.dim() > 3:
                        shape = torch.broadcast_shapes(shape, v.shape[:-3])
    return tuple(shape)


def _slab(f, axis: int, start: int, stop: int):
    """f[..., start:stop along spatial axis `axis`, ...]."""
    return f.narrow(axis - 3, start, stop - start)


def pad_field(f, bcs: FieldBCs, mesh: StructuredMesh,
              homogeneous: bool = False, bc_only: bool = False):
    """Pad a (..., nx, ny, nz) cell field with one ghost layer per side.

    homogeneous: ghost = a * owner (drop b)  — for implicit matvecs.
    bc_only:     ghost = b, interior zeroed  — for source extraction.
    default:     ghost = a * owner + b       — for explicit (fvc) operators.
    """
    out = torch.zeros_like(f) if bc_only else f
    for axis in range(3):
        lo, hi = bcs[axis]
        d = axis - 3
        n = out.shape[d]
        if lo.kind == "processor" or hi.kind == "processor":
            if lo.kind != hi.kind:
                raise ValueError("processor BC must be paired on both sides")
            out = _pad_axis_processor(out, axis, lo, hi, mesh.spacing[axis],
                                      homogeneous, bc_only)
            continue
        if lo.kind == "cyclic" or hi.kind == "cyclic":
            if lo.kind != hi.kind:
                raise ValueError("cyclic BC must be paired on both sides")
            if bc_only:
                z = torch.zeros_like(_slab(out, axis, 0, 1))
                out = torch.cat([z, out, z], dim=d)
            else:
                out = torch.cat([_slab(out, axis, n - 1, n), out,
                                 _slab(out, axis, 0, 1)], dim=d)
            continue
        h = mesh.spacing[axis]
        a_lo, b_lo = lo.coeffs(h, -1)
        a_hi, b_hi = hi.coeffs(h, +1)
        own_lo = _slab(out, axis, 0, 1)
        own_hi = _slab(out, axis, n - 1, n)
        if homogeneous:
            g_lo, g_hi = a_lo * own_lo, a_hi * own_hi
        elif bc_only:
            g_lo = torch.zeros_like(own_lo) + b_lo
            g_hi = torch.zeros_like(own_hi) + b_hi
        else:
            g_lo, g_hi = a_lo * own_lo + b_lo, a_hi * own_hi + b_hi
        out = torch.cat([g_lo, out, g_hi], dim=d)
    return out


def pad_n(f, bcs: FieldBCs, mesh: StructuredMesh, n_ghost: int):
    """Pad with n_ghost layers per side on every axis: the first layer by
    the affine BC relation, outer layers by exact wrap (cyclic) or
    replication (physical boundaries), for wide stencils (WENO5 needs 3)."""
    P = pad_field(f, bcs, mesh)
    for axis in range(3):
        kind = bcs[axis][0].kind
        cyc, proc = kind == "cyclic", kind == "processor"
        for layer in range(1, n_ghost):
            n = P.shape[axis - 3]
            if cyc or proc:
                # padded = [g..., c0..c_{m-1}, ...g]: the next wrap values
                # (on a processor axis, the neighbour shard's: exchange the
                # same slices)
                lo = _slab(P, axis, n - 2 * layer - 1, n - 2 * layer)
                hi = _slab(P, axis, 2 * layer, 2 * layer + 1)
                if proc:
                    lo, hi = _processor_far(P, axis, bcs, hi, lo)
            else:
                lo, hi = _slab(P, axis, 0, 1), _slab(P, axis, n - 1, n)
            P = torch.cat([lo, P, hi], dim=axis - 3)
    return P


def extend_padded(P, axis: int, bcs: FieldBCs):
    """Second ghost layer for wide (TVD, cubic) stencils.

    P is a once-padded field (n+2 along axis). Returns (Pm, Pp), each n+3:
    Pm prepends the far-low ghost, Pp appends the far-high ghost. Cyclic axes
    wrap exactly; other BCs replicate the ghost."""
    n = P.shape[axis - 3]
    if bcs[axis][0].kind == "cyclic":
        far_lo = _slab(P, axis, n - 3, n - 2)      # c_{n-2}
        far_hi = _slab(P, axis, 2, 3)              # c_1
    elif bcs[axis][0].kind == "processor":
        # far-lo: the lower neighbour's c_{n-2} (its P[n-3]); far-hi: the
        # upper neighbour's c_1 (its P[2])
        far_lo, far_hi = _processor_far(P, axis, bcs,
                                        _slab(P, axis, 2, 3),
                                        _slab(P, axis, n - 3, n - 2))
    else:
        far_lo = _slab(P, axis, 0, 1)
        far_hi = _slab(P, axis, n - 1, n)
    return (torch.cat([far_lo, P], dim=axis - 3),
            torch.cat([P, far_hi], dim=axis - 3))


def _processor_far(P, axis: int, bcs: FieldBCs, send_lo, send_hi):
    """Outer ghost planes of a processor axis of the padded field P: the
    lower neighbour's `send_hi` and the upper neighbour's `send_lo`; the
    first and last shard replicate their outermost plane instead where the
    domain-edge BC is not cyclic."""
    name, gbc_lo = processor_parts(bcs[axis][0])
    _, gbc_hi = processor_parts(bcs[axis][1])
    far_lo, far_hi = _ring_planes(send_lo, send_hi, name)
    if gbc_lo.kind != "cyclic" or gbc_hi.kind != "cyclic":
        first, last = _edge_masks(name)
        n = P.shape[axis - 3]
        if gbc_lo.kind != "cyclic" and first:
            far_lo = _slab(P, axis, 0, 1)
        if gbc_hi.kind != "cyclic" and last:
            far_hi = _slab(P, axis, n - 1, n)
    return far_lo, far_hi
