"""Adaptive mesh resolution: multi-criteria marking and conservative
re-gridding.

Port of deepflame_tpu/mesh/amr.py (the role of the reference's
dfDynamicRefineFvMesh::update with multiCritRefinement criteria: field value
windows, |grad f|, |curl U| and interface proximity, buffer layers). The
marker field decides when the resolution of the whole block (or of some
axes) changes by a factor of two between steps; fields move between the
grids by piecewise-constant prolongation and block-mean restriction, and the
caller rebuilds its solver for the new mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .structured import StructuredMesh
from ..ops.fv import grad

__all__ = ["RefinementCriteria", "mark_cells", "refine_field", "coarsen_field",
           "refine_mesh", "coarsen_mesh", "AdaptiveResolution"]


@dataclasses.dataclass(frozen=True)
class RefinementCriteria:
    """multiCritRefinement: any satisfied criterion marks a cell."""
    # field value window: mark where lo <= f <= hi
    fields: tuple = ()           # ((name, lo, hi), ...)
    # gradient magnitude: mark where |grad f| * dx >= threshold
    gradients: tuple = ()        # ((name, threshold), ...)
    # curl magnitude of the vector field named: |curl U| * dx >= threshold
    curls: tuple = ()            # ((name, threshold), ...)
    # interface proximity: mark where lo <= f <= hi (e.g. 0.01 < Y < 0.99)
    interfaces: tuple = ()       # ((name, lo, hi), ...)
    n_buffer: int = 2            # buffer layers (nBufferLayers)


def _dilate(mask: torch.Tensor, n: int) -> torch.Tensor:
    """Grow a 0/1 mask (nx, ny, nz) by n cells in each direction."""
    for _ in range(n):
        m = mask
        for ax in range(3):
            if mask.shape[ax] == 1:
                continue
            up = torch.roll(m, 1, dims=ax)
            dn = torch.roll(m, -1, dims=ax)
            # roll wraps; zero the wrapped faces
            up.narrow(ax, 0, 1).zero_()
            dn.narrow(ax, m.shape[ax] - 1, 1).zero_()
            mask = torch.maximum(mask, torch.maximum(up, dn))
    return mask


def mark_cells(criteria: RefinementCriteria, fields: dict,
               bcs: Any, mesh: StructuredMesh) -> torch.Tensor:
    """0/1 marker field (nx, ny, nz) from the multi-criteria set; gradients
    and curls take `bcs` for every field."""
    dtype = next((f.dtype for f in fields.values()
                  if torch.is_tensor(f) and f.is_floating_point()),
                 torch.get_default_dtype())
    mark = torch.zeros(mesh.shape, dtype=dtype, device=mesh.device)
    h = min(s for s, n in zip(mesh.spacing, mesh.shape) if n > 1)
    for name, lo, hi in tuple(criteria.fields) + tuple(criteria.interfaces):
        f = fields[name]
        mark = torch.maximum(mark, ((f >= lo) & (f <= hi)).to(dtype))
    for name, thr in criteria.gradients:
        g = grad(fields[name], bcs, mesh)
        mag = torch.sqrt((g ** 2).sum(0))
        mark = torch.maximum(mark, (mag * h >= thr).to(dtype))
    for name, thr in criteria.curls:
        U = fields[name]              # (3, ...)
        gx, gy, gz = (grad(U[i], bcs, mesh) for i in range(3))
        curl = torch.stack([gz[1] - gy[2], gx[2] - gz[0], gy[0] - gx[1]])
        mag = torch.sqrt((curl ** 2).sum(0))
        mark = torch.maximum(mark, (mag * h >= thr).to(dtype))
    return _dilate(mark, criteria.n_buffer)


def refine_mesh(mesh: StructuredMesh, axes=(0, 1, 2)) -> StructuredMesh:
    f = [2 if (a in axes and mesh.shape[a] > 1) else 1 for a in range(3)]
    return StructuredMesh(mesh.nx * f[0], mesh.ny * f[1], mesh.nz * f[2],
                          mesh.dx / f[0], mesh.dy / f[1], mesh.dz / f[2],
                          mesh.x0, mesh.y0, mesh.z0, device=mesh.device)


def coarsen_mesh(mesh: StructuredMesh, axes=(0, 1, 2)) -> StructuredMesh:
    f = [2 if (a in axes and mesh.shape[a] % 2 == 0 and mesh.shape[a] > 1)
         else 1 for a in range(3)]
    return StructuredMesh(mesh.nx // f[0], mesh.ny // f[1], mesh.nz // f[2],
                          mesh.dx * f[0], mesh.dy * f[1], mesh.dz * f[2],
                          mesh.x0, mesh.y0, mesh.z0, device=mesh.device)


def refine_field(f: torch.Tensor, axes=(0, 1, 2)) -> torch.Tensor:
    """Conservative prolongation: each refined cell inherits the parent
    value (exactly conservative for intensive fields on factor-2
    refinement). `axes` index the tensor's own dimensions."""
    for ax in axes:
        if f.shape[ax] > 1:
            f = torch.repeat_interleave(f, 2, dim=ax)
    return f


def coarsen_field(f: torch.Tensor, axes=(0, 1, 2), weights=None) -> torch.Tensor:
    """Conservative restriction: mean over 2^d children (mass-weighted if
    weights are given)."""
    if weights is not None:
        num = coarsen_field(f * weights, axes)
        den = coarsen_field(weights, axes)
        return num / den
    for ax in axes:
        n = f.shape[ax]
        if n > 1 and n % 2 == 0:
            sh = list(f.shape)
            sh[ax] = n // 2
            sh.insert(ax + 1, 2)
            f = f.reshape(sh).mean(dim=ax + 1)
    return f


@dataclasses.dataclass
class AdaptiveResolution:
    """Between-step adaptation driver (dfDynamicRefineFvMesh::update:
    refineInterval, maxCells, criteria).

    Call maybe_adapt(mesh, fields, bcs) every refine_interval steps; it
    returns (new_mesh, "refine" | "coarsen" | None). The caller rebuilds the
    solver for the new mesh and maps the state with refine_field /
    coarsen_field."""
    criteria: RefinementCriteria
    refine_interval: int = 10
    max_cells: int = 4_000_000
    refine_above: float = 0.02    # marked fraction that triggers refinement
    coarsen_below: float = 0.002
    level: int = 0
    max_level: int = 2

    def maybe_adapt(self, mesh: StructuredMesh, fields: dict, bcs) -> tuple:
        mark = mark_cells(self.criteria, fields, bcs, mesh)
        frac = float(mark.mean())
        if (frac > self.refine_above and self.level < self.max_level
                and mesh.n_cells * 8 <= self.max_cells):
            self.level += 1
            return refine_mesh(mesh), "refine"
        if frac < self.coarsen_below and self.level > 0:
            self.level -= 1
            return coarsen_mesh(mesh), "coarsen"
        return mesh, None
