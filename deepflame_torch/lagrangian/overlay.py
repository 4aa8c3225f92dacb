"""Lagrangian spray on general (face-list) meshes through a background
overlay grid.

Port of deepflame_tpu/lagrangian/overlay.py. Parcels are located in a
uniform overlay grid over the general mesh's bounding box (a floor-divide,
no face walking); each overlay cell maps, once on the host, to the general
mesh cell of the nearest centre (scipy's cKDTree). The cloud is the
unchanged SprayCloud on the overlay's StructuredMesh: the gas fields are
gathered from the general mesh onto the overlay, and the cloud's per-volume
sources are reduced back exactly, weighted by the overlay cell volume and
divided by the mesh cell's (each overlay cell maps to one mesh cell, so the
integrals are kept). The reduction is index_add_, atomic on the card, so
its sums may round in another order from run to run.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..mesh.structured import StructuredMesh
from .cloud import CloudSources, SprayCloud

__all__ = ["OverlaySprayCloud", "make_overlay"]


def make_overlay(centers, volumes, resolution=(128, 1, 256), bounds=None,
                 device=None):
    """(overlay StructuredMesh on `device` (default: the CUDA card), cell
    map (resolution) int32 numpy: overlay cell -> nearest general-mesh
    cell). centers (n, 3), volumes (n,): the general mesh's. Without
    `bounds` ((lo, hi) corners) the box is the centres' extent padded 2 %;
    an axis of one overlay cell on which the centres lie flat (a 2D or
    wedge mesh) gets a thickness of a fifth of the largest extent. Host
    numpy, once at set-up."""
    from scipy.spatial import cKDTree
    ctr = np.asarray(centers, np.float64)
    if bounds is None:
        lo = ctr.min(axis=0)
        hi = ctr.max(axis=0)
        pad = 0.02 * (hi - lo + 1e-300)
        lo, hi = lo - pad, hi + pad
    else:
        lo, hi = (np.array(b, np.float64) for b in bounds)
    res = tuple(int(r) for r in resolution)
    ext = np.maximum(hi - lo, 1e-12)
    floor = 0.2 * ext.max()
    for a in range(3):
        if ext[a] < floor and res[a] == 1:
            mid = 0.5 * (lo[a] + hi[a])
            lo[a], hi[a] = mid - 0.5 * floor, mid + 0.5 * floor
            ext[a] = floor
    overlay = StructuredMesh.box(ext.tolist(), list(res), origin=lo.tolist(),
                                 device=device)
    axes = [lo[a] + (np.arange(res[a]) + 0.5) * ext[a] / res[a]
            for a in range(3)]
    OX, OY, OZ = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([OX.ravel(), OY.ravel(), OZ.ravel()], axis=1)
    _, idx = cKDTree(ctr).query(pts)
    return overlay, idx.reshape(res).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class OverlaySprayCloud:
    """SprayCloud adapter for general meshes. cloud: a SprayCloud whose mesh
    is the overlay grid; cell_map (overlay shape) int64: overlay cell ->
    general-mesh cell; volumes (n,): the general mesh's cell volumes."""
    cloud: SprayCloud
    cell_map: Any
    volumes: Any
    n_cells: int

    @classmethod
    def build(cls, centers, volumes, spray_kwargs: dict,
              resolution=(128, 1, 256), bounds=None, device=None):
        """The overlay of make_overlay and a SprayCloud on it (spray_kwargs:
        SprayCloud's other fields), on `device` (default: the card)."""
        overlay, cell_map = make_overlay(centers, volumes, resolution, bounds,
                                         device=device)
        dev = overlay.device
        vol = torch.as_tensor(np.asarray(volumes), device=dev)
        return cls(cloud=SprayCloud(mesh=overlay, **spray_kwargs),
                   cell_map=torch.as_tensor(cell_map, dtype=torch.long,
                                            device=dev),
                   volumes=vol, n_cells=int(vol.shape[0]))

    def init(self, generator=None, dtype=torch.float64):
        return self.cloud.init(generator, dtype)

    def evolve(self, c, gas_fl: dict, dt, time):
        """gas_fl: flat general-mesh fields (n,), U as (n, 3) or (3, n).
        Returns (cloud state, CloudSources of flat (n,) per-volume fields,
        SU (3, n))."""
        cm = self.cell_map
        dtype = c.d.dtype
        to_overlay = lambda f: torch.as_tensor(f, dtype=dtype)[cm]
        U = gas_fl["U"]
        U = U.T if U.dim() == 2 and U.shape[-1] == 3 else U   # -> (3, n)
        gas_over = {k: to_overlay(gas_fl[k]) for k in ("rho", "T", "p", "mu")}
        gas_over["U"] = torch.stack([to_overlay(U[a]) for a in range(3)])
        for opt in ("Yv", "k_turb", "cp", "kappa"):
            if opt in gas_fl:
                gas_over[opt] = to_overlay(gas_fl[opt])
        c_new, src = self.cloud.evolve(c, gas_over, dt, time)
        V_over = self.cloud.mesh.volume
        flat = cm.reshape(-1)

        def reduce_(f_over):
            tot = torch.zeros(self.n_cells, dtype=f_over.dtype,
                              device=f_over.device).index_add_(
                0, flat, f_over.reshape(-1) * V_over)
            return tot / self.volumes.to(f_over.dtype)

        return c_new, CloudSources(
            Srho=reduce_(src.Srho), SU=torch.stack([reduce_(src.SU[a])
                                                    for a in range(3)]),
            Sh=reduce_(src.Sh), SY=reduce_(src.SY))

    def stats(self, c):
        return self.cloud.stats(c)
