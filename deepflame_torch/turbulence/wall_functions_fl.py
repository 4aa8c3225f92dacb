"""High-Re wall functions on the face-list backend.

Port of deepflame_tpu/turbulence/wall_functions_fl.py: nutkWallFunction,
epsilonWallFunction and the wall-layer production of kqRWallFunction (the
reference's RAS cases' wall patches) as masked corrections of the wall-
adjacent cells, built from a GeneralMesh's named wall patches: per wall cell
the distance y = n.(Cf - Co) to its nearest wall face and that face's unit
normal. The same formulation as turbulence/wall_functions.py.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["WallFunctionsFL", "make_wall_functions_fl"]


@dataclasses.dataclass(frozen=True)
class WallFunctionsFL:
    mask: torch.Tensor      # (n,) 1.0 on wall-adjacent cells
    y: torch.Tensor         # (n,) wall distance (large off the mask)
    n_wall: torch.Tensor    # (n, 3) unit normal of the nearest wall face
    kappa: float = 0.41
    E: float = 9.8
    Cmu: float = 0.09

    @property
    def yplus_lam(self) -> float:
        yl = 11.0
        for _ in range(10):
            yl = math.log(max(self.E * yl, 1.0)) / self.kappa
        return yl

    def nut(self, rho, k, mu):
        """nutkWallFunction kinematic eddy viscosity in wall cells."""
        ys = (self.Cmu ** 0.25 * torch.sqrt(torch.clamp(k, min=1e-12))
              * self.y * rho / mu)
        nut_log = mu / rho * (ys * self.kappa
                              / torch.log(torch.clamp(self.E * ys,
                                                      min=1.0 + 1e-6))
                              - 1.0)
        on = self.mask * (ys > self.yplus_lam)
        return torch.where(on > 0, torch.clamp(nut_log, min=0.0),
                           torch.zeros_like(nut_log))

    def epsilon(self, k):
        """epsilonWallFunction fixed value in wall cells."""
        return (self.Cmu ** 0.75 * torch.clamp(k, min=1e-12) ** 1.5
                / (self.kappa * self.y))

    def production(self, rho, k, mu, mu_t, U):
        """Wall-cell production G = (nut + nu) (|U_t|/y) Cmu^0.25 sqrt(k) /
        (kappa y) rho, U (n, 3) cell velocities."""
        Un = (U * self.n_wall).sum(1)
        Ut = torch.sqrt(torch.clamp((U * U).sum(1) - Un ** 2, min=0.0))
        return ((mu_t + mu) / rho * (Ut / self.y)
                * self.Cmu ** 0.25 * torch.sqrt(torch.clamp(k, min=1e-12))
                / (self.kappa * self.y) * rho)

    def apply(self, wall_value, field):
        return torch.where(self.mask > 0, wall_value, field)


def make_wall_functions_fl(gm, wall_patch_names, dtype=torch.float64,
                           device=None) -> WallFunctionsFL:
    """Wall masks from a GeneralMesh's named wall patches, on `device`
    (default: the CUDA card). A cell on several wall faces takes the
    nearest (the first of equal distance, in patch and face order)."""
    device = resolve_device(device)
    n = gm.n_cells
    mask = np.zeros(n)
    y = np.full(n, 1e10)
    n_wall = np.zeros((n, 3))
    for p in gm.patches:
        if p.name not in wall_patch_names:
            continue
        # owner centre to face: half the ghost spacing 2 n.(Cf - Co)
        d = (0.5 * np.asarray(p.delta)).tolist()
        normal = np.asarray(p.normal)
        for i, c in enumerate(np.asarray(p.owner).tolist()):
            if d[i] < y[c]:
                y[c] = d[i]
                n_wall[c] = normal[i]
            mask[c] = 1.0
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    return WallFunctionsFL(mask=f(mask), y=f(y), n_wall=f(n_wall))
