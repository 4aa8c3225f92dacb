"""High-Re wall functions for the RAS models (structured-mesh walls).

Port of deepflame_tpu/turbulence/wall_functions.py (OpenFOAM's nutk,
kqR, epsilon and omega wall functions). Walls are whole boundary planes of
the structured box, so each wall function is a masked correction of the
wall-adjacent cell layer:

  - nutk:     nu_t|w = nu (y* kappa / ln(E y*) - 1)   for y* > y*_lam
  - epsilon:  eps|w = Cmu^(3/4) k^(3/2) / (kappa y)
              G|w   = (nu_t+nu) |U_t|/y * Cmu^(1/4) sqrt(k) / (kappa y)
  - omega:    omega|w = sqrt(omega_vis^2 + omega_log^2)
  - kqR:      zero-gradient k at the wall (the default scalar wall BC).

Walls are (axis, side) pairs as in turbulence.ras.wall_distance.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..mesh.structured import StructuredMesh

__all__ = ["WallFunctions"]


@dataclasses.dataclass(frozen=True)
class WallFunctions:
    """Masked wall-layer corrections for (axis, side) wall planes; the
    tensors live on the mesh's device."""
    walls: tuple                 # ((axis, side), ...)
    mask: Any                    # 1.0 on wall-adjacent cells
    y: Any                       # distance to the owning wall (1e10 elsewhere)
    axis_field: Any              # wall-normal axis per cell (int32)
    kappa: float = 0.41
    E: float = 9.8
    Cmu: float = 0.09

    @staticmethod
    def for_walls(mesh: StructuredMesh, walls, dtype=torch.float32):
        """Masks of the wall-adjacent cell layers of the given planes, built
        on the host and placed on the mesh's device."""
        shape = mesh.shape
        mask = np.zeros(shape, bool)
        y = np.full(shape, 1e10)
        ax_f = np.zeros(shape, np.int32)
        for (ax, side) in walls:
            sl = [slice(None)] * 3
            sl[ax] = 0 if side == 0 else shape[ax] - 1
            half = 0.5 * mesh.spacing[ax]
            region = tuple(sl)
            closer = y[region] > half
            mask[region] = True
            y[region] = np.where(closer, half, y[region])
            ax_f[region] = np.where(closer, ax, ax_f[region])
        dev = mesh.device
        return WallFunctions(
            walls=tuple(walls),
            mask=torch.as_tensor(mask.astype(float), dtype=dtype, device=dev),
            y=torch.as_tensor(y, dtype=dtype, device=dev),
            axis_field=torch.as_tensor(ax_f, device=dev))

    @property
    def yplus_lam(self) -> float:
        """Intersection of the linear and log laws (OpenFOAM yPlusLam), a
        fixed point iterated on the host in float64."""
        yl = 11.0
        for _ in range(10):
            yl = math.log(max(self.E * yl, 1.0)) / self.kappa
        return yl

    def ystar(self, rho, k, mu):
        """y* = Cmu^(1/4) sqrt(k) y rho / mu (k-based wall unit)."""
        return (self.Cmu ** 0.25 * torch.sqrt(torch.clamp(k, min=1e-12))
                * self.y * rho / mu)

    def nut(self, rho, k, mu):
        """nutkWallFunction value on wall cells (0 off the mask and in the
        viscous sublayer)."""
        ys = self.ystar(rho, k, mu)
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

    def omega(self, rho, k, mu, beta1=0.075):
        """omegaWallFunction blended value in wall cells."""
        nu = mu / rho
        w_vis = 6.0 * nu / (beta1 * self.y ** 2)
        w_log = torch.sqrt(torch.clamp(k, min=1e-12)) \
            / (self.Cmu ** 0.25 * self.kappa * self.y)
        return torch.sqrt(w_vis ** 2 + w_log ** 2)

    def production(self, rho, k, mu, mu_t, U, bcs_U, mesh: StructuredMesh):
        """Wall-cell production G: (nut+nu) |U_t|/y times the log-layer
        velocity-gradient scale Cmu^(1/4) sqrt(k)/(kappa y)."""
        # |U_t|: |U| without the wall-normal component of each cell
        Un2 = 0.0
        for ax in range(3):
            Un2 = Un2 + torch.where(self.axis_field == ax, U[ax] ** 2,
                                    torch.zeros_like(U[ax]))
        Ut = torch.sqrt(torch.clamp(sum(U[a] ** 2 for a in range(3)) - Un2,
                                    min=0.0))
        snGradU = Ut / self.y
        return ((mu_t + mu) / rho * snGradU
                * self.Cmu ** 0.25 * torch.sqrt(torch.clamp(k, min=1e-12))
                / (self.kappa * self.y) * rho)

    def apply_mask(self, wall_value, field):
        """field with the wall cells replaced by wall_value."""
        return torch.where(self.mask > 0, wall_value, field)
