"""Wall liquid film (the reference's surfaceFilmModels role).

Port of deepflame_tpu/lagrangian/film.py: a fixed-shape 2D structure of
arrays on one wall face of the structured mesh (mass and tangential momentum
per area, temperature) inside the cloud state. It absorbs impinging parcels
(scatter-adds), heats by gas-side convection, evaporates with a Spalding
driving force capped by boiling (mass and energy returned to the
wall-adjacent gas cells) and relaxes its momentum by wall friction.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

__all__ = ["WallFilmState", "WallFilm"]


class WallFilmState(NamedTuple):
    m: torch.Tensor      # (n1, n2) film mass per area [kg/m^2]
    mom: torch.Tensor    # (2, n1, n2) tangential momentum per area
    T: torch.Tensor      # (n1, n2) film temperature [K]
    m_evap: torch.Tensor  # 0-d: cumulative evaporated film mass [kg]


@dataclasses.dataclass(frozen=True)
class WallFilm:
    """One wall patch's film: the boundary face `axis` (0-2), `side` (0 low,
    1 high) of the structured mesh; the arrays span its tangential axes."""
    axis: int
    side: int
    tau_wall: float = 1e-3    # wall-friction momentum relaxation time [s]
    Sc_gas: float = 0.7
    Pr_gas: float = 0.7
    W_gas: float = 28.9

    def tangential_axes(self):
        return tuple(a for a in range(3) if a != self.axis)

    def init(self, mesh, dtype) -> WallFilmState:
        t1, t2 = self.tangential_axes()
        shape = (mesh.shape[t1], mesh.shape[t2])
        z = torch.zeros(shape, dtype=dtype, device=mesh.device)
        return WallFilmState(m=z, mom=torch.zeros((2,) + shape, dtype=dtype,
                                                  device=mesh.device),
                             T=z + 300.0,
                             m_evap=torch.zeros((), dtype=dtype,
                                                device=mesh.device))

    def face_area(self, mesh):
        d = (mesh.dx, mesh.dy, mesh.dz)
        t1, t2 = self.tangential_axes()
        return d[t1] * d[t2]

    def absorb(self, f: WallFilmState, idx1, idx2, mass, mom_t,
               T_p) -> WallFilmState:
        """Deposit impinging parcels (scatter-adds): mass [kg/m^2], mom_t
        (2, K) per face area and T_p [K], weighted by the caller; the film
        temperature mixes mass-weighted."""
        idx = (idx1.long(), idx2.long())
        m_new = f.m.index_put(idx, mass, accumulate=True)
        mom_new = torch.stack([f.mom[a].index_put(idx, mom_t[a],
                                                  accumulate=True)
                               for a in range(2)])
        mT_new = (f.m * f.T).index_put(idx, mass * T_p, accumulate=True)
        T_new = torch.where(m_new > 1e-14,
                            mT_new / torch.clamp(m_new, min=1e-14), f.T)
        return WallFilmState(m=m_new, mom=mom_new, T=T_new, m_evap=f.m_evap)

    def evolve(self, f: WallFilmState, gas_wall: dict, liquid, dt,
               face_area=1.0):
        """One film substep against the wall-adjacent gas layer. gas_wall:
        2D fields at the first interior cell (rho, T, mu, p, optionally Yv)
        and dn, the wall-normal cell size. Returns (state, per-area gas
        sources {Srho, Sh, SY} [kg/m^2/s, W/m^2]; divide by dn)."""
        rho_g = gas_wall["rho"]
        T_g = gas_wall["T"]
        mu_g = gas_wall["mu"]
        p_g = gas_wall["p"]
        Yv_g = gas_wall.get("Yv", torch.zeros_like(rho_g))
        dn = gas_wall["dn"]

        has_film = f.m > 1e-12
        # gas-side convective transfer across the half-cell
        cp_g = 1005.0
        kappa_g = mu_g * cp_g / self.Pr_gas
        h_conv = kappa_g / (0.5 * dn)
        cp_l = liquid.cp(f.T)
        # implicit temperature relaxation toward the gas T
        tau_T = torch.clamp(f.m * cp_l / torch.clamp(h_conv, min=1e-20),
                            min=1e-9)
        T_new = T_g + (f.T - T_g) * torch.exp(-dt / tau_T)
        T_new = torch.where(has_film,
                            torch.clamp(T_new, 250.0, liquid.T_crit - 1.0),
                            f.T)

        # evaporation: Spalding mass transfer, boiling heat-limited
        D_v = mu_g / (rho_g * self.Sc_gas)
        h_m = D_v / (0.5 * dn)
        p_sat = liquid.p_sat(T_new)
        x_s = torch.clamp(p_sat / torch.clamp(p_g, min=1.0), 0.0, 0.999)
        Y_s = x_s * liquid.W / (x_s * liquid.W + (1.0 - x_s) * self.W_gas)
        B_M = torch.clamp((Y_s - Yv_g) / torch.clamp(1.0 - Y_s, min=1e-3),
                          0.0, 20.0)
        flux = rho_g * h_m * torch.log1p(B_M)
        L = liquid.latent_heat(T_new)
        flux_boil = h_conv * torch.clamp(T_g - T_new, min=0.0) / L
        flux = torch.where(T_new > liquid.T_boil,
                           torch.maximum(flux, flux_boil), flux)
        dm = torch.where(has_film, torch.minimum(flux * dt, f.m),
                         torch.zeros_like(flux))
        m_new = f.m - dm

        # wall friction: tangential momentum decay
        mom_new = f.mom * torch.exp(torch.as_tensor(-dt / self.tau_wall,
                                                    dtype=f.mom.dtype))
        mom_new = torch.where(m_new[None] > 1e-14, mom_new,
                              torch.zeros_like(mom_new))

        # sensible heat the film took while relaxing toward the gas T
        q_conv = f.m * cp_l * (T_new - f.T) / dt
        src = {"Srho": dm / dt, "SY": dm / dt,
               "Sh": -(dm / dt) * L - q_conv}
        f_new = WallFilmState(m=m_new, mom=mom_new, T=T_new,
                              m_evap=f.m_evap + dm.sum() * face_area)
        return f_new, src
