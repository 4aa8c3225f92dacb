"""Liquid fuel properties for spray parcels.

Port of deepflame_tpu/lagrangian/liquids.py (the reference's
liquidProperties role): NSRDS-style temperature correlations for the
evaporation and heat-transfer sub-models (Antoine vapour pressure, Watson
latent heat, linear density and heat-capacity fits, Andrade viscosity).
The constants are the JAX package's, digit for digit. Each correlation takes
a tensor, or a number (evaluated as a float64 tensor where it clips, as a
number otherwise).
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["Liquid", "ethanol", "n_heptane", "n_dodecane", "water"]


def _clip(T, lo, hi):
    if not isinstance(T, torch.Tensor):
        T = torch.as_tensor(T, dtype=torch.float64)
    return torch.clamp(T, lo, hi)


def _t(x):
    return x if isinstance(x, torch.Tensor) \
        else torch.as_tensor(x, dtype=torch.float64)


@dataclasses.dataclass(frozen=True)
class Liquid:
    name: str
    W: float                 # kg/kmol
    T_crit: float            # K
    T_boil: float            # K at 1 atm
    rho_ref: float           # kg/m^3 at T_ref
    rho_slope: float         # d rho/dT
    T_ref: float
    cp_ref: float            # J/kg/K
    cp_slope: float
    L_ref: float             # latent heat at T_boil [J/kg]
    antoine_A: float         # log10(p_sat[Pa]) = A - B/(T + C)
    antoine_B: float
    antoine_C: float
    sigma: float = 0.02      # surface tension [N/m]
    mu_ref: float = 5e-4     # liquid viscosity at T_ref [Pa s]
    mu_B: float = 1000.0     # Andrade exponent: mu = mu_ref exp(B(1/T-1/Tref))
    D_ref: float = 7.0e-6    # vapour-in-air diffusivity at 300 K, 1 atm
    cp_vap_ref: float = 1600.0  # vapour heat capacity at 300 K [J/kg/K]
    cp_vap_slope: float = 2.0   # d cp_vap/dT

    def rho(self, T):
        return self.rho_ref + self.rho_slope * (T - self.T_ref)

    def mu(self, T):
        """Liquid dynamic viscosity (Andrade correlation)."""
        T = _clip(T, 200.0, self.T_crit - 1.0)
        return self.mu_ref * torch.exp(self.mu_B * (1.0 / T - 1.0 / self.T_ref))

    def cp(self, T):
        return self.cp_ref + self.cp_slope * (T - self.T_ref)

    def p_sat(self, T):
        """Saturation vapour pressure [Pa] (Antoine, clipped at critical)."""
        T = _clip(T, 200.0, self.T_crit - 1.0)
        return 10.0 ** (self.antoine_A - self.antoine_B / (T + self.antoine_C))

    def T_boil_at(self, p):
        """Boiling temperature at the local pressure (Antoine inverted):
        the boiling switch uses the chamber pressure. Above the critical
        pressure there is no boiling: T_crit - 1."""
        logp = torch.log10(torch.clamp(_t(p), min=1.0))
        Tb = self.antoine_B / torch.clamp(self.antoine_A - logp, min=1e-3) \
            - self.antoine_C
        return torch.clamp(Tb, 200.0, self.T_crit - 1.0)

    def D_vap(self, T, p):
        """Vapour-in-air binary diffusivity [m^2/s]: T^1.75 and 1/p scaling
        of the 300 K, 1 atm value."""
        return self.D_ref * (torch.clamp(_t(T), min=200.0) / 300.0) ** 1.75 \
            * (1.01325e5 / torch.clamp(_t(p), min=1e3))

    def cp_vap(self, T):
        """Vapour-phase heat capacity [J/kg/K]."""
        return self.cp_vap_ref + self.cp_vap_slope * (_clip(T, 250.0, 2000.0)
                                                      - 300.0)

    def latent_heat(self, T):
        """Watson correlation scaled from the boiling point."""
        Tr = _clip(T, 200.0, self.T_crit - 1.0) / self.T_crit
        Trb = self.T_boil / self.T_crit
        return self.L_ref * ((1.0 - Tr) / (1.0 - Trb)) ** 0.38


def n_heptane() -> Liquid:
    return Liquid(name="C7H16", W=100.204, T_crit=540.2, T_boil=371.55,
                  rho_ref=679.5, rho_slope=-0.85, T_ref=300.0,
                  cp_ref=2242.0, cp_slope=5.0, L_ref=3.18e5,
                  antoine_A=9.2535, antoine_B=1268.636, antoine_C=-56.199,
                  mu_ref=3.9e-4, mu_B=900.0, D_ref=7.1e-6,
                  cp_vap_ref=1660.0, cp_vap_slope=2.6)


def n_dodecane() -> Liquid:
    return Liquid(name="C12H26", W=170.33, T_crit=658.0, T_boil=489.3,
                  rho_ref=745.0, rho_slope=-0.75, T_ref=300.0,
                  cp_ref=2210.0, cp_slope=4.5, L_ref=2.56e5,
                  antoine_A=9.328, antoine_B=1625.9, antoine_C=-92.8,
                  mu_ref=1.34e-3, mu_B=1500.0, D_ref=5.5e-6,
                  cp_vap_ref=1590.0, cp_vap_slope=2.6)


def ethanol() -> Liquid:
    return Liquid(name="C2H5OH", W=46.069, T_crit=513.9, T_boil=351.44,
                  rho_ref=789.0, rho_slope=-0.90, T_ref=300.0,
                  cp_ref=2440.0, cp_slope=6.0, L_ref=8.46e5,
                  antoine_A=10.247, antoine_B=1599.0, antoine_C=-46.4,
                  sigma=0.022, mu_ref=1.07e-3, mu_B=1600.0, D_ref=1.35e-5,
                  cp_vap_ref=1420.0, cp_vap_slope=1.9)


def water() -> Liquid:
    return Liquid(name="H2O", W=18.015, T_crit=647.1, T_boil=373.15,
                  rho_ref=997.0, rho_slope=-0.35, T_ref=300.0,
                  cp_ref=4184.0, cp_slope=0.5, L_ref=2.257e6,
                  antoine_A=10.196, antoine_B=1730.63, antoine_C=-39.72,
                  sigma=0.072, mu_ref=8.5e-4, mu_B=2100.0, D_ref=2.6e-5,
                  cp_vap_ref=1864.0, cp_vap_slope=0.55)
