"""Real-gas (Peng-Robinson) equation of state for supercritical cases.

Port of deepflame_tpu/chemistry/real_gas.py. `RealGasThermo` wraps the
ideal-gas ThermoData: caloric properties (h, cp, T(h)) stay NASA-7, with
the PR enthalpy departure available separately, while rho (and psi when p
is given) come from the PR cubic with van-der-Waals mixing rules. Critical
properties of common combustion species are tabulated; unknown species fall
back to ideal gas (a = b = 0).

PyTorch has no cube root: `_cbrt` takes sign(x) |x|^(1/3), within a few
units in the last place of a correctly rounded cube root (tests hold the
Cardano branch against the JAX package's `jnp.cbrt` to 1e-13 relative in
float64).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..constants import GAS_CONSTANT
from .mechanism import Mechanism
from .thermo import ThermoData

__all__ = ["RealGasThermo", "make_real_gas", "CRITICAL_PROPERTIES"]

# Tc [K], pc [Pa], acentric factor omega (public property data)
CRITICAL_PROPERTIES = {
    "H2": (33.2, 1.297e6, -0.216),
    "O2": (154.6, 5.043e6, 0.022),
    "N2": (126.2, 3.396e6, 0.037),
    "H2O": (647.1, 22.064e6, 0.344),
    "CO2": (304.1, 7.377e6, 0.225),
    "CO": (132.9, 3.499e6, 0.048),
    "CH4": (190.6, 4.599e6, 0.011),
    "C2H6": (305.3, 4.872e6, 0.099),
    "C2H4": (282.3, 5.041e6, 0.087),
    "C3H8": (369.8, 4.248e6, 0.152),
    "C7H16": (540.2, 2.74e6, 0.349),
    "C12H26": (658.0, 1.82e6, 0.576),
    "AR": (150.9, 4.898e6, -0.002),
    "HE": (5.19, 0.227e6, -0.390),
    "OH": (0.0, 0.0, 0.0),   # radicals: ideal
}

_SQRT2 = math.sqrt(2.0)


@dataclasses.dataclass(frozen=True)
class RealGasThermo:
    """Duck-typed ThermoData with PR volumetric behaviour."""
    ideal: ThermoData
    a_c: torch.Tensor        # (ns,) critical attraction [Pa m^6/kmol^2]
    b_i: torch.Tensor        # (ns,) covolume [m^3/kmol]
    kappa: torch.Tensor      # (ns,) alpha(T) slope parameter
    Tc: torch.Tensor         # (ns,)

    # caloric properties delegate to the ideal-gas NASA-7 tables
    def __getattr__(self, name):
        if name == "ideal":     # not set yet (copy, unpickling)
            raise AttributeError(name)
        return getattr(self.ideal, name)

    def _mix_ab(self, T, Y, with_dadT: bool = False):
        """van-der-Waals mixing rules on a mole basis (and d a/dT)."""
        X = self.ideal.mole_fractions(Y)
        Tr = T[..., None] / torch.clamp(self.Tc, min=1e-3)
        sqrt_Tr = torch.sqrt(torch.clamp(Tr, min=1e-8))
        alpha_sqrt = 1.0 + self.kappa * (1.0 - sqrt_Tr)
        ai = self.a_c * torch.where(self.Tc > 1.0, alpha_sqrt ** 2,
                                    torch.zeros_like(alpha_sqrt))
        sq = torch.sqrt(torch.clamp(ai, min=0.0))
        S = (X * sq).sum(-1)
        a_mix = S ** 2
        b_mix = (X * self.b_i).sum(-1)
        if not with_dadT:
            return a_mix, b_mix
        # d sqrt(ai)/dT = sqrt(a_c) (-kappa / (2 sqrt(T Tc)))
        dsq = torch.where(
            self.Tc > 1.0,
            torch.sqrt(torch.clamp(self.a_c, min=0.0)) * (-self.kappa)
            / (2.0 * torch.sqrt(torch.clamp(T[..., None] * self.Tc,
                                            min=1e-8))),
            torch.zeros_like(alpha_sqrt))
        dSdT = (X * dsq).sum(-1)
        return a_mix, b_mix, 2.0 * S * dSdT

    def rho(self, p, T, Y):
        """Density from the PR cubic in Z, solved analytically (Cardano;
        the gas branch takes the largest real root)."""
        a, b = self._mix_ab(T, Y)
        R = GAS_CONSTANT
        W = self.ideal.W_mix(Y)
        A = a * p / (R * T) ** 2
        B = b * p / (R * T)
        # Z^3 + c2 Z^2 + c1 Z + c0 = 0
        c2 = -(1.0 - B)
        c1 = A - 3.0 * B * B - 2.0 * B
        c0 = -(A * B - B * B - B ** 3)
        Z = _largest_real_cubic_root(c2, c1, c0)
        Z = torch.maximum(Z, B * 1.0001 + 1e-12)
        v = Z * R * T / p
        return W / v

    def psi(self, T, Y, p=None):
        """Compressibility psi = (d rho/d p)_T: the exact PR derivative
        with p given, else (the ideal signature) the ideal-gas psi."""
        if p is None:
            return self.ideal.psi(T, Y)
        a, b = self._mix_ab(T, Y)
        W = self.ideal.W_mix(Y)
        v = W / self.rho(p, T, Y)          # molar volume at the state
        R = GAS_CONSTANT
        dpdv = (-R * T / (v - b) ** 2
                + a * (2.0 * v + 2.0 * b) / (v * v + 2.0 * b * v - b * b) ** 2)
        return -W / (v * v) / dpdv

    def Z(self, p, T, Y):
        """Compressibility factor p v/(R T)."""
        v = self.ideal.W_mix(Y) / self.rho(p, T, Y)
        return p * v / (GAS_CONSTANT * T)

    def h_departure(self, p, T, Y):
        """PR enthalpy departure [J/kg] (add to the ideal-gas NASA-7 h)."""
        a, b, dadT = self._mix_ab(T, Y, with_dadT=True)
        R = GAS_CONSTANT
        W = self.ideal.W_mix(Y)
        v = W / self.rho(p, T, Y)
        Zf = p * v / (R * T)
        B = b * p / (R * T)
        num = T * dadT - a
        log_term = torch.log(torch.clamp(
            (Zf + (1 + _SQRT2) * B)
            / torch.clamp(Zf + (1 - _SQRT2) * B, min=1e-12), min=1e-12))
        h_dep_molar = R * T * (Zf - 1.0) + num / (2.0 * _SQRT2 * b + 1e-300) \
            * log_term
        return h_dep_molar / W


def _cbrt(x):
    """Real cube root, sign(x) |x|^(1/3) (PyTorch has no cbrt)."""
    return torch.sign(x) * x.abs() ** (1.0 / 3.0)


def _largest_real_cubic_root(c2, c1, c0):
    """Largest real root of x^3 + c2 x^2 + c1 x + c0 (trigonometric Cardano;
    one- and three-real-root regimes). The floor of p is -1e-300 in the
    field's type, as in the JAX package: in float32 it rounds to -0.0."""
    p_ = c1 - c2 * c2 / 3.0
    q_ = 2.0 * c2 ** 3 / 27.0 - c2 * c1 / 3.0 + c0
    disc = (q_ / 2.0) ** 2 + (p_ / 3.0) ** 3
    tiny = torch.tensor(1e-300, dtype=p_.dtype, device=p_.device)
    # three real roots (disc <= 0): trigonometric form, largest root
    safe_p = torch.minimum(p_, -tiny)
    m = 2.0 * torch.sqrt(torch.maximum(-safe_p / 3.0, tiny))
    arg = torch.clamp(3.0 * q_ / (safe_p * m), -1.0, 1.0)
    theta = torch.arccos(arg) / 3.0
    x_tri = m * torch.cos(theta) - c2 / 3.0
    # one real root (disc > 0): Cardano with cube roots
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    u = _cbrt(-q_ / 2.0 + sq)
    w = _cbrt(-q_ / 2.0 - sq)
    x_single = u + w - c2 / 3.0
    return torch.where(disc > 0, x_single, x_tri)


def make_real_gas(mech: Mechanism, ideal: ThermoData,
                  dtype=torch.float64) -> RealGasThermo:
    """The PR tables of `mech`'s species, on the ideal tables' device."""
    ns = mech.n_species
    R = GAS_CONSTANT
    a_c = np.zeros(ns)
    b_i = np.zeros(ns)
    kap = np.zeros(ns)
    Tc_arr = np.zeros(ns)
    for i, name in enumerate(mech.species_names):
        Tc, pc, om = CRITICAL_PROPERTIES.get(name.upper(),
                                             CRITICAL_PROPERTIES.get(name,
                                                                     (0, 0, 0)))
        if Tc > 1.0 and pc > 0:
            a_c[i] = 0.45724 * R ** 2 * Tc ** 2 / pc
            b_i[i] = 0.07780 * R * Tc / pc
            kap[i] = 0.37464 + 1.54226 * om - 0.26992 * om * om
            Tc_arr[i] = Tc
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=ideal.W.device)
    return RealGasThermo(ideal=ideal, a_c=f(a_c), b_i=f(b_i), kappa=f(kap),
                         Tc=f(Tc_arr))
