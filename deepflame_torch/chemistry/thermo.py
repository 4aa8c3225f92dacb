"""NASA-7 thermodynamics: cp/h/s, mixture properties, Newton T(h).

Port of deepflame_tpu/chemistry/thermo.py. All functions are shape-agnostic:
`T` may be a scalar tensor or any batch shape (...,), `Y` is (..., ns).
The Newton inversions launch one CUDA kernel (`ops.kernels.thermo7`) for
CUDA tensors and run their plain versions (`T_from_h_plain`,
`T_from_e_plain`) on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..constants import GAS_CONSTANT
from ..device import resolve_device
from ..ops import kernels
from ..runtime.timers import count
from .mechanism import Mechanism

__all__ = ["ThermoData", "make_thermo"]

T_STD = 298.15


@dataclasses.dataclass(frozen=True)
class ThermoData:
    """NASA-7 tables on one device, in one dtype."""
    W: torch.Tensor            # (ns,) kg/kmol
    inv_W: torch.Tensor        # (ns,)
    T_mid: torch.Tensor        # (ns,)
    coeffs_low: torch.Tensor   # (ns, 7)
    coeffs_high: torch.Tensor  # (ns, 7)
    h_formation: torch.Tensor  # (ns,) J/kg at 298.15 K (mass basis)
    T_min: float
    T_max: float

    # ---- per-species molar (nondimensional) properties ----
    def _select(self, T):
        """Piecewise NASA-7 coefficient selection: (..., ns, 7)."""
        Tb = T[..., None, None]
        return torch.where(Tb < self.T_mid[:, None], self.coeffs_low,
                           self.coeffs_high)

    def cp_R(self, T):
        a = self._select(T)
        t = T[..., None]
        return a[..., 0] + t * (a[..., 1] + t * (a[..., 2] + t * (a[..., 3] + t * a[..., 4])))

    def h_RT(self, T):
        """(..., ns): h_i / (R T), absolute enthalpy incl. formation."""
        a = self._select(T)
        t = T[..., None]
        return (a[..., 0] + t * (a[..., 1] / 2 + t * (a[..., 2] / 3 + t * (a[..., 3] / 4 + t * a[..., 4] / 5)))
                + a[..., 5] / t)

    def s_R(self, T):
        a = self._select(T)
        t = T[..., None]
        return (a[..., 0] * torch.log(t) + t * (a[..., 1] + t * (a[..., 2] / 2 + t * (a[..., 3] / 3 + t * a[..., 4] / 4)))
                + a[..., 6])

    def g_RT(self, T):
        """(..., ns): standard-state Gibbs g_i/(R T) = h/RT - s/R."""
        a = self._select(T)
        t = T[..., None]
        h = (a[..., 0] + t * (a[..., 1] / 2 + t * (a[..., 2] / 3 + t * (a[..., 3] / 4 + t * a[..., 4] / 5)))
             + a[..., 5] / t)
        s = (a[..., 0] * torch.log(t) + t * (a[..., 1] + t * (a[..., 2] / 2 + t * (a[..., 3] / 3 + t * a[..., 4] / 4)))
             + a[..., 6])
        return h - s

    # ---- species mass-basis properties [J/kg] ----
    def h_species(self, T):
        return self.h_RT(T) * (GAS_CONSTANT * T[..., None]) * self.inv_W

    def cp_species(self, T):
        return self.cp_R(T) * GAS_CONSTANT * self.inv_W

    # ---- mixture properties ----
    def W_mix(self, Y):
        return 1.0 / (Y * self.inv_W).sum(-1)

    def mole_fractions(self, Y):
        x = Y * self.inv_W
        return x / x.sum(-1, keepdim=True)

    def cp_mass(self, T, Y):
        return (Y * self.cp_species(T)).sum(-1)

    def cv_mass(self, T, Y):
        return self.cp_mass(T, Y) - GAS_CONSTANT / self.W_mix(Y)

    def h_mass(self, T, Y):
        """Absolute (chemical + sensible) enthalpy [J/kg]."""
        return (Y * self.h_species(T)).sum(-1)

    def e_mass(self, T, Y):
        """Absolute internal energy [J/kg]: e = h - R T / W."""
        return self.h_mass(T, Y) - GAS_CONSTANT * T / self.W_mix(Y)

    def hs_mass(self, T, Y):
        """Sensible enthalpy [J/kg]."""
        return self.h_mass(T, Y) - (Y * self.h_formation).sum(-1)

    def psi(self, T, Y):
        """Compressibility psi = rho/p = W/(R T) [s^2/m^2]."""
        return self.W_mix(Y) / (GAS_CONSTANT * T)

    def rho(self, p, T, Y):
        return p * self.psi(T, Y)

    def gamma(self, T, Y):
        cp = self.cp_mass(T, Y)
        return cp / (cp - GAS_CONSTANT / self.W_mix(Y))

    def sound_speed(self, T, Y):
        return torch.sqrt(self.gamma(T, Y) / self.psi(T, Y))

    # ---- inverse property solves (Newton, fixed iteration count) ----
    def T_from_h(self, h, Y, T_guess, iters: int = 8):
        """Temperature from absolute enthalpy: 8 Newton steps from the
        previous temperature (quadratic convergence, cp > 0). One kernel
        launch for CUDA tensors, the plain version on the CPU."""
        if h.is_cuda:
            return self._newton_kernel(h, Y, T_guess, iters, False, False)
        count("thermo.newton_plain")
        return self.T_from_h_plain(h, Y, T_guess, iters)

    def T_from_e(self, e, Y, T_guess, iters: int = 8):
        """Temperature from absolute internal energy (Newton on cv). One
        kernel launch for CUDA tensors, the plain version on the CPU."""
        if e.is_cuda:
            return self._newton_kernel(e, Y, T_guess, iters, True, False)
        count("thermo.newton_plain")
        return self.T_from_e_plain(e, Y, T_guess, iters)

    def T_psi_from_h(self, h, Y, T_guess, iters: int = 8):
        """(T, psi): correctThermo, `T_from_h` then `psi`; one kernel launch
        for CUDA tensors."""
        if h.is_cuda:
            return self._newton_kernel(h, Y, T_guess, iters, False, True)
        T = self.T_from_h(h, Y, T_guess, iters)
        return T, self.psi(T, Y)

    def T_from_h_plain(self, h, Y, T_guess, iters: int = 8):
        """Plain version of `T_from_h` (the JAX package's arithmetic)."""
        T = torch.clamp(T_guess, self.T_min, self.T_max)
        for _ in range(iters):
            f = self.h_mass(T, Y) - h
            T = torch.clamp(T - f / self.cp_mass(T, Y), self.T_min, self.T_max)
        return T

    def T_from_e_plain(self, e, Y, T_guess, iters: int = 8):
        """Plain version of `T_from_e`."""
        T = torch.clamp(T_guess, self.T_min, self.T_max)
        for _ in range(iters):
            f = self.e_mass(T, Y) - e
            T = torch.clamp(T - f / self.cv_mass(T, Y), self.T_min, self.T_max)
        return T

    @functools.cached_property
    def kernel_table(self) -> torch.Tensor:
        """(ns, 20) in the tables' dtype and device, the layout
        csrc/thermo7.cu reads: T_mid, 1/W, then for the low and the high
        range a0..a4, a1/2, a2/3, a3/4, a5 (the quotients as the plain
        Horner forms take them). Made once per ThermoData."""
        def part(a):
            return torch.stack([a[:, 0], a[:, 1], a[:, 2], a[:, 3], a[:, 4],
                                a[:, 1] / 2, a[:, 2] / 3, a[:, 3] / 4,
                                a[:, 5]], 1)
        return torch.cat([self.T_mid[:, None], self.inv_W[:, None],
                          part(self.coeffs_low), part(self.coeffs_high)],
                         1).contiguous()

    def _newton_kernel(self, value, Y, T_guess, iters, energy, psi):
        count("thermo.newton_kernel")
        return kernels.thermo7(value, Y, T_guess, self.kernel_table,
                               self.T_min, self.T_max, GAS_CONSTANT, iters,
                               energy=energy, psi=psi)


def make_thermo(mech: Mechanism, dtype=torch.float64, device=None) -> ThermoData:
    """Thermo tables on `device` (default: the mechanism's device)."""
    device = resolve_device(mech.device if device is None else device)
    W = np.asarray(mech.molecular_weights)
    # formation enthalpy at 298.15 K (mass basis), host-side in float64
    a = np.where((T_STD < mech.nasa_T_mid)[:, None], mech.nasa_low, mech.nasa_high)
    t = T_STD
    h_RT = (a[:, 0] + t * (a[:, 1] / 2 + t * (a[:, 2] / 3 + t * (a[:, 3] / 4 + t * a[:, 4] / 5)))
            + a[:, 5] / t)
    h_form = h_RT * GAS_CONSTANT * T_STD / W
    f = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                                  device=device)
    return ThermoData(
        W=f(W), inv_W=f(1.0 / W), T_mid=f(mech.nasa_T_mid),
        coeffs_low=f(mech.nasa_low), coeffs_high=f(mech.nasa_high),
        h_formation=f(h_form),
        T_min=float(max(np.min(mech.nasa_T_low), 100.0)),
        T_max=float(np.max(mech.nasa_T_high)),
    )
