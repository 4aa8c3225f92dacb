"""Mass-action kinetics as dense batched matrix products.

Port of deepflame_tpu/chemistry/kinetics.py. For a batch of cells
    ln r_fwd = ln kf + ln c @ ORDER^T      (batch, ns) @ (ns, nr)
    wdot     = (r_f - r_r) @ (nu_rev - nu_fwd)
plus elementwise transcendentals for three-body and Troe falloff factors.

Float32 products on the card must stay in full float32: TF32 keeps about three
decimal digits, and ln r is exponentiated. `make_kinetics` therefore sets
`torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's default, set
explicitly so that no caller's setting changes the rates).

Maxima on the rate path use torch.maximum against a tensor, whose derivative
splits evenly at ties as jnp.maximum's does: the stiff integrator
differentiates this code (forward mode), and at Y_i = 0 the tie decides the
Jacobian entry.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..constants import GAS_CONSTANT, P_REF
from ..device import resolve_device
from .mechanism import Mechanism
from .thermo import ThermoData

__all__ = ["KineticsData", "make_kinetics", "production_rates",
           "mass_production_rates", "heat_release_rate"]

_LOG10 = 2.302585092994046


@dataclasses.dataclass(frozen=True)
class KineticsData:
    order_fwd_T: torch.Tensor   # (ns, nr) transposed forward orders
    nu_rev_T: torch.Tensor      # (ns, nr)
    d_nu: torch.Tensor          # (nr, ns) nu_rev - nu_fwd
    sum_d_nu: torch.Tensor      # (nr,)
    ln_A: torch.Tensor          # (nr,)
    beta: torch.Tensor
    EaR: torch.Tensor
    reversible: torch.Tensor
    is_three_body: torch.Tensor
    is_falloff: torch.Tensor
    eff_T: torch.Tensor         # (ns, nr) third-body efficiencies (transposed)
    ln_low_A: torch.Tensor
    low_beta: torch.Tensor
    low_EaR: torch.Tensor
    has_troe: torch.Tensor
    troe_A: torch.Tensor
    troe_T3: torch.Tensor
    troe_T1: torch.Tensor
    troe_T2: torch.Tensor
    troe_has_T2: torch.Tensor
    inv_W: torch.Tensor         # (ns,)
    W: torch.Tensor             # (ns,)


def make_kinetics(mech: Mechanism, dtype=torch.float64,
                  device=None) -> KineticsData:
    """Kinetics tables on `device` (default: the mechanism's device)."""
    device = resolve_device(mech.device if device is None else device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    f = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                                  device=device)
    with np.errstate(divide="ignore"):
        ln_A = np.where(mech.arr_A > 0, np.log(np.maximum(mech.arr_A, 1e-300)), -700.0)
        ln_low_A = np.where(mech.low_A > 0, np.log(np.maximum(mech.low_A, 1e-300)), -700.0)
    return KineticsData(
        order_fwd_T=f(mech.order_fwd.T), nu_rev_T=f(mech.nu_rev.T),
        d_nu=f(mech.nu_rev - mech.nu_fwd),
        sum_d_nu=f((mech.nu_rev - mech.nu_fwd).sum(axis=1)),
        ln_A=f(ln_A), beta=f(mech.arr_beta), EaR=f(mech.arr_EaR),
        reversible=f(mech.reversible),
        is_three_body=f(mech.is_three_body), is_falloff=f(mech.is_falloff),
        eff_T=f(mech.efficiencies.T),
        ln_low_A=f(ln_low_A), low_beta=f(mech.low_beta), low_EaR=f(mech.low_EaR),
        has_troe=f(mech.has_troe),
        troe_A=f(mech.troe[:, 0]), troe_T3=f(mech.troe[:, 1]),
        troe_T1=f(mech.troe[:, 2]), troe_T2=f(mech.troe[:, 3]),
        troe_has_T2=f(mech.troe_has_T2),
        inv_W=f(1.0 / mech.molecular_weights), W=f(mech.molecular_weights),
    )


@functools.lru_cache(maxsize=None)
def _const(v: float, dtype: torch.dtype, device: torch.device):
    return torch.full((), v, dtype=dtype, device=device)


def _max(x, v):
    """max(x, v) with the even split of the derivative at ties (the constant
    is made once per dtype and device, not copied to the card per call)."""
    return torch.maximum(x, _const(v, x.dtype, x.device))


def _floor(dtype):
    # a normal number in the working dtype: exp(order * ln(floor)) underflows
    # to an exact zero rate, and log(0) never reaches the order product
    return 1e-100 if dtype == torch.float64 else 1e-25


def _falloff_factor(kin: KineticsData, T, ln_k_inf, M):
    """Falloff blending factor Pr/(1+Pr) * F(Troe) per reaction (batched)."""
    ln_T = torch.log(T)[..., None]
    ln_k0 = kin.ln_low_A + kin.low_beta * ln_T - kin.low_EaR / T[..., None]
    ln_Pr = ln_k0 - ln_k_inf + torch.log(_max(M, _floor(T.dtype)))
    Pr = torch.exp(ln_Pr)
    Tb = T[..., None]
    safe = lambda x: _max(x, 1e-30)
    Fcent = ((1.0 - kin.troe_A) * torch.exp(-Tb / safe(kin.troe_T3))
             + kin.troe_A * torch.exp(-Tb / safe(kin.troe_T1))
             + kin.troe_has_T2 * torch.exp(-kin.troe_T2 / Tb))
    log_Fc = torch.log10(_max(Fcent, 1e-30))
    log_Pr = ln_Pr / _LOG10
    c = -0.4 - 0.67 * log_Fc
    n = 0.75 - 1.27 * log_Fc
    f1 = (log_Pr + c) / (n - 0.14 * (log_Pr + c))
    log_F_troe = log_Fc / (1.0 + f1 * f1)
    log_F = torch.where(kin.has_troe > 0, log_F_troe, torch.zeros_like(log_F_troe))
    F = torch.exp(_LOG10 * log_F)
    return (Pr / (1.0 + Pr)) * F


def production_rates(kin: KineticsData, thermo: ThermoData, T, rho, Y):
    """Net molar production rates wdot [kmol/m^3/s], shape (..., ns).
    T, rho: (...,); Y: (..., ns)."""
    c = rho[..., None] * Y * kin.inv_W                       # kmol/m^3
    c = _max(c, 0.0)
    ln_c = torch.log(_max(c, _floor(Y.dtype)))

    ln_T = torch.log(T)[..., None]
    inv_T = (1.0 / T)[..., None]
    ln_kf = kin.ln_A + kin.beta * ln_T - kin.EaR * inv_T      # (..., nr)

    M = c @ kin.eff_T                                         # third bodies
    fo = _falloff_factor(kin, T, ln_kf, M)
    one = torch.ones_like(M)
    factor = torch.where(kin.is_falloff > 0, fo,
                         torch.where(kin.is_three_body > 0, M, one))

    # equilibrium constants: ln Kc = -d_nu @ g/RT + sum(d_nu) ln(Pref/(R T))
    g = thermo.g_RT(T)
    ln_Kc = (-(g @ kin.d_nu.T)
             + kin.sum_d_nu * torch.log(P_REF / (GAS_CONSTANT * T))[..., None])

    ln_rf = ln_kf + ln_c @ kin.order_fwd_T
    ln_rr = ln_kf - ln_Kc + ln_c @ kin.nu_rev_T

    r_f = torch.exp(ln_rf) * factor
    r_r = torch.exp(ln_rr) * factor * kin.reversible
    return (r_f - r_r) @ kin.d_nu


def mass_production_rates(kin: KineticsData, thermo: ThermoData, T, rho, Y):
    """RR [kg/m^3/s]: the molar rates times the molecular weights."""
    return production_rates(kin, thermo, T, rho, Y) * kin.W


def heat_release_rate(kin: KineticsData, thermo: ThermoData, T, rho, Y):
    """Qdot [J/m^3/s] = -sum_i h_i(T) wdot_i (molar basis)."""
    wdot = production_rates(kin, thermo, T, rho, Y)
    h_molar = thermo.h_RT(T) * (GAS_CONSTANT * T[..., None])   # J/kmol
    return -(h_molar * wdot).sum(-1)
