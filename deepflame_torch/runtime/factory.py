"""Solver factory: build solver stacks from a CaseConfig.

Port of deepflame_tpu/runtime/factory.py (the reference solvers'
createFields.H: runtime selection of thermo, combustion model and
turbulence model from the case dictionaries), for what the port has:
laminar, EDC, PaSR, noCombustion and DNN combustion; laminar flow, the
Smagorinsky, WALE, Sigma and dynamic Smagorinsky LES models and the
kEpsilon, RNGkEpsilon and kOmegaSST RAS models; the low-Mach and the
density-based solvers. An unknown model raises ValueError.
"""
from __future__ import annotations

import torch

from ..chemistry import (load_mechanism, make_kinetics, make_thermo,
                         make_transport)
from ..chemistry.dnn import load_npz_checkpoint
from ..chemistry.integrator import RosenbrockOptions
from ..combustion import DNNChemistry, EDC, Laminar, NoCombustion, PaSR
from ..solvers.high_speed import HighSpeedConfig, HighSpeedSolver
from ..solvers.low_mach import LowMachConfig, LowMachSolver
from ..turbulence import (KEpsilon, KOmegaSST, dynamic_smagorinsky,
                          sigma_model, smagorinsky, wale)
from .config import CaseConfig

__all__ = ["build_chemistry", "build_combustion", "build_turbulence",
           "build_low_mach_solver", "build_high_speed_solver"]

_LES = {"Smagorinsky": smagorinsky, "WALE": wale, "Sigma": sigma_model,
        "dynamicSmagorinsky": dynamic_smagorinsky}


def _dtype(case: CaseConfig):
    return torch.float64 if case.dtype == "float64" else torch.float32


def build_chemistry(case: CaseConfig, device=None):
    """Mechanism and its thermo, transport and kinetics tables on `device`
    (default: the CUDA card)."""
    dtype = _dtype(case)
    mech = load_mechanism(case.chemistry.mechanism_file, device=device)
    return (mech, make_thermo(mech, dtype), make_transport(mech, dtype),
            make_kinetics(mech, dtype))


def build_combustion(case: CaseConfig, th, kin):
    opts = RosenbrockOptions(rtol=case.chemistry.ode_rtol,
                             atol=case.chemistry.ode_atol,
                             max_steps=20000, grow=10.0)
    m = case.combustion.model
    if m == "laminar":
        return Laminar(th, kin, ode_opts=opts,
                       T_threshold=case.chemistry.frozen_temperature
                       if case.chemistry.torch_on else 280.0)
    if m == "EDC":
        return EDC(th, kin, ode_opts=opts,
                   version=case.combustion.edc_version)
    if m == "PaSR":
        return PaSR(th, kin, ode_opts=opts,
                    mixing_scale=case.combustion.pasr_mixing_scale,
                    chemistry_scale=case.combustion.pasr_chemistry_scale,
                    Cmix=case.combustion.pasr_Cmix)
    if m == "noCombustion":
        return NoCombustion(th, kin)
    if m == "DNN":
        net = load_npz_checkpoint(case.chemistry.torch_model,
                                  frozen_T=case.chemistry.frozen_temperature,
                                  device=th.W.device)
        return DNNChemistry(th, kin, ode_opts=opts, net=net)
    raise ValueError(f"unknown combustion model {m!r} "
                     "(flareFGM/DeePFGM run through the FGM solver)")


def build_turbulence(case: CaseConfig):
    t = case.turbulence
    if t.simulation_type == "laminar":
        return None
    if t.simulation_type == "LES":
        if t.les_model not in _LES:
            raise ValueError(f"unknown LES model {t.les_model!r}")
        return _LES[t.les_model](Pr_t=t.Pr_t, Sc_t=t.Sc_t)
    if t.simulation_type == "RAS":
        if t.ras_model == "kEpsilon":
            return KEpsilon(Pr_t=t.Pr_t, Sc_t=t.Sc_t)
        if t.ras_model == "RNGkEpsilon":
            return KEpsilon.rng(Pr_t=t.Pr_t, Sc_t=t.Sc_t)
        if t.ras_model == "kOmegaSST":
            return KOmegaSST(Pr_t=t.Pr_t, Sc_t=t.Sc_t)
        raise ValueError(f"unknown RAS model {t.ras_model!r}")
    raise ValueError(t.simulation_type)


def build_low_mach_solver(case: CaseConfig, mesh, bcs_U, bcs_p, bcs_h,
                          bcs_Y, bcs_rho):
    """(LowMachSolver, mechanism) for the case, on the mesh's device."""
    mech, th, tr, kin = build_chemistry(case, device=mesh.device)
    comb = build_combustion(case, th, kin)
    turb = build_turbulence(case)
    sol = case.solution
    inert = (mech.species_index(case.chemistry.inert_specie)
             if case.chemistry.inert_specie in mech.species_names else None)
    cfg = LowMachConfig(
        n_outer=sol.n_outer_correctors, n_corr=sol.n_correctors,
        div_scheme=case.schemes.div_scheme,
        u_tol=sol.u_tol, p_tol=sol.p_tol, p_rel_tol=sol.p_rel_tol,
        h_tol=sol.h_tol, y_tol=sol.y_tol,
        unity_lewis=(case.chemistry.transport_model == "UnityLewis"),
        chemistry=case.chemistry.chemistry, inert_index=inert)
    return LowMachSolver(mesh=mesh, thermo=th, transport=tr, combustion=comb,
                         bcs_U=bcs_U, bcs_p=bcs_p, bcs_h=bcs_h, bcs_Y=bcs_Y,
                         bcs_rho=bcs_rho, config=cfg, turbulence=turb), mech


def build_high_speed_solver(case: CaseConfig, mesh, bcs_rho, bcs_U, bcs_p,
                            bcs_Y):
    """(HighSpeedSolver, mechanism) for the case, on the mesh's device:
    the flux scheme, RK order and limiter of `case.schemes`, split ODE
    chemistry when `case.chemistry.chemistry` is set."""
    mech, th, _, kin = build_chemistry(case, device=mesh.device)
    cfg = HighSpeedConfig(
        flux=case.schemes.flux_scheme, rk_order=case.schemes.rk_order,
        limiter=case.schemes.limiter,
        chemistry="ode" if case.chemistry.chemistry else "none",
        ode_opts=RosenbrockOptions(rtol=case.chemistry.ode_rtol,
                                   atol=case.chemistry.ode_atol,
                                   max_steps=20000, grow=10.0))
    return HighSpeedSolver(mesh=mesh, thermo=th, kinetics=kin,
                           bcs_rho=bcs_rho, bcs_U=bcs_U, bcs_p=bcs_p,
                           bcs_Y=bcs_Y, config=cfg), mech
