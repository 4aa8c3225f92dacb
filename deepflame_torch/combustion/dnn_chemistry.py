"""DNN-surrogate combustion model (DF-ODENet in the combustion-model slot).

Port of deepflame_tpu/combustion/dnn_chemistry.py: the reference's
`dfChemistryModel::solve_DNN` dispatch, with the hybrid (stiff integrator
outside the surrogate's validity window) as a per-cell mask.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..chemistry.reactor import ChemistryResult, solve_chemistry
from .basic import CombustionModel

__all__ = ["DNNChemistry"]


@dataclasses.dataclass(frozen=True)
class DNNChemistry(CombustionModel):
    """Chemistry source terms from a DF-ODENet surrogate (`net`: a DFODENet
    or MultiRangeDFODENet).

    hybrid=True also runs the stiff integrator and takes its rates in the
    cells outside [T_valid_min, T_valid_max]."""
    net: Any = None
    hybrid: bool = False
    T_valid_min: float = 0.0
    T_valid_max: float = 1e9

    def correct(self, T, p, Y, dt, turb=None, dt_start=None) -> ChemistryResult:
        if self.net is None:
            raise ValueError("DNNChemistry requires a DFODENet")
        rho = self.thermo.rho(p, T, Y)
        RR = self.net.rates(T, p, Y, rho)
        dt_next = None
        if self.hybrid:
            ode = solve_chemistry(self.thermo, self.kinetics, T, p, Y, dt,
                                  opts=self.ode_opts,
                                  T_threshold=self.T_threshold,
                                  dt_start=dt_start)
            outside = ((T < self.T_valid_min) | (T > self.T_valid_max))[..., None]
            RR = torch.where(outside, ode.RR, RR)
            dt_next = ode.dt_next
        Y_new = torch.clamp(Y + RR * dt / rho[..., None], 0.0, 1.0)
        Y_new = Y_new / Y_new.sum(-1, keepdim=True)
        Qdot = -(RR @ self.thermo.h_formation)
        return ChemistryResult(T=T, Y=Y_new, RR=RR, Qdot=Qdot,
                               dt_next=dt_next)
