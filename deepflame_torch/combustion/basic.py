"""Combustion model layer: base API + laminar (no turbulence-chemistry
interaction) model.

Port of deepflame_tpu/combustion/basic.py: `Laminar.correct()` calls the
chemistry engine and returns its reaction-rate source.
"""
from __future__ import annotations

import dataclasses

import torch

from ..chemistry.integrator import RosenbrockOptions
from ..chemistry.kinetics import KineticsData
from ..chemistry.reactor import ChemistryResult, solve_chemistry
from ..chemistry.thermo import ThermoData

__all__ = ["CombustionModel", "Laminar", "NoCombustion"]


@dataclasses.dataclass(frozen=True)
class CombustionModel:
    """Base: owns the chemistry engine handles (thermo + kinetics)."""
    thermo: ThermoData
    kinetics: KineticsData
    ode_opts: RosenbrockOptions = RosenbrockOptions(rtol=1e-6, atol=1e-12)
    T_threshold: float = 280.0
    # load-balance bin count of the batched integrator; sort="dt" bins lanes
    # by the warm-started controller step instead of temperature
    n_bins: int = 32
    sort: str = "T"
    # cross-shard chemistry load balance under an active shard group (the
    # reference's DLB, LoadBalancer.C:124-232): chemistry.reactor's
    # stratified all_to_all lane exchange, so that a front inside one
    # shard's block does not hold every shard up
    dlb_cross_shard: bool = False
    # whether correct() reads `turb`: the low-Mach step computes the SGS k,
    # epsilon and nu only for models that do (JAX's jit drops them for the
    # others as dead code)
    reads_turb = False

    def correct(self, T, p, Y, dt, turb=None, dt_start=None) -> ChemistryResult:
        """Reaction rates over dt. `turb`: the turbulence fields (k,
        epsilon, nu) that mixing models read; `dt_start`: per-cell warm-start
        step of the stiff integrator."""
        raise NotImplementedError

    def kappa(self, turb) -> float:
        """Reacting fraction applied to R(Yi); 1 for laminar."""
        return 1.0


@dataclasses.dataclass(frozen=True)
class Laminar(CombustionModel):
    """No turbulence-chemistry interaction: RR straight from the integrator
    (`turb` is not read)."""

    def correct(self, T, p, Y, dt, turb=None, dt_start=None) -> ChemistryResult:
        return solve_chemistry(self.thermo, self.kinetics, T, p, Y, dt,
                               opts=self.ode_opts,
                               T_threshold=self.T_threshold,
                               n_bins=self.n_bins, sort=self.sort,
                               dt_start=dt_start,
                               cross_shard=self.dlb_cross_shard)


@dataclasses.dataclass(frozen=True)
class NoCombustion(CombustionModel):
    """Chemistry disabled."""

    def correct(self, T, p, Y, dt, turb=None, dt_start=None) -> ChemistryResult:
        return ChemistryResult(T=T, Y=Y, RR=torch.zeros_like(Y),
                               Qdot=torch.zeros_like(T))
