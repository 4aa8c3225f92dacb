"""Euler-Lagrangian spray solvers: dfSprayFoam and the two-phase
dfHighSpeedFoam.

Port of deepflame_tpu/solvers/spray.py on the structured mesh. SpraySolver
is the low-Mach PIMPLE step (or the FGM step) with `parcels.evolve()` before
it: the cloud samples the start-of-step gas and its Srho, SU, Sh and SY
sources enter the step. HighSpeedSpraySolver evolves the cloud on the
start-of-step gas of the density-based solver and kicks the conservative
state with the sources after its step, then decodes T again.
SprayFLSolver is dfSprayFoam on a general mesh: the face-list PIMPLE step
with the cloud on a background overlay grid (lagrangian/overlay.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..lagrangian.cloud import CloudState, SprayCloud
from .high_speed import HighSpeedSolver, HighSpeedState
from .low_mach import LowMachSolver, LowMachState

__all__ = ["SprayState", "SpraySolver", "HighSpeedSprayState",
           "HighSpeedSpraySolver", "SprayFLState", "SprayFLSolver"]


class SprayState(NamedTuple):
    gas: Any                 # LowMachState, or FGMState with the FGM solver
    cloud: CloudState


def _with_stats(diag: dict, cloud: SprayCloud, c: CloudState) -> dict:
    diag.update({f"cloud_{k}": v for k, v in cloud.stats(c).items()})
    return diag


@dataclasses.dataclass(frozen=True)
class SpraySolver:
    """A SprayCloud on a LowMachSolver (or an FGMSolver). fuel_index: the
    gas species that takes the evaporated vapour (SY)."""
    gas_solver: LowMachSolver
    cloud: SprayCloud
    fuel_index: int

    def initial_state(self, p, T, Y, U=None, generator=None,
                      **gas_kw) -> SprayState:
        """Gas state from LowMachSolver.initial_state (gas_kw: k0, eps0,
        ...) and an empty cloud drawing from `generator` (default: seeded
        with 0 on the solver's device)."""
        gas = self.gas_solver.initial_state(p, T, Y, U, **gas_kw)
        return SprayState(gas=gas, cloud=self.cloud.init(
            generator, dtype=self.gas_solver.dtype))

    def initial_state_fgm(self, p, Z, c, U=None,
                          generator=None) -> SprayState:
        """Spray on the FGM gas phase (FGMLiquidEvaporationBoil): the
        vapour feeds the mixture fraction."""
        gas = self.gas_solver.fgm_initial_state(p, Z, c, U)
        return SprayState(gas=gas, cloud=self.cloud.init(
            generator, dtype=self.gas_solver.dtype))

    def step(self, s: SprayState, dt):
        gas = s.gas
        gs = self.gas_solver
        if isinstance(gas, LowMachState):
            Yt = torch.movedim(gas.Y, 0, -1)
            X = gs.thermo.mole_fractions(Yt)
            # the carrier's cp and kappa at the parcels (Bird correction,
            # boiling Spalding number)
            extra = dict(cp=gs.thermo.cp_mass(gas.T, Yt),
                         kappa=gs.transport.lambda_mix(gas.T, X))
            mu = gs.transport.mu_mix(gas.T, X)
            Yv = gas.Y[self.fuel_index]
        else:
            # FGM: viscosity from the manifold; the vapour is pure fuel,
            # carried by the mixture fraction
            _, _, _, nu_tab, _ = gs._lookup_state(
                gas.Z, gas.Zvar, gas.c, gas.cvar, gas.Zcvar, gas.He)
            mu = gas.rho * nu_tab
            Yv = gas.Z
            extra = {}
        gas_fields = dict(rho=gas.rho, U=gas.U, T=gas.T, mu=mu, p=gas.p,
                          Yv=Yv, **extra)
        cloud, src = self.cloud.evolve(s.cloud, gas_fields, dt, gas.time)
        sources = dict(Srho=src.Srho, SU=src.SU, Sh=src.Sh, SY=src.SY,
                       SY_index=self.fuel_index)
        gas_new, diag = gs.step(gas, dt, sources=sources)
        return SprayState(gas=gas_new, cloud=cloud), \
            _with_stats(diag, self.cloud, cloud)


class HighSpeedSprayState(NamedTuple):
    gas: HighSpeedState
    cloud: CloudState


@dataclasses.dataclass(frozen=True)
class HighSpeedSpraySolver:
    """Lagrangian droplets in the density-based step (the reference's
    water-mist detonations). The cloud evolves on the start-of-step gas;
    its sources kick the conservative state after the step:
        rho += dt Srho, rhoU += dt SU, rhoY_v += dt SY,
        rhoE += dt (Sh + 0.5 |U|^2 Srho),
    |U| from the start of the step. transport: the TransportData of the gas
    viscosity that the drag samples."""
    gas_solver: HighSpeedSolver
    cloud: SprayCloud
    transport: Any
    vapor_index: int            # the gas species that takes the vapour

    def initial_state(self, p, T, Y, U=None,
                      generator=None) -> HighSpeedSprayState:
        gas = self.gas_solver.initial_state(p, T, Y, U)
        return HighSpeedSprayState(gas=gas, cloud=self.cloud.init(
            generator, dtype=self.gas_solver.dtype))

    def step(self, s: HighSpeedSprayState, dt):
        gas = s.gas
        gs = self.gas_solver
        rho, U, p, T, Y = gs.primitives(gas)
        X = gs.thermo.mole_fractions(torch.movedim(Y, 0, -1))
        mu = self.transport.mu_mix(T, X)
        gas_fields = dict(rho=rho, U=U, T=T, mu=mu, p=p,
                          Yv=Y[self.vapor_index])
        cloud, src = self.cloud.evolve(s.cloud, gas_fields, dt, gas.time)
        gas2, diag = gs.step(gas, dt)
        # the sources' explicit kick of the conservative state
        ke = 0.5 * (U * U).sum(0)
        rhoY = gas2.rhoY.clone()
        rhoY[self.vapor_index] += dt * src.SY
        gas2 = gas2._replace(
            rho=gas2.rho + dt * src.Srho,
            rhoU=gas2.rhoU + dt * src.SU,
            rhoE=gas2.rhoE + dt * (src.Sh + ke * src.Srho),
            rhoY=rhoY)
        # T decoded again after the kick (the Newton warm start)
        _, _, _, T_new, _ = gs.primitives(gas2)
        gas2 = gas2._replace(T=T_new)
        return HighSpeedSprayState(gas=gas2, cloud=cloud), \
            _with_stats(diag, self.cloud, cloud)


class SprayFLState(NamedTuple):
    gas: Any                 # LowMachFLState
    cloud: CloudState


@dataclasses.dataclass(frozen=True)
class SprayFLSolver:
    """Euler-Lagrangian spray on a general mesh: a LowMachSolverFL and an
    OverlaySprayCloud over its cells. fuel_index: the gas species that takes
    the evaporated vapour. The cloud samples the start-of-step gas (with
    the carrier's cp and kappa, and the RAS k for the turbulent dispersion
    when the gas carries it); its Srho, SU, Sh and SY enter the step."""
    gas_solver: Any
    cloud: Any
    fuel_index: int

    def initial_state(self, p, T, Y, U=None, generator=None,
                      **gas_kw) -> SprayFLState:
        gas = self.gas_solver.initial_state(p, T, Y, U, **gas_kw)
        return SprayFLState(gas=gas, cloud=self.cloud.init(
            generator, dtype=self.gas_solver.dtype))

    def step(self, s: SprayFLState, dt):
        gas = s.gas
        gs = self.gas_solver
        X = gs.thermo.mole_fractions(gas.Y)
        gas_fields = dict(rho=gas.rho, U=gas.U, T=gas.T,
                          mu=gs.transport.mu_mix(gas.T, X), p=gas.p,
                          Yv=gas.Y[:, self.fuel_index],
                          cp=gs.thermo.cp_mass(gas.T, gas.Y),
                          kappa=gs.transport.lambda_mix(gas.T, X))
        if gas.turb:
            gas_fields["k_turb"] = gas.turb[0]
        cloud, src = self.cloud.evolve(s.cloud, gas_fields, dt, gas.time)
        sources = dict(Srho=src.Srho, SU=src.SU, Sh=src.Sh, SY=src.SY,
                       SY_index=self.fuel_index)
        gas_new, diag = gs.step(gas, dt, sources=sources)
        return SprayFLState(gas=gas_new, cloud=cloud), \
            _with_stats(diag, self.cloud, cloud)
