"""Eddy Dissipation Concept turbulence-chemistry interaction model.

Port of deepflame_tpu/combustion/edc.py (the reference's EDC, versions
v1981, v1996, v2005 and v2016):

    gammaL = Cgamma (nu eps / k^2)^(1/4)      fine-structure fraction
    tau*   = Ctau sqrt(nu / eps)              fine-structure residence time
    kappa  = min(gammaL^exp1 / (1 - gammaL^exp2), 1), 1 where gammaL >= 1

v2016 takes per-cell Ctau and Cgamma from Da = tmix/tc and ReT = k^2/(nu
eps), with the Kolmogorov time for tc. The chemistry is integrated over tau*
(per cell, clipped to [1e-10, 0.1] s) and the rates are scaled by kappa.
"""
from __future__ import annotations

import dataclasses

import torch

from ..chemistry.reactor import ChemistryResult, solve_chemistry
from .basic import CombustionModel

__all__ = ["EDC"]

_EXPONENTS = {"v1981": (3, 3), "v1996": (2, 3), "v2005": (2, 2),
              "v2016": (2, 2)}


@dataclasses.dataclass(frozen=True)
class EDC(CombustionModel):
    version: str = "v2005"
    Cgamma: float = 2.1377
    Ctau: float = 0.4083
    C1: float = 0.05774      # v2016
    C2: float = 0.5          # v2016
    reads_turb = True

    def correct(self, T, p, Y, dt, turb=None, dt_start=None) -> ChemistryResult:
        if turb is None:
            raise ValueError("EDC requires turbulence quantities (k, epsilon, nu)")
        k = turb["k"]
        eps = torch.clamp(turb["epsilon"], min=1e-30)
        nu = turb["nu"]
        exp1, exp2 = _EXPONENTS[self.version]

        small = 1e-30
        if self.version == "v2016":
            ReT = k * k / torch.clamp(nu * eps, min=small)
            tmix = k / eps
            tc = torch.sqrt(nu / eps)         # the Kolmogorov time
            Da = torch.clamp(tmix / torch.clamp(tc, min=small), 1e-10, 10.0)
            Ctau_f = torch.clamp(self.C1 / (Da * torch.sqrt(ReT + 1.0)),
                                 max=2.1377)
            Cgamma_f = torch.clamp(self.C2 * torch.sqrt(Da * (ReT + 1.0)),
                                   0.4082, 5.0)
        else:
            Ctau_f = self.Ctau
            Cgamma_f = self.Cgamma

        gammaL = Cgamma_f * (nu * eps / torch.clamp(k * k, min=small)) ** 0.25
        tau_star = Ctau_f * torch.sqrt(nu / eps)
        kappa = torch.where(
            gammaL >= 1.0, torch.ones_like(gammaL),
            torch.clamp(gammaL ** exp1
                        / torch.clamp(1.0 - gammaL ** exp2, min=small),
                        0.0, 1.0))

        # integrate the chemistry over the fine-structure residence time
        tau_star = torch.clamp(tau_star, 1e-10, 0.1)
        res = solve_chemistry(self.thermo, self.kinetics, T, p, Y, tau_star,
                              dt_start=dt_start, opts=self.ode_opts,
                              T_threshold=self.T_threshold)
        return res._replace(RR=res.RR * kappa[..., None],
                            Qdot=res.Qdot * kappa)
