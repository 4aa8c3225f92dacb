"""Partially Stirred Reactor turbulence-chemistry interaction model.

Port of deepflame_tpu/combustion/pasr.py (the reference's PaSR): the laminar
rates scaled by kappa = tc/(tc + tmix). Mixing time scales:

    globalScale:       tmix = Cmix k/eps
    kolmogorovScale:   tmix = sqrt(nu/eps)
    geometriMeanScale: tmix = sqrt((k/eps) sqrt(nu/eps))
    dynamicScale:      tmix = clip(Zvar/(Chi + small), dt, 0.1)

dynamicScale transports the model's own mixture fraction Z, its variance
Zvar and the scalar dissipation rate Chi (`n_aux`, `aux_init`,
`aux_advance`), Chi from one of three closures: constAlgebraic, dynAlgebraic
(a laminar-flame-speed correlation) or a transport equation. Each transport
is an FvMatrix solved by BiCGStab whose matvec is one `stencil7_apply`
launch on the (nx, ny, nz) field. Chemistry time scales: formationRate
(total concentration over total formation rate) and globalConvertion (the
largest rho Y_s / |RR_s| over the fuel and oxidizer).
"""
from __future__ import annotations

import dataclasses

import torch

from ..chemistry.reactor import ChemistryResult, solve_chemistry
from ..mesh.structured import pad_field
from ..ops.fv import fvm_ddt, fvm_div, fvm_laplacian, grad, interpolate
from ..ops.linsolve import solve_fvmatrix
from .basic import CombustionModel

__all__ = ["PaSR"]


@dataclasses.dataclass(frozen=True)
class PaSR(CombustionModel):
    mixing_scale: str = "globalScale"       # globalScale | kolmogorovScale |
                                            # geometriMeanScale | dynamicScale
    chemistry_scale: str = "formationRate"  # formationRate | globalConvertion
    Cmix: float = 0.1
    fuel_index: int | None = None           # for globalConvertion
    oxidizer_index: int | None = None
    tmix_max: float = 0.1
    # dynamicScale closure
    chi_type: str = "constAlgebraic"  # constAlgebraic | dynAlgebraic | transport
    Sc_t: float = 0.7
    max_chi: float = 5000.0
    Zst: float = 0.054
    # dynAlgebraic laminar speed Su = W eqR^eta exp(-xi (eqR - 1.075)^2)
    # (T/300)^alpha (p/1.013e5)^beta
    su_W: float = 0.422
    su_eta: float = 0.15
    su_xi: float = 5.18
    su_alpha: float = 2.0
    su_beta: float = -0.5
    # Chi transport closure constants
    Cd1: float = 1.5604
    Cd2: float = 1.1854
    Cp1: float = 1.6053
    Cp2: float = 1.1978
    reads_turb = True

    @property
    def n_aux(self) -> int:
        """Number of model-owned transported fields carried in the solver
        state (Z, Zvar, Chi for dynamicScale)."""
        return 3 if self.mixing_scale == "dynamicScale" else 0

    def aux_init(self, shape, dtype, Z0=None):
        """(Z, Zvar, Chi): Z0 (or 0), 0 and 1e-8, on the thermo tables'
        device."""
        device = self.thermo.W.device
        zeros = torch.zeros(shape, dtype=dtype, device=device)
        Z = zeros if Z0 is None else torch.as_tensor(Z0, dtype=dtype,
                                                     device=device)
        return (Z, zeros, torch.full(shape, 1e-8, dtype=dtype, device=device))

    def aux_advance(self, aux, rho, rho_old, phi, U, T, p, mu_eff, mu_t,
                    k, eps, dt, mesh, bcs_Z, bcs_U, bcs_coeff,
                    div_scheme="upwind", tol=1e-9, max_iter=100, stats=None):
        """Advance (Z, Zvar, Chi) one step; mu_eff diffuses Z and Zvar.
        `stats`: a dict that receives the BiCGStab iterations of each solve
        as iters_Z, iters_Zvar (and iters_Chi for the transport closure)."""
        Z, Zvar, Chi = aux
        dtype = Z.dtype
        small = 1e-30
        smallK = 1e-15
        stats = {} if stats is None else stats
        D_f = tuple(interpolate(pad_field(mu_eff, bcs_coeff, mesh), ax)
                    for ax in range(3))

        def transport(name, q, source, lo, hi):
            eqn = (fvm_ddt(rho, q, dt, mesh, bcs_Z, coeff_old=rho_old)
                   + fvm_div(phi, q, mesh, bcs_Z, div_scheme)
                   + fvm_laplacian(D_f, mesh, bcs_Z, dtype=dtype, sign=-1.0))
            r = solve_fvmatrix(eqn.with_source(source), q, tol=tol,
                               max_iter=max_iter)
            stats[f"iters_{name}"] = r.iterations
            return torch.clamp(r.x, lo, hi)

        Z = transport("Z", Z, torch.zeros_like(Z), 0.0, 1.0)
        gZ = grad(Z, bcs_Z, mesh)
        magsq_gZ = (gZ * gZ).sum(0)
        Zvar = transport("Zvar", Zvar, 2.0 * mu_t * magsq_gZ - rho * Chi,
                         0.0, 0.25)

        inv_tau = eps / (k + smallK)
        if self.chi_type == "constAlgebraic":
            Chi = inv_tau * Zvar
        elif self.chi_type == "dynAlgebraic":
            eqR = torch.clamp(Z / ((1.0 - Z) + small)
                              * (1.0 - self.Zst) / self.Zst, min=0.0)
            Su_ref = self.su_W * torch.clamp(eqR, min=small) ** self.su_eta \
                * torch.exp(-self.su_xi * (eqR - 1.075) ** 2)
            Su = Su_ref * (T / 300.0) ** self.su_alpha \
                * (p / 1.013e5) ** self.su_beta
            Chi = (0.21 * inv_tau * Zvar
                   + (2.0 / 3.0) * (0.1 * Su / torch.sqrt(k + smallK))
                   * 0.21 * inv_tau * Zvar)
        elif self.chi_type == "transport":
            D1 = self.Cd1 * rho * Chi ** 2 / (Zvar + small)
            D2 = self.Cd2 * rho * inv_tau * Chi
            P1 = 2.0 * self.Cp1 * inv_tau * (mu_t / self.Sc_t) * magsq_gZ
            gU = [grad(U[c], bcs_U[c], mesh) for c in range(3)]
            divU = gU[0][0] + gU[1][1] + gU[2][2]
            # grad(U) && dev(twoSymm(grad U))
            GS = 0.0
            for i in range(3):
                for j in range(3):
                    tw = gU[i][j] + gU[j][i]
                    if i == j:
                        tw = tw - (2.0 / 3.0) * divU
                    GS = GS + gU[i][j] * tw
            P2 = self.Cp2 * mu_t * Chi / (k + smallK) * GS
            DChi_f = tuple(interpolate(
                pad_field(mu_eff / self.Sc_t, bcs_coeff, mesh), ax)
                for ax in range(3))
            eqn = (fvm_ddt(rho, Chi, dt, mesh, bcs_Z, coeff_old=rho_old)
                   + fvm_div(phi, Chi, mesh, bcs_Z, div_scheme)
                   + fvm_laplacian(DChi_f, mesh, bcs_Z, dtype=dtype,
                                   sign=-1.0))
            r = solve_fvmatrix(eqn.with_source(P1 + P2 - D1 - D2), Chi,
                               tol=tol, max_iter=max_iter)
            stats["iters_Chi"] = r.iterations
            Chi = r.x
        else:
            raise ValueError(self.chi_type)
        Chi = torch.clamp(Chi, 1e-8, self.max_chi)
        return (Z, Zvar, Chi)

    def correct(self, T, p, Y, dt, turb=None, dt_start=None) -> ChemistryResult:
        if turb is None:
            raise ValueError("PaSR requires turbulence quantities (k, epsilon, nu)")
        k = turb["k"]
        eps = torch.clamp(turb["epsilon"], min=1e-30)
        nu = turb["nu"]

        if self.mixing_scale == "globalScale":
            tmix = self.Cmix * k / eps
        elif self.mixing_scale == "kolmogorovScale":
            tmix = torch.sqrt(nu / eps)
        elif self.mixing_scale == "geometriMeanScale":
            tmix = torch.sqrt((k / eps) * torch.sqrt(nu / eps))
        elif self.mixing_scale == "dynamicScale":
            # Zvar and Chi: the model-owned fields aux_advance advances
            tmix = torch.clamp(turb["Zvar"] / (turb["Chi"] + 1e-30),
                               float(dt), self.tmix_max)
        else:
            raise ValueError(self.mixing_scale)
        tmix = torch.clamp(tmix, 0.0, self.tmix_max)

        res = solve_chemistry(self.thermo, self.kinetics, T, p, Y, dt,
                              dt_start=dt_start, opts=self.ode_opts,
                              T_threshold=self.T_threshold)

        rho = self.thermo.rho(p, T, Y)
        small = 1e-30
        if self.chemistry_scale == "formationRate":
            # total moles over total formation rate
            c = rho[..., None] * Y * self.kinetics.inv_W
            wdot = torch.clamp(res.RR * self.kinetics.inv_W, min=0.0)
            tc = c.sum(-1) / torch.clamp(wdot.sum(-1), min=small)
        elif self.chemistry_scale == "globalConvertion":
            tc = torch.zeros_like(T)
            for idx in (self.fuel_index, self.oxidizer_index):
                if idx is not None:
                    ts = rho * Y[..., idx] / torch.clamp(
                        res.RR[..., idx].abs(), min=small)
                    tc = torch.maximum(tc, ts)
        else:
            raise ValueError(self.chemistry_scale)
        tc = torch.clamp(tc, 0.0, 1e3)

        kappa = torch.where((tmix > small) & (tc > small), tc / (tc + tmix),
                            torch.ones_like(tc))
        return res._replace(RR=res.RR * kappa[..., None],
                            Qdot=res.Qdot * kappa)
