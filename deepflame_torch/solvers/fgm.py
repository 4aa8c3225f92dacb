"""Flamelet-generated-manifold low-Mach solver (flareFGM and DeePFGM).

Port of deepflame_tpu/solvers/fgm.py: dfLowMachFoam with the FGM
combustion family. The reference's baseFGM transports the control scalars
Z, Zvar, c, cvar (and optionally Zcvar and the enthalpy He) with mut/Sct +
mu/Sc diffusivity, gradient production 2 mut/Sct |grad q|^2 and dissipation
2 rho chi; flareFGM reads omega_c, T, mwt, cp, nu from the table at the
normalised variances gz = Zvar/(Z(1-Z)), gc = cvar/(c(1-c)), the
correlation gzc and the enthalpy loss (DeePFGM: from a network). The
manifold replaces the chemistry and correctThermo; the momentum and
pressure blocks are LowMachSolver's.

Each control-scalar solve is one FvMatrix solve on `stencil7_apply`; the
pressure correctors are the shared `_pressure_loop` on `helmholtz7_apply`.
The table reads of one state share their interpolation corners
(`table.lookup_many`). The `thermo`, `transport` and `combustion` fields may
be None: the table (or network) gives the thermochemistry.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..combustion.fgm.table import FlameletTable, lookup, lookup_many
from ..constants import GAS_CONSTANT
from ..mesh.structured import pad_field
from ..ops.fv import div_flux, fvm_ddt, fvm_div, fvm_laplacian, grad, interpolate
from ..ops.linsolve import solve_fvmatrix
from .low_mach import LowMachConfig, LowMachSolver

__all__ = ["FGMState", "FGMConfig", "FGMSolver"]

_STATE_TABLES = ("Tf", "mwt", "cp", "nu", "omgc")


class FGMState(NamedTuple):
    rho: torch.Tensor
    U: torch.Tensor
    p: torch.Tensor
    Z: torch.Tensor        # mixture fraction
    Zvar: torch.Tensor
    c: torch.Tensor        # (scaled) progress variable
    cvar: torch.Tensor
    Zcvar: torch.Tensor    # Z-c covariance
    T: torch.Tensor
    He: torch.Tensor       # transported enthalpy (adiabatic Z (Hfu - Hox) +
                           # Hox unless solve_enthalpy)
    phi: tuple
    dpdt: torch.Tensor
    time: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FGMConfig(LowMachConfig):
    Sc: float = 0.7           # laminar Schmidt number
    Sc_t: float = 0.7         # turbulent Schmidt number
    Cd: float = 2.0           # scalar dissipation: chi = Cd eps/k var
    solve_cvar: bool = True
    solve_zcvar: bool = False     # the Z-c covariance equation
    solve_enthalpy: bool = False  # transport He; look up with the enthalpy
                                  # loss coordinate
    combustion_on: bool = True


@dataclasses.dataclass(frozen=True)
class FGMSolver(LowMachSolver):
    """LowMachSolver's momentum and pressure blocks with the FGM scalars;
    `combustion`, `bcs_Y` and `bcs_h` are unused, `bcs_Z` are the control
    scalars' BCs and `table` (or `deepfgm`) gives the thermochemistry."""
    table: FlameletTable = None
    deepfgm: Any = None    # DeepFGM replaces the state lookups when set

    @property
    def dtype(self) -> torch.dtype:
        if self.table is not None:
            return self.table.dtype
        return self.deepfgm.x_mean.dtype

    def fgm_initial_state(self, p, Z, c, U=None, time=0.0) -> FGMState:
        """State from p, Z, c (nx, ny, nz) and U (3, nx, ny, nz), tensors or
        arrays, on the solver's device in its dtype; variances zero."""
        dtype, dev = self.dtype, self.device
        f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
        p, Z, c = f(p), f(Z), f(c)
        sh = self.mesh.shape
        U = torch.zeros((3,) + sh, dtype=dtype, device=dev) if U is None else f(U)
        zeros = torch.zeros(sh, dtype=dtype, device=dev)
        He = self._adiabatic_enthalpy(Z)
        T, W, _, _, _ = self._lookup_state(Z, zeros, c, zeros, He=He)
        rho = p * W / (GAS_CONSTANT * T)
        return FGMState(rho=rho, U=U, p=p, Z=Z, Zvar=zeros, c=c, cvar=zeros,
                        Zcvar=zeros, T=T, He=He, phi=self._face_flux(rho, U),
                        dpdt=zeros, time=f(time))

    def _adiabatic_enthalpy(self, Z):
        """He = Z (Hfu - Hox) + Hox."""
        tb = self.table
        if tb is None:
            return torch.zeros_like(Z)
        return Z * (tb.H_fuel - tb.H_ox) + tb.H_ox

    def _lookup_state(self, Z, Zvar, c, cvar, Zcvar=None, He=None):
        """(T, W, cp, nu, omega_c) from the table or the network at the
        control-variable state."""
        small = 1e-6
        gz = Zvar / torch.clamp(Z * (1.0 - Z), min=small)
        gc = cvar / torch.clamp(c * (1.0 - c), min=small)
        if self.deepfgm is not None:
            out = self.deepfgm.query(Z, c, gz, gc)
            return out["Tf"], out["mwt"], out["cp"], out["nu"], out["omgc"]
        tb = self.table
        # correlation coordinate gzc = Zcvar / sqrt(Zvar cvar)
        gzc = None
        if Zcvar is not None and len(tb.axes[5]) > 1:
            gzc = torch.clamp(Zcvar / torch.clamp(torch.sqrt(Zvar * cvar),
                                                  min=small), -1.0, 1.0)
        # enthalpy loss h_adiabatic(Z) - He, clipped to the table's h axis
        hloss = None
        if He is not None and len(tb.axes[0]) > 1:
            h_ax = tb.axis(0, Z.dtype)
            hloss = torch.clamp(self._adiabatic_enthalpy(Z) - He, h_ax[0],
                                h_ax[-1])
        out = lookup_many(tb, _STATE_TABLES, (hloss, Z, c, gz, gc, gzc))
        return tuple(out[k] for k in _STATE_TABLES)

    def step(self, s: FGMState, dt, sources=None):
        """One PIMPLE step. sources: the spray coupling dict (Srho, SU, Sh)
        or None; the evaporated mass enters continuity and the Z, c, cvar
        and Zcvar equations (the vapour carries mixture fraction), SU the
        momentum and Sh the enthalpy, where the JAX step adds them. As
        there, the pressure equation takes no mass source."""
        cfg = self.config
        mesh = self.mesh
        dtype = s.p.dtype

        rho_old, U_old, p_old = s.rho, s.U, s.p
        Z_old, Zvar_old, c_old, cvar_old = s.Z, s.Zvar, s.c, s.cvar
        Zcvar_old, He_old = s.Zcvar, s.He
        rho, U, p, phi, dpdt, T = s.rho, s.U, s.p, s.phi, s.dpdt, s.T
        Z, Zvar, c, cvar, Zcvar, He = s.Z, s.Zvar, s.c, s.cvar, s.Zcvar, s.He
        diag = {}
        bz = self.bcs_Z
        src_rho = sources["Srho"] if sources else None
        with_src = (lambda q: q) if src_rho is None \
            else (lambda q: q + src_rho)

        for outer in range(cfg.n_outer):
            rho = rho_old - dt * div_flux(phi, mesh)
            if src_rho is not None:
                rho = rho + dt * src_rho

            # table thermo-transport coefficients
            T_tab, W_tab, cp_tab, nu_tab, omgc = self._lookup_state(
                Z, Zvar, c, cvar, Zcvar, He)
            mu = rho * nu_tab
            mu_t = torch.zeros_like(mu)
            if self.turbulence is not None:
                mu_t = self.turbulence.mu_t(rho, U, self.bcs_U, mesh)
                k_sgs, eps_sgs = self.turbulence.sgs_k_epsilon(mu_t, rho, mesh)
            else:
                k_sgs = torch.zeros_like(mu)
                eps_sgs = torch.ones_like(mu)

            U, HbyA, rAU = self._momentum(
                rho, rho_old, U, U_old, phi, p, mu + mu_t, dt,
                SU=sources["SU"] if sources else None, stats=diag)

            # ===== control-scalar transport
            D_scalar = mu_t / cfg.Sc_t + mu / cfg.Sc
            D_f = tuple(interpolate(pad_field(D_scalar, self.bcs_coeff, mesh),
                                    ax) for ax in range(3))

            def transport(name, q, q_old, source, q_min=0.0, q_max=1.0):
                eqn = (fvm_ddt(rho, q_old, dt, mesh, bz, coeff_old=rho_old)
                       + fvm_div(phi, q, mesh, bz, cfg.div_scheme)
                       + fvm_laplacian(D_f, mesh, bz, dtype=dtype, sign=-1.0))
                r = solve_fvmatrix(eqn.with_source(source), q, tol=cfg.y_tol,
                                   max_iter=cfg.max_iter_u)
                diag[f"iters_{name}"] = r.iterations
                return torch.clamp(r.x, q_min, q_max)

            zeros = torch.zeros(mesh.shape, dtype=dtype, device=self.device)
            chi_rate = cfg.Cd * (eps_sgs / torch.clamp(k_sgs, min=1e-10))
            Z = transport("Z", Z, Z_old, with_src(zeros))
            gZ = grad(Z, bz, mesh)
            magsq_gZ = sum(gZ[ax] ** 2 for ax in range(3))
            Zvar = transport("Zvar", Zvar, Zvar_old,
                             2.0 * (mu_t / cfg.Sc_t) * magsq_gZ
                             - 2.0 * rho * (chi_rate * Zvar * 0.5), 0.0, 0.25)
            if cfg.combustion_on:
                c = transport("c", c, c_old, with_src(rho * omgc))
                gz = Zvar / torch.clamp(Z * (1 - Z), min=1e-6)
                if cfg.solve_cvar:
                    gC = grad(c, bz, mesh)
                    magsq_gC = sum(gC[ax] ** 2 for ax in range(3))
                    cOc = lookup(self.table, "cOc",
                                 (None, Z, c, gz, cvar / torch.clamp(
                                     c * (1 - c), min=1e-6), None))
                    cvar = transport("cvar", cvar, cvar_old, with_src(
                        2.0 * (mu_t / cfg.Sc_t) * magsq_gC
                        - 2.0 * rho * (chi_rate * cvar * 0.5)
                        + 2.0 * rho * (cOc - c * omgc)), 0.0, 0.25)
                if cfg.solve_zcvar:
                    gC2 = grad(c, bz, mesh)
                    cross = sum(gZ[ax] * gC2[ax] for ax in range(3))
                    ZOc = lookup(self.table, "ZOc",
                                 (None, Z, c, gz, cvar / torch.clamp(
                                     c * (1 - c), min=1e-6), None))
                    Zcvar = transport(
                        "Zcvar", Zcvar, Zcvar_old, with_src(
                            2.0 * (mu_t / cfg.Sc_t) * cross
                            - 2.0 * rho * (chi_rate * Zcvar * 0.5)
                            + rho * (ZOc - Z * omgc)), -0.25, 0.25)

            # ===== enthalpy (transported, else the adiabatic relation)
            if cfg.solve_enthalpy:
                eqn_h = (fvm_ddt(rho, He_old, dt, mesh, bz, coeff_old=rho_old)
                         + fvm_div(phi, He, mesh, bz, cfg.div_scheme)
                         + fvm_laplacian(D_f, mesh, bz, dtype=dtype,
                                         sign=-1.0))
                r = solve_fvmatrix(eqn_h.with_source(
                    dpdt + sources["Sh"] if sources else dpdt), He,
                                   tol=cfg.h_tol, max_iter=cfg.max_iter_u)
                He = r.x
                diag["iters_He"] = r.iterations
            else:
                He = self._adiabatic_enthalpy(Z)

            # ===== table thermo update
            T, W_tab, cp_tab, nu_tab, omgc = self._lookup_state(
                Z, Zvar, c, cvar, Zcvar, He)
            psi = W_tab / (GAS_CONSTANT * T)

            # ===== pressure correctors (shared block)
            p, phi, U, dpdt, rho, p_res = self._pressure_loop(
                p, p_old, psi, lambda pp: pp * psi, HbyA, rAU, dt,
                rho_old=rho_old, phi_old=s.phi,
                rhoU_old_f=self._face_flux(rho_old, U_old), stats=diag)
            diag[f"p_res_{outer}"] = p_res

        diag["T_min"] = T.min()
        diag["T_max"] = T.max()
        diag["c_max"] = c.max()
        return FGMState(rho=rho, U=U, p=p, Z=Z, Zvar=Zvar, c=c, cvar=cvar,
                        Zcvar=Zcvar, T=T, He=He, phi=phi, dpdt=dpdt,
                        time=s.time + dt), diag
