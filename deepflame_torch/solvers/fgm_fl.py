"""Flamelet-generated-manifold solver on the face-list backend.

Port of deepflame_tpu/solvers/fgm_fl.py: the baseFGM / flareFGM algorithm
of solvers/fgm.py (transport of the control scalars Z, Zvar, c, cvar and
optionally Zcvar and the enthalpy He; the state from the table, or from a
DeepFGM network) over FaceListMesh connectivity, with the face-list
k-epsilon RAS closure of LowMachSolverFL (standard or RNG, wall functions)
and its momentum and pressure blocks. On plan meshes every scalar solve and
the pressure CG run on the lattice through the `stencil7_apply` kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..combustion.fgm.table import FlameletTable, lookup
from ..constants import GAS_CONSTANT
from ..mesh.facelist import FaceListMesh
from ..ops.fv_facelist import (div_flux_fl, fvm_ddt_fl, fvm_div_fl,
                               fvm_laplacian_corrected_fl, grad_fl)
from ..ops.linsolve import solve_fvmatrix
from .fgm import FGMConfig, FGMSolver
from .low_mach_fl import LowMachSolverFL, _face_product

__all__ = ["FGMFLState", "FGMSolverFL"]


class FGMFLState(NamedTuple):
    rho: torch.Tensor       # (n,)
    U: torch.Tensor         # (n, 3)
    p: torch.Tensor
    Z: torch.Tensor
    Zvar: torch.Tensor
    c: torch.Tensor
    cvar: torch.Tensor
    Zcvar: torch.Tensor
    T: torch.Tensor
    He: torch.Tensor
    k: torch.Tensor         # RAS turbulent kinetic energy
    eps: torch.Tensor       # RAS dissipation
    phi: torch.Tensor       # (nf,)
    phi_b: tuple
    dpdt: torch.Tensor
    time: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FGMSolverFL(LowMachSolverFL):
    """Per-field FaceListMesh instances as in LowMachSolverFL; thermo,
    transport and combustion may be None. The inherited slots m_h and m_Y
    carry the He and Z BCs; m_c the progress variable's, m_var the
    variances' (shared); m_k and m_eps turn the RAS closure on."""
    table: FlameletTable = None
    m_c: FaceListMesh = None
    m_var: FaceListMesh = None
    deepfgm: Any = None

    @property
    def m_Z(self) -> FaceListMesh:
        return self.m_Y

    @property
    def m_He(self) -> FaceListMesh:
        return self.m_h

    @property
    def dtype(self) -> torch.dtype:
        return self.m_p.volumes.dtype

    # the table (or network) reads of solvers/fgm.py
    _adiabatic_enthalpy = FGMSolver._adiabatic_enthalpy
    _lookup_state = FGMSolver._lookup_state

    def fgm_initial_state(self, p, Z, c, U=None, k0=1e-3, eps0=1e-2,
                          time=0.0) -> FGMFLState:
        """State from p, Z, c (n,) and U (n, 3), tensors or arrays, on the
        solver's device in its dtype; variances zero, (k, eps) uniform."""
        dtype, dev = self.dtype, self.device
        f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
        p, Z, c = f(p), f(Z), f(c)
        n = p.shape[0]
        U = torch.zeros((n, 3), dtype=dtype, device=dev) if U is None else f(U)
        zeros = torch.zeros(n, dtype=dtype, device=dev)
        He = self._adiabatic_enthalpy(Z)
        T, W, _, _, _ = self._lookup_state(Z, zeros, c, zeros, He=He)
        rho = p * W / (GAS_CONSTANT * T)
        phi, phi_b = self._face_flux(rho, U)
        return FGMFLState(rho=rho, U=U, p=p, Z=Z, Zvar=zeros, c=c,
                          cvar=zeros, Zcvar=zeros, T=T, He=He,
                          k=torch.full((n,), k0, dtype=dtype, device=dev),
                          eps=torch.full((n,), eps0, dtype=dtype, device=dev),
                          phi=phi, phi_b=phi_b, dpdt=zeros, time=f(time))

    def _transport(self, mbc, rho, rho_old, phi, phi_b, q, q_old, D_f, D_b,
                   src, dt, qmin, qmax, stats, name):
        cfg = self.config
        eqn = (fvm_ddt_fl(mbc, rho, rho_old, q_old, dt)
               + fvm_div_fl(mbc, phi, list(phi_b), cfg.div_scheme, x_now=q)
               + fvm_laplacian_corrected_fl(mbc, D_f, D_b, q, sign=-1.0)
               ).with_source(src)
        res = solve_fvmatrix(eqn, q, tol=cfg.y_tol, max_iter=cfg.max_iter_u)
        stats[f"iters_{name}"] = res.iterations
        return torch.clamp(res.x, qmin, qmax)

    # ---------------------------------------------------------------- step
    def step(self, s: FGMFLState, dt, sources=None):
        """One PIMPLE step. sources: the spray coupling dict (Srho, Sh) or
        None; the evaporated mass enters continuity and the control-scalar
        equations, Sh the enthalpy, where the JAX step adds them."""
        cfg: FGMConfig = self.config
        m = self.m_p
        diag = {}
        src_rho = sources["Srho"] if sources else None
        src_h = sources["Sh"] if sources else None
        with_src = (lambda q: q) if src_rho is None else \
            (lambda q: q + src_rho)

        rho_old, U_old, p_old = s.rho, s.U, s.p
        Z_old, Zvar_old, c_old, cvar_old = s.Z, s.Zvar, s.c, s.cvar
        Zcvar_old, He_old = s.Zcvar, s.He
        rho, U, p, dpdt, T = s.rho, s.U, s.p, s.dpdt, s.T
        Z, Zvar, c, cvar, Zcvar, He = s.Z, s.Zvar, s.c, s.cvar, s.Zcvar, s.He
        k, eps = s.k, s.eps
        phi, phi_b = s.phi, s.phi_b
        tr = lambda mbc, q, q_old, src, lo, hi, name: self._transport(
            mbc, rho, rho_old, phi, phi_b, q, q_old, D_f, D_b, src, dt, lo,
            hi, diag, name)

        for outer in range(cfg.n_outer):
            # ===== rhoEqn
            rho = rho_old - dt * div_flux_fl(m, phi, phi_b)
            if src_rho is not None:
                rho = rho + dt * src_rho

            # ===== table transport coefficients
            _, _, _, nu_tab, omgc = self._lookup_state(Z, Zvar, c, cvar,
                                                       Zcvar, He)
            mu = rho * nu_tab

            # ===== RAS closure (laminar without m_k: mu_t = 0)
            if self.m_k is not None:
                k, eps, mu_t = self._keps_advance(k, eps, rho, rho_old, phi,
                                                  phi_b, U, mu, dt)
            else:
                mu_t = torch.zeros_like(mu)
            mu_eff = mu + mu_t
            mu_f, mu_bf = _face_product(m, mu_eff)

            # ===== momentum (inherited block)
            U, HbyA, rAU = self._momentum(rho, rho_old, U, U_old, phi, phi_b,
                                          p, mu_f, mu_bf, mu_eff, dt, diag)

            # ===== control-scalar transport
            D_f, D_b = _face_product(m, mu_t / cfg.Sc_t + mu / cfg.Sc)
            zeros = torch.zeros_like(Z)
            Z = tr(self.m_Z, Z, Z_old, with_src(zeros), 0.0, 1.0, "Z")
            gZ = grad_fl(self.m_Z, Z)
            magsq_gZ = (gZ * gZ).sum(1)
            if self.m_k is not None:
                chi_fac = cfg.Cd * (eps / torch.clamp(k, min=1e-10)) * 0.5
            else:
                # laminar: the structured solver's k = 0, eps = 1
                chi_fac = cfg.Cd * (torch.ones_like(Z) / 1e-10) * 0.5
            Zvar = tr(self.m_var, Zvar, Zvar_old,
                      2.0 * (mu_t / cfg.Sc_t) * magsq_gZ
                      - 2.0 * rho * chi_fac * Zvar, 0.0, 0.25, "Zvar")
            if cfg.combustion_on:
                c = tr(self.m_c, c, c_old, with_src(rho * omgc), 0.0, 1.0,
                       "c")
                gz = Zvar / torch.clamp(Z * (1 - Z), min=1e-6)
                if cfg.solve_cvar:
                    gC = grad_fl(self.m_c, c)
                    cOc = lookup(self.table, "cOc", (
                        None, Z, c, gz,
                        cvar / torch.clamp(c * (1 - c), min=1e-6), None))
                    cvar = tr(self.m_var, cvar, cvar_old, with_src(
                        2.0 * (mu_t / cfg.Sc_t) * (gC * gC).sum(1)
                        - 2.0 * rho * chi_fac * cvar
                        + 2.0 * rho * (cOc - c * omgc)), 0.0, 0.25, "cvar")
                if cfg.solve_zcvar:
                    gC2 = grad_fl(self.m_c, c)
                    ZOc = lookup(self.table, "ZOc", (
                        None, Z, c, gz,
                        cvar / torch.clamp(c * (1 - c), min=1e-6), None))
                    Zcvar = tr(self.m_var, Zcvar, Zcvar_old, with_src(
                        2.0 * (mu_t / cfg.Sc_t) * (gZ * gC2).sum(1)
                        - 2.0 * rho * chi_fac * Zcvar
                        + rho * (ZOc - Z * omgc)), -0.25, 0.25, "Zcvar")

            # ===== enthalpy
            if cfg.solve_enthalpy:
                eqn_h = (fvm_ddt_fl(self.m_He, rho, rho_old, He_old, dt)
                         + fvm_div_fl(self.m_He, phi, list(phi_b),
                                      cfg.div_scheme, x_now=He)
                         + fvm_laplacian_corrected_fl(self.m_He, D_f, D_b,
                                                      He, sign=-1.0)
                         ).with_source(dpdt if src_h is None
                                       else dpdt + src_h)
                res = solve_fvmatrix(eqn_h, He, tol=cfg.h_tol,
                                     max_iter=cfg.max_iter_u)
                He = res.x
                diag["iters_He"] = res.iterations
            else:
                He = self._adiabatic_enthalpy(Z)

            # ===== table thermo
            T, W_tab, _, _, _ = self._lookup_state(Z, Zvar, c, cvar, Zcvar,
                                                   He)
            psi = W_tab / (GAS_CONSTANT * T)

            # ===== pressure correctors (inherited block)
            rho_fn = lambda pp: pp * psi
            p_prev, U_prev = p, U
            rhoU_old = self._face_flux(rho_old, U_old)
            p, phi, phi_b, U, dpdt, rho, p_res = self._pressure_loop(
                p, p_old, psi, rho_fn, HbyA, rAU, dt, rho_old,
                (s.phi, s.phi_b), rhoU_old, diag)
            diag[f"p_res_{outer}"] = p_res
            if outer < cfg.n_outer - 1:
                p = p_prev + cfg.p_relax * (p - p_prev)
                U = U_prev + cfg.u_relax * (U - U_prev)
                rho = rho_fn(p)
                dpdt = (p - p_old) / dt

        diag["T_min"] = T.min()
        diag["T_max"] = T.max()
        diag["c_max"] = c.max()
        if self.m_k is not None:
            diag["k_max"] = k.max()
        return FGMFLState(rho=rho, U=U, p=p, Z=Z, Zvar=Zvar, c=c, cvar=cvar,
                          Zcvar=Zcvar, T=T, He=He, k=k, eps=eps, phi=phi,
                          phi_b=phi_b, dpdt=dpdt, time=s.time + dt), diag
