"""Low-Mach pressure-based PIMPLE reacting-flow solver (the flagship step).

Port of deepflame_tpu/solvers/low_mach.py (dfLowMachFoam parity). One step:

    chemistry (operator split, once per step)
    while PIMPLE outer:
        rhoEqn -> UEqn -> YEqn -> EEqn -> correctThermo
        while pressure correctors: pEqn

on the structured mesh. The species (and the three velocity components) are
solved as one batched Krylov solve over a leading dimension, each lane with
its own convergence and iteration count, as the JAX package's vmapped solves
are. Where the lanes have their own boundary conditions (`bcs_Y` a list of
FieldBCs, one per species; velocity components whose BCs differ) the JAX
package solves the fields one after another; here their BCs are stacked
along the lane axis (`mesh.structured.stack_bcs`) and the solve stays one
batch, one stencil-kernel launch per matvec, each lane computing what the
sequential solve computes. The momentum rAU comes from lane 0's diagonal, as
the JAX package's comes from component 0's.

Matvecs go through the stencil kernel; the pressure CG matvec through the
Helmholtz kernel (on the CPU, their plain versions), preconditioned by
Jacobi or by a geometric-multigrid V-cycle whose levels run the Helmholtz
kernel too (`LowMachConfig.p_precond`).

Mixing models (EDC, PaSR) read the SGS (or RAS) k, epsilon and nu,
computed before the chemistry for the models whose `reads_turb` is set;
PaSR's dynamicScale advances its own Z, Zvar and Chi there (`cscalars` of
the state, BCs `bcs_Z`), each transport one batched solve on the stencil
kernel. A RAS model (turbulence.ras) carries its (k, eps) or (k, omega) in
`turb`: mu_t comes from `mu_t_from` and the model's `advance` runs at the
end of the step. `step(s, dt, sources)` takes the spray cloud's Srho, SU,
Sh and SY (added to species SY_index) where the JAX step puts them.

A shard of a distributed step (parallel.distributed) is this solver on its
block of the mesh with processor BCs on the split axes: its matrices then
apply through pad_field (stencil() gives way, the diagonal comes from the
coloring probes), the pressure CG through the padded Helmholtz kernel, and
the fixed boundary fluxes apply on the first and last shard only. The JAX
config's `use_pallas` chose a TPU kernel and has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import torch

from ..chemistry.thermo import ThermoData
from ..chemistry.transport import TransportData
from ..combustion.basic import CombustionModel
from ..mesh.energy_bcs import resolve_energy_bcs
from ..mesh.structured import (StructuredMesh, _edge_masks, cyclic, empty,
                               pad_field, processor, processor_parts,
                               stack_bcs, zero_gradient)
from ..ops.fv import (_face_diff, div_explicit, div_flux, face_pair,
                      fvm_ddt, fvm_div, fvm_laplacian, fvm_source_implicit,
                      grad, interpolate, interpolate_cubic,
                      multivariate_limiter)
from ..ops.kernels import helmholtz_operator, stencil7_apply
from ..ops.linsolve import cg, solve_fvmatrix
from ..ops.multigrid import make_mg_preconditioner
from ..parallel.context import gmax, gmean, gmin

__all__ = ["LowMachConfig", "LowMachState", "LowMachSolver"]


class LowMachState(NamedTuple):
    """Vectors are (3, nx, ny, nz); species (ns, nx, ny, nz); phi is a
    per-axis tuple of face mass-flux densities rho*u_f [kg/m^2/s]."""
    rho: torch.Tensor
    U: torch.Tensor
    p: torch.Tensor
    ha: torch.Tensor          # absolute enthalpy [J/kg]
    Y: torch.Tensor
    T: torch.Tensor
    phi: tuple
    dpdt: torch.Tensor
    time: torch.Tensor
    turb: tuple = ()          # RAS fields (k, eps or omega); () without
                              # a RAS model
    cscalars: tuple = ()      # combustion-model-owned fields (PaSR
                              # dynamicScale Z, Zvar, Chi), else ()
    chem_dt: Any = None       # per-cell warm-start chemistry step, or None


@dataclasses.dataclass(frozen=True)
class LowMachConfig:
    n_outer: int = 1          # nOuterCorrectors (1 = PISO mode)
    n_corr: int = 2           # pressure correctors
    n_nonortho: int = 0       # extra pressure solves with the non-orthogonal
                              # correction rebuilt from the latest p (face-
                              # list meshes whose faces carry k_no)
    p_relax: float = 0.3      # pressure under-relaxation between outers
    u_relax: float = 0.7      # velocity under-relaxation between outers
    div_scheme: str = "limitedLinear"
    div_scheme_U: str = "linear"
    div_scheme_Y: str = "limitedLinear01"
    mv_convection: str = "per-field"   # per-field | group-min | upwind
    u_tol: float = 1e-7
    p_tol: float = 1e-7
    p_rel_tol: float = 1e-2
    h_tol: float = 1e-8
    y_tol: float = 1e-9
    max_iter_u: int = 100
    max_iter_p: int = 500
    p_precond: str = "jacobi"          # jacobi | mg (geometric multigrid)
    unity_lewis: bool = False
    solve_energy: bool = True          # False freezes ha (and so T)
    chemistry: bool = True
    chemistry_dt_scale: float = 1.0    # 2.0 for splittingStrategy chem steps
    inert_index: int | None = None     # species closed as 1 - sum(others)
    gravity: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class LowMachSolver:
    """The solver runs where its mesh lives (StructuredMesh.box's device);
    thermo, transport and kinetics tables must be on the same device."""
    mesh: StructuredMesh
    thermo: ThermoData
    transport: TransportData
    combustion: CombustionModel
    bcs_U: tuple          # per-component FieldBCs (3,)
    bcs_p: Any
    bcs_h: Any
    bcs_Y: Any            # one FieldBCs shared by the species, or a list
                          # of FieldBCs, one per species
    bcs_rho: Any
    config: LowMachConfig = LowMachConfig()
    turbulence: Any = None     # LESModel, KEpsilon, KOmegaSST or None
    bcs_Z: Any = None          # BCs of combustion-owned scalars (PaSR
                               # dynamicScale's Z); default bcs_coeff
    thermo_tran_nn: Any = None  # callable (T, p, Yt) -> dict of any of mu,
                                # alpha, rhoD (species first) overriding the
                                # transport fits (a transport surrogate)

    def __post_init__(self):
        dev = self.mesh.device
        kinetics = getattr(self.combustion, "kinetics", None)
        for name, obj in (("thermo", self.thermo),
                          ("transport", self.transport),
                          ("kinetics", kinetics)):
            if obj is None:         # the FGM solver reads a table instead
                continue
            t = obj.W
            if t.device != dev and not (t.device.type == dev.type == "cuda"):
                raise ValueError(f"{name} tables are on {t.device}, the mesh "
                                 f"on {dev}")
        if self.config.p_precond not in ("jacobi", "mg"):
            raise ValueError(f"p_precond {self.config.p_precond!r}: jacobi "
                             "or mg")

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def dtype(self) -> torch.dtype:
        return self.thermo.W.dtype

    # -------------------------------------------------------------- helpers
    @functools.cached_property
    def bcs_Y_lanes(self):
        """The species' BCs for their batched solve: `bcs_Y` itself when the
        species share it, else the list stacked along the lane axis."""
        if isinstance(self.bcs_Y, list):
            return stack_bcs(self.bcs_Y, self.mesh, self.dtype)
        return self.bcs_Y

    @functools.cached_property
    def bcs_U_lanes(self):
        """The velocity components' BCs for their batched solve (stacked
        where the components' BCs differ)."""
        return stack_bcs(list(self.bcs_U), self.mesh, self.dtype)

    @property
    def bcs_coeff(self):
        """Value-neutral BCs for interpolating coefficient fields to faces:
        one-sided extrapolation at physical boundaries, exact wrap on cyclic
        axes. A processor side keeps its neighbour shard's halo; only its
        domain-edge BC is made neutral."""
        def neutral(bc):
            if bc.kind == "processor":
                name, gbc = processor_parts(bc)
                return processor(name, neutral(gbc))
            if bc.kind == "cyclic":
                return cyclic()
            if bc.kind == "empty":
                return empty()
            return zero_gradient()
        return tuple(tuple(neutral(self.bcs_p[ax][side]) for side in (0, 1))
                     for ax in range(3))

    def _face_flux(self, rho, U):
        """phi = (rho U)_f per axis from cell fields."""
        return tuple(interpolate(pad_field(rho * U[ax], self.bcs_U[ax],
                                           self.mesh), ax) for ax in range(3))

    def _mixture_update(self, p, T, Y):
        """Transport + thermo coefficient fields (mu, alpha, rhoD)."""
        Yt = torch.movedim(Y, 0, -1)
        X = self.thermo.mole_fractions(Yt)
        mu = self.transport.mu_mix(T, X)
        kappa = self.transport.lambda_mix(T, X)
        alpha = kappa / self.thermo.cp_mass(T, Yt)
        if self.config.unity_lewis:
            rhoD = torch.broadcast_to(alpha, Y.shape)
        else:
            Dm = self.transport.mix_diff_coeffs(T, p, X, Yt)
            rho = self.thermo.rho(p, T, Yt)
            rhoD = torch.movedim(rho[..., None] * Dm, -1, 0)
        if self.thermo_tran_nn is not None:
            nn = self.thermo_tran_nn(T, p, Yt)
            mu = nn.get("mu", mu)
            alpha = nn.get("alpha", alpha)
            rhoD = nn.get("rhoD", rhoD)
        return mu, alpha, rhoD

    def initial_state(self, p, T, Y, U=None, time: float = 0.0,
                      k0: float = 1e-3, eps0: float = 1e-2,
                      Z0=None) -> LowMachState:
        """State from p, T (nx, ny, nz), Y (ns, nx, ny, nz) and U (3, nx, ny,
        nz), given as tensors or arrays; placed on the solver's device in the
        thermo tables' dtype. Z0: the initial mixture fraction of a model
        with transported scalars (PaSR dynamicScale; default 0). k0, eps0:
        the RAS fields' initial values (turbulence.initial_fields)."""
        dtype, dev = self.dtype, self.device
        f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
        p, T, Y = f(p), f(T), f(Y)
        sh = self.mesh.shape
        U = torch.zeros((3,) + sh, dtype=dtype, device=dev) if U is None else f(U)
        Yt = torch.movedim(Y, 0, -1)
        rho = self.thermo.rho(p, T, Yt)
        turb = ()
        if self.is_ras:
            turb = self.turbulence.initial_fields(sh, dtype, k0, eps0,
                                                  device=dev)
        cscalars = ()
        if getattr(self.combustion, "n_aux", 0):
            cscalars = self.combustion.aux_init(sh, dtype, Z0)
        chem_dt = None
        if self.config.chemistry:
            chem_dt = torch.full(sh, self.combustion.ode_opts.dt_init,
                                 dtype=dtype, device=dev)
        return LowMachState(rho=rho, U=U, p=p, ha=self.thermo.h_mass(T, Yt),
                            Y=Y, T=T, phi=self._face_flux(rho, U),
                            dpdt=torch.zeros(sh, dtype=dtype, device=dev),
                            time=f(time), turb=turb, cscalars=cscalars,
                            chem_dt=chem_dt)

    @property
    def is_ras(self) -> bool:
        return getattr(self.turbulence, "is_ras", False)

    def _mu_t(self, rho, U, turb):
        """Eddy viscosity: the RAS model's from its transported pair, else
        the LES model's from the velocity gradient."""
        if self.is_ras:
            return self.turbulence.mu_t_from(rho, turb[0], turb[1])
        return self.turbulence.mu_t(rho, U, self.bcs_U, self.mesh)

    def _turb_q(self, s: LowMachState, dt, stats: dict):
        """The turbulence fields a mixing model reads (SGS or RAS k,
        epsilon and nu from the start-of-step state) and the model's
        transported scalars advanced over dt: (turb_q, cscalars)."""
        mesh = self.mesh
        rho, U, T, p = s.rho, s.U, s.T, s.p
        mu0, _, _ = self._mixture_update(p, T, s.Y)
        mu_t0 = self._mu_t(rho, U, s.turb)
        if self.is_ras:
            k_sgs, eps_sgs = self.turbulence.k_eps(s.turb)
        else:
            k_sgs, eps_sgs = self.turbulence.sgs_k_epsilon(mu_t0, rho, mesh)
        turb_q = dict(k=k_sgs, epsilon=eps_sgs, nu=mu0 / rho)
        cscalars = s.cscalars
        if getattr(self.combustion, "n_aux", 0):
            bz = self.bcs_Z if self.bcs_Z is not None else self.bcs_coeff
            cscalars = self.combustion.aux_advance(
                cscalars, rho, s.rho, s.phi, U, T, p, mu0 + mu_t0, mu_t0,
                k_sgs, eps_sgs, dt, mesh, bz, self.bcs_U, self.bcs_coeff,
                self.config.div_scheme, stats=stats)
            turb_q["Zvar"], turb_q["Chi"] = cscalars[1], cscalars[2]
        return turb_q, cscalars

    # ----------------------------------------------------------------- step
    def step(self, s: LowMachState, dt,
             sources=None) -> tuple[LowMachState, dict]:
        """One PIMPLE step. sources: the spray coupling dict Srho, SU (3,
        ...), Sh, SY and SY_index (the species that takes SY), or None."""
        cfg = self.config
        mesh = self.mesh
        dtype = s.T.dtype
        ns = s.Y.shape[0]

        rho_old, U_old, p_old, ha_old, Y_old = s.rho, s.U, s.p, s.ha, s.Y
        phi = s.phi
        rho, U, p, ha, Y, T = s.rho, s.U, s.p, s.ha, s.Y, s.T
        bcs_h = resolve_energy_bcs(self.bcs_h, T, Y, self.thermo, mesh,
                                   self.bcs_Y)
        dpdt = s.dpdt
        diag = {}

        # ===== chemistry (operator split, once per step)
        cscalars = s.cscalars
        if cfg.chemistry:
            turb_q = None
            if self.turbulence is not None and self.combustion.reads_turb:
                turb_q, cscalars = self._turb_q(s, dt, diag)
            chem = self.combustion.correct(
                T, p, torch.movedim(Y, 0, -1), dt * cfg.chemistry_dt_scale,
                turb_q, dt_start=s.chem_dt)
            chem_dt_new = chem.dt_next if chem.dt_next is not None else s.chem_dt
            # splittingStrategy: the scaled-dt fractional chemistry step
            # applies its full change within this transport step
            RR = torch.movedim(chem.RR, -1, 0) * cfg.chemistry_dt_scale
            diag["Qdot_max"] = gmax(chem.Qdot)
        else:
            RR = torch.zeros_like(Y)
            chem_dt_new = s.chem_dt
        src_rho = sources["Srho"] if sources else None
        if sources is not None and sources.get("SY_index") is not None:
            RR = RR.clone()
            RR[sources["SY_index"]] += sources["SY"]

        for outer in range(cfg.n_outer):
            # ===== rhoEqn (explicit continuity, + the spray's mass)
            rho = rho_old - dt * div_flux(phi, mesh)
            if src_rho is not None:
                rho = rho + dt * src_rho

            # ===== coefficient fields (molecular + SGS or RAS effective)
            mu, alpha, rhoD = self._mixture_update(p, T, Y)
            mu_mol = mu
            if self.turbulence is not None:
                mu_t = self._mu_t(rho, U, s.turb)
                mu = mu + mu_t
                alpha = alpha + mu_t / self.turbulence.Pr_t
                rhoD = rhoD + mu_t[None] / self.turbulence.Sc_t

            # ===== UEqn
            U, HbyA, rAU = self._momentum(
                rho, rho_old, U, U_old, phi, p, mu, dt,
                SU=sources["SU"] if sources else None, stats=diag)

            # ===== YEqn: all species in one batched solve
            lim_mv = None
            scheme_h = "upwind" if cfg.mv_convection == "upwind" else cfg.div_scheme
            if ns > 1:
                bcs_y = self.bcs_Y_lanes
                gY = grad(Y, bcs_y, mesh)                     # (3, ns, ...)
                sumYDiff = (rhoD[None] * gY).sum(1)
                phiUc = tuple(interpolate(pad_field(sumYDiff[ax], self.bcs_coeff,
                                                    mesh), ax) for ax in range(3))
                scheme_Y = cfg.div_scheme_Y
                if cfg.mv_convection == "group-min":
                    PY = pad_field(Y, bcs_y, mesh)
                    flds = list(PY) + [pad_field(ha, bcs_h, mesh)]
                    lim_mv = multivariate_limiter(
                        flds, phi, mesh, [bcs_y] * ns + [bcs_h], "limitedLinear",
                        1.0, bounded01=tuple([True] * ns + [False]))
                elif cfg.mv_convection == "upwind":
                    scheme_Y = "upwind"
                D_f = tuple(interpolate(pad_field(rhoD, self.bcs_coeff, mesh), ax)
                            for ax in range(3))
                eqn = (fvm_ddt(rho, Y_old, dt, mesh, bcs_y, coeff_old=rho_old)
                       + fvm_div(phi, Y, mesh, bcs_y, scheme_Y,
                                 limiter_override=lim_mv)
                       + fvm_div(phiUc, Y, mesh, bcs_y, "upwind",
                                 limiter_override=lim_mv, weight_flux=phi)
                       + fvm_laplacian(D_f, mesh, bcs_y, dtype=dtype, sign=-1.0)
                       ).with_source(RR)
                res = solve_fvmatrix(eqn, Y, tol=cfg.y_tol,
                                     max_iter=cfg.max_iter_u)
                Y_in = Y
                Y = torch.clamp(res.x, 0.0, 1.0)
                diag["iters_Y"] = res.iterations.max()
                if cfg.inert_index is not None:
                    i = cfg.inert_index
                    # the inert lane was solved as a throwaway: restore it,
                    # then close it as 1 - sum(others)
                    Y = Y.clone()
                    Y[i] = Y_in[i]
                    others = Y.sum(0) - Y[i]
                    Y[i] = torch.clamp(1.0 - others, 0.0, 1.0)
                else:
                    Y = Y / Y.sum(0, keepdim=True)

            # ===== EEqn, absolute enthalpy form
            alpha_f = tuple(interpolate(pad_field(alpha, self.bcs_coeff, mesh),
                                        ax) for ax in range(3))
            K = 0.5 * (U * U).sum(0)
            K_old = 0.5 * (U_old * U_old).sum(0)
            dKdt = (rho * K - rho_old * K_old) / dt + div_explicit(
                phi, K, self.bcs_coeff, mesh, cfg.div_scheme)
            hcorr_div = 0.0
            if ns > 1:
                # enthalpy-diffusion correction div(sum_i h_i (rhoD_i - alpha)
                # grad Y_i), interpolated with the cubic scheme
                h_sp = torch.movedim(self.thermo.h_species(T), -1, 0)
                hcorr = (h_sp[None] * (rhoD - alpha)[None] * gY).sum(1)
                hcorr_f = tuple(interpolate_cubic(
                    pad_field(hcorr[ax], self.bcs_coeff, mesh), ax,
                    self.bcs_coeff) for ax in range(3))
                hcorr_div = div_flux(hcorr_f, mesh)
            eqn_h = (fvm_ddt(rho, ha_old, dt, mesh, bcs_h, coeff_old=rho_old)
                     + fvm_div(phi, ha, mesh, bcs_h, scheme_h,
                               limiter_override=lim_mv)
                     + fvm_laplacian(alpha_f, mesh, bcs_h, dtype=dtype,
                                     sign=-1.0))
            src_h = dpdt - dKdt + hcorr_div
            if sources:
                src_h = src_h + sources["Sh"]
            eqn_h = eqn_h.with_source(src_h)
            if cfg.solve_energy:
                res_h = solve_fvmatrix(eqn_h, ha, tol=cfg.h_tol,
                                       max_iter=cfg.max_iter_u)
                ha = res_h.x
                diag["iters_h"] = res_h.iterations

            # ===== correctThermo: T from (ha, Y)
            Yt = torch.movedim(Y, 0, -1)
            T = self.thermo.T_from_h(ha, Yt, T)
            psi = self.thermo.psi(T, Yt)

            # ===== pEqn correctors
            rho_fn = lambda pp: self.thermo.rho(pp, T, Yt)
            p_prev, U_prev = p, U
            p, phi, U, dpdt, rho, p_res = self._pressure_loop(
                p, p_old, psi, rho_fn, HbyA, rAU, dt, rho_old=rho_old,
                phi_old=s.phi, rhoU_old_f=self._face_flux(rho_old, U_old),
                src_rho=src_rho, stats=diag)
            diag[f"p_res_{outer}"] = p_res
            if outer < cfg.n_outer - 1:
                p = p_prev + cfg.p_relax * (p - p_prev)
                U = U_prev + cfg.u_relax * (U - U_prev)
                rho = rho_fn(p)
                dpdt = (p - p_old) / dt

        # ===== turbulence->correct(): RAS transport at the end of the step
        turb = s.turb
        if self.is_ras:
            k_new, eps_new, _ = self.turbulence.advance(
                turb[0], turb[1], rho, rho_old, phi, U, mu_mol, self.bcs_U,
                self.bcs_coeff, mesh, dt)
            turb = (k_new, eps_new)
            diag["k_max"] = gmax(k_new)

        rho_eos = self.thermo.rho(p, T, torch.movedim(Y, 0, -1))
        diag["continuity_err"] = gmax((rho_eos - rho).abs()) / gmean(rho)
        diag["T_min"] = gmin(T)
        diag["T_max"] = gmax(T)
        return LowMachState(rho=rho, U=U, p=p, ha=ha, Y=Y, T=T, phi=phi,
                            dpdt=dpdt, time=s.time + dt, turb=turb,
                            cscalars=cscalars, chem_dt=chem_dt_new), diag

    def courant(self, s: LowMachState, dt) -> torch.Tensor:
        """Largest Courant number, max over the axes of gmax(|U_ax|) dt /
        h_ax (compressibleCourantNo.H), a 0-d tensor."""
        co = torch.zeros((), dtype=s.U.dtype, device=s.U.device)
        for ax, h in enumerate(self.mesh.spacing):
            co = torch.maximum(co, gmax(s.U[ax].abs()) * dt / h)
        return co

    # ---------------------------------------------- shared PIMPLE blocks
    def _grad_comp(self, f, ax: int):
        """Component ax of grad(f) with the coefficient BCs."""
        P = pad_field(f, self.bcs_coeff, self.mesh)
        return _face_diff(interpolate(P, ax), ax) / self.mesh.spacing[ax]

    def _momentum(self, rho, rho_old, U, U_old, phi, p, mu, dt, SU=None,
                  stats=None):
        """Implicit momentum predictor: returns (U, HbyA, rAU). The three
        components are solved as one batch; rAU is lane 0's. SU: the
        spray's momentum source (3, ...), or None."""
        mesh = self.mesh
        cfg = self.config
        dtype = p.dtype
        gp = grad(p, self.bcs_p, mesh)
        mu_f = tuple(interpolate(pad_field(mu, self.bcs_coeff, mesh), ax)
                     for ax in range(3))
        gU = [grad(U[c], self.bcs_U[c], mesh) for c in range(3)]
        divU = gU[0][0] + gU[1][1] + gU[2][2]
        # explicit part of div(mu dev2(grad U)^T): transpose + dilatation
        g_div = grad(mu * divU, self.bcs_coeff, mesh)
        corrs = [(self._grad_comp(mu * gU[0][c], 0)
                  + self._grad_comp(mu * gU[1][c], 1)
                  + self._grad_comp(mu * gU[2][c], 2)
                  - g_div[c] * (2.0 / 3.0)) for c in range(3)]
        srcs = torch.stack([-gp[c] + corrs[c]
                            + (SU[c] if SU is not None else 0.0)
                            + (rho * cfg.gravity[c] if cfg.gravity[c] else 0.0)
                            for c in range(3)])
        bcs_u = self.bcs_U_lanes
        eqn = (fvm_ddt(rho, U_old, dt, mesh, bcs_u, coeff_old=rho_old)
               + fvm_div(phi, U, mesh, bcs_u, cfg.div_scheme_U or cfg.div_scheme)
               + fvm_laplacian(mu_f, mesh, bcs_u, dtype=dtype, sign=-1.0)
               ).with_source(srcs)
        st = eqn.stencil()
        res = solve_fvmatrix(eqn, U, tol=cfg.u_tol, max_iter=cfg.max_iter_u,
                             stencil=st)
        # H = b - (A - D) x excludes the pressure gradient, which the matrix
        # carries in its source for the solve: add it back
        if st is not None:
            D, lo, hi = st
            Ax = stencil7_apply(res.x, D, lo, hi)
        else:                               # processor sides
            D = eqn.diag()
            Ax = eqn.apply(res.x)
        H = eqn.rhs() - (Ax - D * res.x) + gp
        if stats is not None:
            stats["iters_U"] = res.iterations.max()
        u_diag = D[0]
        return res.x, [H[c] / u_diag for c in range(3)], 1.0 / u_diag

    def _fix_boundary_fluxes(self, phi, rho_f):
        """Impose prescribed mass fluxes on fixed-velocity boundary faces.
        On a processor axis only the first (low side) and the last shard
        (high side) hold a domain boundary: elsewhere the face is interior."""
        out = list(phi)
        for ax in range(3):
            for side in (0, 1):
                bc = self.bcs_U[ax][ax][side]   # normal component, this axis
                if bc.kind == "processor":
                    name, bc = processor_parts(bc)
                    if not _edge_masks(name)[side]:
                        continue
                if bc.kind in ("fixedValue", "symmetryNegate", "inletOutlet"):
                    u_bc = 0.0 if bc.kind == "symmetryNegate" else bc.value
                    f = out[ax].clone()
                    idx = 0 if side == 0 else f.shape[ax] - 1
                    f.narrow(ax, idx, 1).copy_(
                        torch.broadcast_to(rho_f[ax].narrow(ax, idx, 1) * u_bc,
                                           f.narrow(ax, idx, 1).shape))
                    out[ax] = f
        return tuple(out)

    def _pressure_loop(self, p, p_old, psi, rho_fn, HbyA, rAU, dt,
                       rho_old=None, phi_old=None, rhoU_old_f=None,
                       src_rho=None, stats=None):
        """Compressible pressure correctors: returns (p, phi, U, dpdt, rho,
        last initial residual). src_rho: the spray's mass source, in the
        pressure equation and the continuity density, or None. The CG matvec
        is the Helmholtz kernel on the iterate, its ghosts computed inside
        the kernel from the pressure BCs (ops.kernels.helmholtz_operator);
        the preconditioner is Jacobi on the
        exact stencil diagonal or one multigrid V-cycle, whose hierarchy is
        built at the first corrector and shared by the others."""
        mesh = self.mesh
        cfg = self.config
        dtype = p.dtype
        p_res = torch.zeros((), dtype=dtype, device=p.device)
        M_inv_mg = None
        matvec_p = helmholtz_operator(self.bcs_p, mesh)
        for _ in range(cfg.n_corr):
            rho = rho_fn(p)
            rho_f = tuple(interpolate(pad_field(rho, self.bcs_rho, mesh), ax)
                          for ax in range(3))
            phiHbyA = tuple(
                rho_f[ax] * interpolate(pad_field(HbyA[ax], self.bcs_U[ax],
                                                  mesh), ax)
                for ax in range(3))
            # rhorAUf is the face interpolation of the PRODUCT rho*rAU
            rhorAUf = tuple(interpolate(pad_field(rho * rAU, self.bcs_coeff,
                                                  mesh), ax)
                            for ax in range(3))
            if phi_old is not None and rhoU_old_f is not None:
                # fvc::ddtCorr with the ddtCouplingCoeff limiter
                def _ddt_corr(ax):
                    corr = phi_old[ax] - rhoU_old_f[ax]
                    coeff = 1.0 - torch.clamp(
                        corr.abs() / (phi_old[ax].abs() + 1e-15), max=1.0)
                    return rhorAUf[ax] * coeff * corr / dt
                phiHbyA = tuple(phiHbyA[ax] + _ddt_corr(ax) for ax in range(3))
            phiHbyA = self._fix_boundary_fluxes(phiHbyA, rho_f)
            rho_prev = rho_old if rho_old is not None else psi * p_old
            coeff_d = psi / dt
            eqn_p = (fvm_source_implicit(coeff_d, mesh, self.bcs_p, dtype=dtype)
                     + fvm_laplacian(rhorAUf, mesh, self.bcs_p, dtype=dtype,
                                     sign=-1.0))
            src_p = rho_prev / dt - div_flux(phiHbyA, mesh)
            if src_rho is not None:
                src_p = src_p + src_rho
            eqn_p = eqn_p.with_source(src_p)
            apply_A = lambda x: matvec_p(x, rhorAUf, coeff_d)
            if cfg.p_precond == "mg":
                if M_inv_mg is None:
                    M_inv_mg = make_mg_preconditioner(mesh, self.bcs_p,
                                                      coeff_d, rhorAUf, dtype)
                M_inv = M_inv_mg
            else:
                st_p = eqn_p.stencil()
                d_p = st_p[0] if st_p is not None else eqn_p.diag()
                d_inv = 1.0 / torch.where(d_p.abs() > 1e-300, d_p,
                                          torch.ones_like(d_p))
                M_inv = lambda r: d_inv * r
            res_p = cg(apply_A, eqn_p.rhs(), p, M_inv, tol=cfg.p_tol,
                       rel_tol=cfg.p_rel_tol, max_iter=cfg.max_iter_p)
            p = res_p.x
            p_res = res_p.initial_residual
            if stats is not None:
                stats["iters_p"] = stats.get("iters_p", 0) + res_p.iterations
            # flux reconstruction: phi = phiHbyA - rhorAUf * snGrad(p)
            Pp = pad_field(p, self.bcs_p, mesh)
            phi = tuple(phiHbyA[ax] - rhorAUf[ax] * _sngrad(Pp, ax,
                                                            mesh.spacing[ax])
                        for ax in range(3))
            phi = self._fix_boundary_fluxes(phi, rho_f)
            gp = grad(p, self.bcs_p, mesh)
            U = torch.stack([HbyA[c] - rAU * gp[c] for c in range(3)])
            dpdt = (p - p_old) / dt
        # density going forward is the continuity-consistent one
        if rho_old is not None:
            rho = rho_old - dt * div_flux(phi, mesh)
            if src_rho is not None:
                rho = rho + dt * src_rho
        else:
            rho = rho_fn(p)
        return p, phi, U, dpdt, rho, p_res


def _sngrad(P_padded, axis, h):
    own, nei = face_pair(P_padded, axis)
    return (nei - own) / h
