"""Low-Mach PIMPLE solver on the face-list backend (general meshes).

Port of deepflame_tpu/solvers/low_mach_fl.py: the dfLowMachFoam loop of
solvers/low_mach.py (chemistry, then rhoEqn, UEqn, YEqn, EEqn,
correctThermo and the pEqn correctors with Rhie-Chow ddtCorr), discretised
by gathers over owner/neighbour and ELL row sums (ops/fv_facelist.py), so
any mesh given as owner/neighbour face lists (blockMesh, polyMesh) runs the
same step; on meshes with a shift plan (mesh.facelist.from_structured,
graded_box) the gathers are lattice slices and every Krylov solve runs on
the (nx, ny, nz) lattice through the `stencil7_apply` kernel.

State layout is flat cells as in the JAX package: scalars (n,), vectors
(n, 3), species (n, ns), interior face flux (nf,) and per-patch boundary
fluxes. Each field has its own FaceListMesh carrying its boundary
coefficients over one geometry; species may come in BC groups
(`m_Y_groups`). Each group's species, and the three velocity components,
are one batched Krylov solve with per-lane convergence and counts (the JAX
package vmaps the scalar solve). The pressure CG runs on the lattice with
the V/V_mean row scaling folded into the stencil on plan meshes; otherwise,
with `p_ell` set, its matvec is the ELLPACK SpMV kernel `ell_matvec` on the
card. `p_mg` (ops.amg_fl.make_amg_fl) preconditions it with the
aggregation-AMG V-cycle instead of Jacobi (on one device: a shard of
parallel.distributed_fl takes Jacobi, its reductions over the shard group
and its halo rows refreshed by the mesh's `exchange`). RAS: k-epsilon, standard or RNG
(`rng_keps_kwargs`), with `m_k`, `m_eps` and optional face-list wall
functions (turbulence.wall_functions_fl); (k, eps) travel in the state's
`turb`. Spray `sources` (Srho, SU, Sh, SY at SY_index) enter continuity,
momentum, energy, the fuel species and the pressure equation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..mesh.facelist import FaceListMesh
from ..ops.fv_facelist import (FvMatrixFL, _boundary_face_value,
                               _has_nonortho, _segment_sum, div_flux_fl,
                               face_grad_fl, flux_normal_fl, fvm_ddt_fl,
                               fvm_div_fl, fvm_laplacian_corrected_fl,
                               fvm_laplacian_fl, fvm_source_implicit_fl,
                               grad_fl, grad_multi_fl, interpolate_fl,
                               laplacian_nonortho_corr_fl, sngrad_fl)
from ..ops.fv_facelist import lattice_operands
from ..ops.kernels import stencil7_apply
from ..ops.linsolve import cg, solve_fvmatrix
from ..parallel.context import gmax, gmean, gmin
from .low_mach import LowMachConfig

__all__ = ["LowMachFLState", "LowMachSolverFL", "rng_keps_kwargs",
           "make_step_fl"]


def rng_keps_kwargs(C1: float = 1.42) -> dict:
    """Constructor kwargs of the RNG k-epsilon variant with its published
    constants (OpenFOAM RNGkEpsilon: Cmu 0.0845, C1 1.42, C2 1.68, sigmak =
    sigmaEps = 0.71942, eta0 4.38, beta 0.012). Cases may set C1 (the
    Sandia D flareFGM case: 1.52)."""
    return dict(keps_variant="RNG", Cmu=0.0845, C1=C1, C2=1.68,
                sigma_k=0.71942, sigma_eps=0.71942, eta0=4.38,
                beta_rng=0.012)


class LowMachFLState(NamedTuple):
    rho: torch.Tensor        # (n,)
    U: torch.Tensor          # (n, 3)
    p: torch.Tensor
    ha: torch.Tensor
    Y: torch.Tensor          # (n, ns)
    T: torch.Tensor
    phi: torch.Tensor        # (nf,) interior face mass-flux density
    phi_b: tuple             # per-patch boundary flux densities
    dpdt: torch.Tensor
    time: torch.Tensor
    chem_dt: Any = None      # per-cell warm-start chemistry step, or None
    turb: tuple = ()         # (k, eps) when RAS is on (m_k set)


def _face_product(m: FaceListMesh, q):
    """Face interpolation of a coefficient field q (n, ...) on interior
    faces, the owner value on boundary faces (the structured backend's
    bcs_coeff): (interior (nf, ...), per-patch list)."""
    return interpolate_fl(m, q), [q[p.owner] for p in m.patches]


@dataclasses.dataclass(frozen=True)
class LowMachSolverFL:
    """Per-field FaceListMesh instances carry each field's boundary
    coefficients over one geometry (GeneralMesh.with_bcs). m_Y is the
    species' shared BC mesh; m_Y_groups, when set, is ((mesh, (species
    index, ...)), ...): each group shares one BC mesh and one batched solve.
    p_ell: m_p.ell_connectivity(), computed once. m_k, m_eps: the BC meshes
    of the k-epsilon pair (RAS on when m_k is set), wall_fns a
    WallFunctionsFL; Cmu ... beta_rng its constants (the standard model's,
    or rng_keps_kwargs()'s with keps_variant "RNG"). p_mg: an AMGSetupFL of
    m_p's connectivity."""
    m_p: FaceListMesh
    m_h: FaceListMesh
    m_Y: FaceListMesh
    m_rho: FaceListMesh
    m_U: tuple               # (3,) per velocity component
    thermo: Any
    transport: Any
    combustion: Any
    config: LowMachConfig = LowMachConfig()
    m_k: Any = None
    m_eps: Any = None
    wall_fns: Any = None
    m_Y_groups: Any = None
    Cmu: float = 0.09
    C1: float = 1.44
    C2: float = 1.92
    sigma_k: float = 1.0
    sigma_eps: float = 1.3
    k_min: float = 1e-10
    eps_min: float = 1e-12
    Pr_t: float = 0.85
    Sc_t: float = 0.7
    keps_variant: str = "standard"   # standard | RNG
    eta0: float = 4.38
    beta_rng: float = 0.012
    p_mg: Any = None
    p_ell: Any = None
    les: Any = None

    def __post_init__(self):
        if self.keps_variant not in ("standard", "RNG"):
            raise ValueError(f"keps_variant {self.keps_variant!r}")
        dev = self.m_p.device
        # (the FGM solver may have no thermo, transport or combustion: the
        # manifold gives the thermochemistry)
        tables = (("thermo", self.thermo), ("transport", self.transport),
                  ("kinetics", getattr(self.combustion, "kinetics", None)))
        for name, t in ((k, v.W) for k, v in tables if v is not None):
            if t.device != dev and not (t.device.type == dev.type == "cuda"):
                raise ValueError(f"{name} tables are on {t.device}, the mesh "
                                 f"on {dev}")

    @property
    def mesh(self) -> FaceListMesh:
        return self.m_p

    @property
    def device(self) -> torch.device:
        return self.m_p.device

    @property
    def dtype(self) -> torch.dtype:
        return self.thermo.W.dtype

    # ------------------------------------------------------------- helpers
    def _mixture_update(self, p, T, Y):
        X = self.thermo.mole_fractions(Y)
        mu = self.transport.mu_mix(T, X)
        cp = self.thermo.cp_mass(T, Y)
        lam = self.transport.lambda_mix(T, X)
        alpha = lam / cp
        if self.config.unity_lewis:
            rhoD = torch.broadcast_to(alpha, (Y.shape[1],) + alpha.shape)
        else:
            rho = self.thermo.rho(p, T, Y)
            Dm = self.transport.mix_diff_coeffs(T, p, X, Y)   # (n, ns)
            rhoD = torch.movedim(rho[..., None] * Dm, -1, 0)
        return mu, alpha, rhoD                           # rhoD: (ns, n)

    def _face_flux(self, rho, U):
        """(interior phi, per-patch phi) of rho*U with the velocity
        components' boundary coefficients."""
        m = self.m_p
        q = rho[:, None] * U                            # (n, 3)
        phi = flux_normal_fl(m, q)
        phi_b = []
        for ip, p in enumerate(m.patches):
            if p.kind in ("symmetry", "wedge", "empty"):
                phi_b.append(torch.zeros_like(p.mag_sf))  # exact reflection
                continue
            vb = 0.0
            for c in range(3):
                pc = self.m_U[c].patches[ip]
                vb = vb + _boundary_face_value(pc, q[:, c]) * p.normal[:, c]
            phi_b.append(vb)
        return phi, tuple(phi_b)

    def initial_state(self, p, T, Y, U=None, time: float = 0.0, k0=1e-3,
                      eps0=1e-2) -> LowMachFLState:
        """State from p, T (n,), Y (n, ns) and U (n, 3), tensors or arrays,
        placed on the solver's device in the thermo tables' dtype; with RAS
        (k, eps) start uniform at (k0, eps0)."""
        dtype, dev = self.dtype, self.device
        f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
        p, T, Y = f(p), f(T), f(Y)
        n = T.shape[0]
        U = torch.zeros((n, 3), dtype=dtype, device=dev) if U is None else f(U)
        rho = self.thermo.rho(p, T, Y)
        phi, phi_b = self._face_flux(rho, U)
        chem_dt = None
        if self.config.chemistry and \
                getattr(self.combustion, "ode_opts", None) is not None:
            # warm-started per-cell chemistry substep, as the structured step
            chem_dt = torch.full((n,), self.combustion.ode_opts.dt_init,
                                 dtype=dtype, device=dev)
        turb = ()
        if self.m_k is not None:
            turb = (torch.full((n,), k0, dtype=dtype, device=dev),
                    torch.full((n,), eps0, dtype=dtype, device=dev))
        return LowMachFLState(rho=rho, U=U, p=p, ha=self.thermo.h_mass(T, Y),
                              Y=Y, T=T, phi=phi, phi_b=phi_b,
                              dpdt=torch.zeros(n, dtype=dtype, device=dev),
                              time=f(time), chem_dt=chem_dt, turb=turb)

    def _fix_boundary_fluxes(self, phi_b, rho_b_face):
        """Prescribed mass flux on fixed-normal-velocity patches: all three
        components fixed gives u_bc . n per face; otherwise the component of
        the patch's axis (n_axis, set from the host normals) decides."""
        fixed_kinds = ("fixedValue", "symmetryNegate", "inletOutlet")
        out = list(phi_b)
        for ip, p in enumerate(self.m_p.patches):
            if p.owner.shape[0] == 0:      # degenerate patch (e.g. axis)
                continue
            kinds = [self.m_U[c].patches[ip].kind for c in range(3)]
            if all(k in fixed_kinds for k in kinds):
                # the face value of every a = -1 component is b/2
                val = 0.0
                for c in range(3):
                    pc = self.m_U[c].patches[ip]
                    val = val + 0.5 * pc.b * p.normal[:, c]
                out[ip] = rho_b_face[ip] * val
                continue
            ax = p.n_axis
            pc = self.m_U[ax].patches[ip]
            if pc.kind in fixed_kinds:
                out[ip] = rho_b_face[ip] * 0.5 * pc.b * p.normal[:, ax]
        return tuple(out)

    def _keps_advance(self, k, eps, rho, rho_old, phi, phi_b, U, mu, dt):
        """One k-epsilon update on the face-list mesh: (k, eps, mu_t). The
        production is clipped at 10 rho eps; wall cells take the wall
        functions' production, eddy viscosity and pinned epsilon; the RNG
        variant's eps production coefficient is C1 - R(eta)."""
        cfg = self.config
        m = self.m_p
        mu_t = rho * self.Cmu * k * k / torch.clamp(eps, min=self.eps_min)
        gU = grad_multi_fl(self.m_U, U)                  # (n, i, j)
        S = 0.5 * (gU + gU.transpose(1, 2))
        SS = (S * S).sum((1, 2))
        divU = gU[:, 0, 0] + gU[:, 1, 1] + gU[:, 2, 2]
        P = mu_t * 2.0 * SS
        P = torch.minimum(P, 10.0 * rho * torch.clamp(eps, min=self.eps_min))
        wf = self.wall_fns
        if wf is not None:
            # wall-layer production with the wall-function eddy viscosity
            # (epsilonWallFunction uses the nut boundary field)
            mut_w = rho * wf.nut(rho, k, mu)
            P = wf.apply(wf.production(rho, k, mu, mut_w, U), P)
            mu_t = wf.apply(mut_w, mu_t)
        k_s = torch.clamp(k, min=self.k_min)
        C1_eff = self.C1
        if self.keps_variant == "RNG":
            # eta = sqrt(2 |dev(symm grad U)|^2) k / eps,
            # R = eta (1 - eta/eta0) / (1 + beta eta^3)
            S2_dev = 2.0 * torch.clamp(SS - divU * divU / 3.0, min=0.0)
            eta = torch.sqrt(S2_dev) * k_s / torch.clamp(eps, min=self.eps_min)
            R = eta * (1.0 - eta / self.eta0) / (1.0 + self.beta_rng * eta ** 3)
            C1_eff = self.C1 - R
        D_e, D_eb = _face_product(m, mu + mu_t / self.sigma_eps)
        eqn_e = (fvm_ddt_fl(self.m_eps, rho, rho_old, eps, dt)
                 + fvm_div_fl(self.m_eps, phi, list(phi_b), cfg.div_scheme,
                              x_now=eps)
                 + fvm_laplacian_corrected_fl(self.m_eps, D_e, D_eb, eps,
                                              sign=-1.0)
                 + fvm_source_implicit_fl(self.m_eps,
                                          self.C2 * rho * eps / k_s)
                 ).with_source(C1_eff * (eps / k_s) * P)
        res_e = solve_fvmatrix(eqn_e, eps, tol=1e-8, max_iter=cfg.max_iter_u)
        eps = torch.clamp(res_e.x, min=self.eps_min)
        if wf is not None:
            eps = wf.apply(wf.epsilon(k), eps)
        D_k, D_kb = _face_product(m, mu + mu_t / self.sigma_k)
        eqn_k = (fvm_ddt_fl(self.m_k, rho, rho_old, k, dt)
                 + fvm_div_fl(self.m_k, phi, list(phi_b), cfg.div_scheme,
                              x_now=k)
                 + fvm_laplacian_corrected_fl(self.m_k, D_k, D_kb, k,
                                              sign=-1.0)
                 + fvm_source_implicit_fl(self.m_k, rho * eps / k_s)
                 ).with_source(P)
        res_k = solve_fvmatrix(eqn_k, k, tol=1e-8, max_iter=cfg.max_iter_u)
        k = torch.clamp(res_k.x, min=self.k_min)
        mu_t = rho * self.Cmu * k * k / torch.clamp(eps, min=self.eps_min)
        return k, eps, mu_t

    # ---------------------------------------------------------------- step
    def step(self, s: LowMachFLState, dt, sources=None):
        """One PIMPLE step. sources: the spray coupling dict, Srho (n,), SU
        (3, n), Sh (n,), SY (n,) and SY_index (the fuel species), or
        None."""
        cfg = self.config
        m = self.m_p
        dtype = s.T.dtype
        n = s.T.shape[0]
        ns = s.Y.shape[1]
        diag = {}

        rho_old, U_old, p_old, ha_old, Y_old = s.rho, s.U, s.p, s.ha, s.Y
        rho, U, p, ha, Y, T = s.rho, s.U, s.p, s.ha, s.Y, s.T
        phi, phi_b = s.phi, s.phi_b
        dpdt = s.dpdt
        turb = s.turb

        # ===== chemistry (operator split, once per step)
        if cfg.chemistry:
            turb_q = None
            if self.m_k is not None:
                # k and epsilon for the mixing models (Laminar ignores them)
                mu0, _, _ = self._mixture_update(p, T, Y)
                turb_q = dict(k=turb[0], epsilon=turb[1], nu=mu0 / rho)
            elif self.les is not None:
                # SGS k and epsilon for mixing models (Laminar ignores them)
                mu0, _, _ = self._mixture_update(p, T, Y)
                mu_t0 = self.les.mu_t_fl(rho, U, self.m_U, m.volumes)
                k_sgs, eps_sgs = self.les.sgs_k_epsilon_fl(mu_t0, rho,
                                                           m.volumes)
                turb_q = dict(k=k_sgs, epsilon=eps_sgs, nu=mu0 / rho)
            chem = self.combustion.correct(
                T, p, Y, dt * cfg.chemistry_dt_scale, turb_q,
                dt_start=s.chem_dt)
            RR = chem.RR * cfg.chemistry_dt_scale        # (n, ns)
            chem_dt_new = chem.dt_next if chem.dt_next is not None \
                else s.chem_dt
        else:
            RR = torch.zeros_like(Y)
            chem_dt_new = s.chem_dt

        src_rho = sources["Srho"] if sources else None

        for outer in range(cfg.n_outer):
            # ===== rhoEqn (parcels.Srho)
            rho = rho_old - dt * div_flux_fl(m, phi, phi_b)
            if src_rho is not None:
                rho = rho + dt * src_rho

            # ===== coefficients, molecular + RAS or SGS effective
            mu, alpha, rhoD = self._mixture_update(p, T, Y)
            if self.m_k is not None:
                k_t, e_t, mu_t = self._keps_advance(
                    turb[0], turb[1], rho, rho_old, phi, phi_b, U, mu, dt)
                turb = (k_t, e_t)
                mu = mu + mu_t
                alpha = alpha + mu_t / self.Pr_t
                rhoD = rhoD + mu_t[None] / self.Sc_t
            elif self.les is not None:
                mu_t = self.les.mu_t_fl(rho, U, self.m_U, m.volumes)
                mu = mu + mu_t
                alpha = alpha + mu_t / self.les.Pr_t
                rhoD = rhoD + mu_t[None] / self.les.Sc_t
            mu_f, mu_bf = _face_product(m, mu)

            # ===== UEqn
            U, HbyA, rAU = self._momentum(rho, rho_old, U, U_old, phi, phi_b,
                                          p, mu_f, mu_bf, mu, dt, diag,
                                          SU=sources["SU"] if sources
                                          else None)

            # ===== YEqn, one batched solve per BC group
            gY_all = None
            if ns > 1:
                groups = self.m_Y_groups or ((self.m_Y, tuple(range(ns))),)
                if len(groups) == 1:
                    gY_all = grad_fl(groups[0][0], Y)      # (n, ns, 3)
                else:
                    gY_all = torch.zeros((n, ns, 3), dtype=dtype,
                                         device=Y.device)
                    for m_Yg, idx in groups:
                        gY_all[:, list(idx)] = grad_fl(m_Yg, Y[:, list(idx)])
                # sumYDiff_c = sum_i rhoD[i] gY[i, c]; its correction flux
                # density at faces, the owner value on the boundary
                sumYDiff = torch.einsum("in,nic->nc", rhoD, gY_all)
                phiUc = flux_normal_fl(m, sumYDiff)
                phiUc_b = [(sumYDiff[p_.owner] * p_.normal).sum(1)
                           for p_ in m.patches]
                srcs_Y = RR.T
                if sources is not None and sources.get("SY_index") is not None:
                    srcs_Y = srcs_Y.clone()
                    srcs_Y[sources["SY_index"]] += sources["SY"]
                it_ys = []
                Y_new = Y.clone()
                for m_Yg, idx in groups:
                    ii = list(idx)
                    rhoD_g = rhoD[ii]                             # (S, n)
                    y, y_old = Y.T[ii], Y_old.T[ii]
                    D_f, D_b = _face_product(m, rhoD_g.T)
                    eqn = (fvm_ddt_fl(m_Yg, rho, rho_old, y_old, dt)
                           + fvm_div_fl(m_Yg, phi, phi_b, cfg.div_scheme,
                                        x_now=y)
                           + fvm_div_fl(m_Yg, phiUc, phiUc_b, "upwind")
                           + fvm_laplacian_corrected_fl(
                               m_Yg, D_f.T, [d.T for d in D_b], y,
                               sign=-1.0)
                           ).with_source(srcs_Y[ii])
                    res = solve_fvmatrix(eqn, y, tol=cfg.y_tol,
                                         max_iter=cfg.max_iter_u)
                    Y_new[:, ii] = torch.clamp(res.x, 0.0, 1.0).T
                    it_ys.append(res.iterations.max())
                Y = Y_new
                diag["iters_Y"] = torch.stack(it_ys).max()
                if cfg.inert_index is not None:
                    i = cfg.inert_index
                    others = Y.sum(1) - Y[:, i]
                    Y[:, i] = torch.clamp(1.0 - others, 0.0, 1.0)
                else:
                    Y = Y / Y.sum(1, keepdim=True)

            # ===== EEqn, absolute enthalpy form
            alpha_f, alpha_b = _face_product(m, alpha)
            K = 0.5 * (U * U).sum(1)
            K_old = 0.5 * (U_old * U_old).sum(1)
            Kf, Kb = _face_product(m, K)
            dKdt = (rho * K - rho_old * K_old) / dt + div_flux_fl(
                m, phi * Kf, [fb * kb for fb, kb in zip(phi_b, Kb)])
            hcorr_div = 0.0
            if ns > 1:
                # enthalpy-diffusion correction div(sum_i h_i (rhoD_i -
                # alpha) grad Y_i)
                h_sp = self.thermo.h_species(T)          # (n, ns)
                coeff = h_sp * (rhoD.T - alpha[:, None])
                hcorr = torch.einsum("ni,nic->nc", coeff, gY_all)
                hc_f = flux_normal_fl(m, hcorr)
                hc_b = [(hcorr[p_.owner] * p_.normal).sum(1)
                        for p_ in m.patches]
                hcorr_div = div_flux_fl(m, hc_f, hc_b)
            eqn_h = (fvm_ddt_fl(self.m_h, rho, rho_old, ha_old, dt)
                     + fvm_div_fl(self.m_h, phi, phi_b, cfg.div_scheme,
                                  x_now=ha)
                     + fvm_laplacian_corrected_fl(self.m_h, alpha_f, alpha_b,
                                                  ha, sign=-1.0))
            src_h = dpdt - dKdt + hcorr_div
            if sources:
                src_h = src_h + sources["Sh"]
            eqn_h = eqn_h.with_source(src_h)
            if cfg.solve_energy:
                res_h = solve_fvmatrix(eqn_h, ha, tol=cfg.h_tol,
                                       max_iter=cfg.max_iter_u)
                ha = res_h.x
                diag["iters_h"] = res_h.iterations

            # ===== correctThermo
            T = self.thermo.T_from_h(ha, Y, T)
            psi = self.thermo.psi(T, Y)

            # ===== pEqn correctors
            rho_fn = lambda pp: self.thermo.rho(pp, T, Y)
            p_prev, U_prev = p, U
            rhoU_old = self._face_flux(rho_old, U_old)
            p, phi, phi_b, U, dpdt, rho, p_res = self._pressure_loop(
                p, p_old, psi, rho_fn, HbyA, rAU, dt, rho_old,
                (s.phi, s.phi_b), rhoU_old, diag, src_rho=src_rho)
            diag[f"p_res_{outer}"] = p_res
            if outer < cfg.n_outer - 1:
                p = p_prev + cfg.p_relax * (p - p_prev)
                U = U_prev + cfg.u_relax * (U - U_prev)
                rho = rho_fn(p)
                dpdt = (p - p_old) / dt

        rho_eos = self.thermo.rho(p, T, Y)
        diag["continuity_err"] = gmax((rho_eos - rho).abs()) / gmean(rho)
        diag["T_min"] = gmin(T)
        diag["T_max"] = gmax(T)
        if self.m_k is not None:
            diag["k_max"] = gmax(turb[0])
        return LowMachFLState(rho=rho, U=U, p=p, ha=ha, Y=Y, T=T, phi=phi,
                              phi_b=phi_b, dpdt=dpdt, time=s.time + dt,
                              chem_dt=chem_dt_new, turb=turb), diag

    # ----------------------------------------------------------- momentum
    def _momentum(self, rho, rho_old, U, U_old, phi, phi_b, p, mu_f, mu_bf,
                  mu, dt, stats, SU=None):
        """Implicit momentum predictor: (U, HbyA, rAU). The three components
        (each with its own BC mesh) are one batched solve. SU: the spray's
        momentum source (3, n), or None."""
        cfg = self.config
        gp = grad_fl(self.m_p, p)                        # (n, 3)
        # explicit part of div(mu dev2(grad U)^T): all 10 coefficient-field
        # gradients (mu dU_i/dx_c and mu divU) in one batched Gauss pass
        gU_all = grad_multi_fl(self.m_U, U)              # (n, 3, 3) [n,i,c]
        divU = gU_all[:, 0, 0] + gU_all[:, 1, 1] + gU_all[:, 2, 2]
        Q = torch.cat([mu[:, None] * gU_all.reshape(-1, 9),
                       (mu * divU)[:, None]], dim=1)     # (n, 10)
        G = self._grad_coeff(Q)                          # (n, 10, 3)
        g_vec = cfg.gravity
        srcs = [-gp[:, c] + (G[:, 0 + c, 0] + G[:, 3 + c, 1] + G[:, 6 + c, 2]
                             - G[:, 9, c] * (2.0 / 3.0))
                + (SU[c] if SU is not None else 0.0)
                + (rho * g_vec[c] if g_vec[c] else 0.0) for c in range(3)]
        scheme = cfg.div_scheme_U or cfg.div_scheme
        eqn = FvMatrixFL.stack([
            (fvm_ddt_fl(self.m_U[c], rho, rho_old, U_old[:, c], dt)
             + fvm_div_fl(self.m_U[c], phi, phi_b, scheme, x_now=U[:, c])
             + fvm_laplacian_corrected_fl(self.m_U[c], mu_f, mu_bf, U[:, c],
                                          sign=-1.0)
             ).with_source(srcs[c]) for c in range(3)])
        res = solve_fvmatrix(eqn, U.T, tol=cfg.u_tol, max_iter=cfg.max_iter_u)
        # HbyA with the first component's diagonal, as the JAX step
        u_diag = eqn.diag()[0]
        HbyA = (eqn.H(res.x) + gp.T) / u_diag
        stats["iters_U"] = res.iterations[2]
        return res.x.T, HbyA.T, 1.0 / u_diag

    def _grad_coeff(self, q):
        """Gauss gradient of coefficient fields q (n, ...) -> (n, ..., 3),
        the owner value on boundary faces (structured bcs_coeff role)."""
        m = self.m_p
        if m.plan is not None:
            out = m.plan_grad_interior(q)                    # (n, ..., 3)
        else:
            qf = interpolate_fl(m, q)                        # (nf, ...)
            sf_vec = m.mag_sf[:, None] * m.normal            # (nf, 3)
            fv = qf[..., None] * sf_vec.reshape(
                (sf_vec.shape[0],) + (1,) * (qf.dim() - 1) + (3,))
            out = m.scatter_faces(fv)                        # (n, ..., 3)
        for p_ in m.patches:
            qo = q[p_.owner]
            fb = qo * p_.mag_sf.reshape(
                (p_.mag_sf.shape[0],) + (1,) * (qo.dim() - 1))
            fbv = fb[..., None] * p_.normal.reshape(
                (p_.normal.shape[0],) + (1,) * (fb.dim() - 1) + (3,))
            out = out + _segment_sum(fbv, p_.owner, m.n_cells)
        return m.restrict(out) / m.vol_local.reshape(
            (m.vol_local.shape[0],) + (1,) * (out.dim() - 1))

    # ------------------------------------------------------ pressure loop
    def _pressure_loop(self, p, p_old, psi, rho_fn, HbyA, rAU, dt, rho_old,
                       phi_old_all, rhoU_old, stats, src_rho=None):
        cfg = self.config
        m = self.m_p
        phi_old, phi_b_old = phi_old_all
        rhoU_old_f, rhoU_old_b = rhoU_old
        sym = ("symmetry", "wedge", "empty")
        p_res = torch.zeros((), dtype=p.dtype, device=p.device)
        for _ in range(cfg.n_corr):
            rho = rho_fn(p)
            rho_f = interpolate_fl(self.m_rho, rho)
            rho_bf = [_boundary_face_value(pc, rho)
                      for pc in self.m_rho.patches]
            # phiHbyA = rho_f (HbyA . n)_f; symmetry-like patches carry no
            # normal flux exactly
            phiH = flux_normal_fl(m, HbyA)
            phiH_b = [0.0 for _ in m.patches]
            for c in range(3):
                for ip, p_ in enumerate(m.patches):
                    if p_.kind in sym:
                        continue
                    pc = self.m_U[c].patches[ip]
                    phiH_b[ip] = phiH_b[ip] + _boundary_face_value(
                        pc, HbyA[:, c]) * p_.normal[:, c]
            phiH = rho_f * phiH
            phiH_b = [0.0 * rb if p_.kind in sym else rb * hb
                      for rb, hb, p_ in zip(rho_bf, phiH_b, m.patches)]
            # rhorAUf: face interpolation of the product rho*rAU
            rhorAUf, rhorAU_b = _face_product(m, rho * rAU)
            # ddtCorr with the OpenFOAM limiter
            small = 1e-15
            corr = phi_old - rhoU_old_f
            coeff = 1.0 - torch.clamp(corr.abs() / (phi_old.abs() + small),
                                      max=1.0)
            phiH = phiH + rhorAUf * coeff * corr / dt
            for ip in range(len(m.patches)):
                corr_b = phi_b_old[ip] - rhoU_old_b[ip]
                coeff_b = 1.0 - torch.clamp(
                    corr_b.abs() / (phi_b_old[ip].abs() + small), max=1.0)
                phiH_b[ip] = phiH_b[ip] + rhorAU_b[ip] * coeff_b * corr_b / dt
            phiH_b = list(self._fix_boundary_fluxes(phiH_b, rho_bf))
            eqn_p = (fvm_source_implicit_fl(m, psi / dt)
                     + fvm_laplacian_fl(m, rhorAUf, rhorAU_b, sign=-1.0))
            src_p = rho_old / dt - div_flux_fl(m, phiH, phiH_b)
            if src_rho is not None:
                # the spray's mass source, kept in the pressure equation as
                # in continuity
                src_p = src_p + src_rho
            eqn_p = eqn_p.with_source(src_p)
            # CG needs SPD: solve the volume-scaled system (V/V_mean) A x =
            # (V/V_mean) b, symmetric by construction (exactly 1 on uniform
            # meshes)
            Vn = m.vol_local / gmean(m.vol_local)
            plan_shape = m.plan.shape if m.plan is not None else None
            if plan_shape is not None:
                # on the lattice, the Vn scaling folded into the stencil,
                # its operands prepared once for the CG
                D_p, lo_p, hi_p = lattice_operands(
                    plan_shape, *eqn_p.plan_stencil(scale=Vn))
                apply_v = lambda X: stencil7_apply(X, D_p, lo_p, hi_p)
                d_p = D_p
            elif self.p_ell is not None:
                nbr_e, coef_e = eqn_p.ell(conn=self.p_ell)
                apply_v = lambda x: m.restrict(
                    eqn_p.apply_ell(x, nbr_e, coef_e) * Vn)
                d_p = eqn_p.diag() * Vn
            else:
                apply_v = lambda x: m.restrict(eqn_p.apply(x) * Vn)
                d_p = eqn_p.diag() * Vn
            if self.p_mg is not None and m.w_own is None:
                # aggregation-AMG V-cycle on the flat vector (PCG is
                # invariant to the scalar scaling of M); a shard-local mesh
                # takes Jacobi, as the JAX package's
                M_flat = self.p_mg.preconditioner(eqn_p, m.volumes)
                M_inv = M_flat if plan_shape is None else (
                    lambda R: M_flat(R.reshape(-1)).reshape(plan_shape))
            else:
                d_inv = 1.0 / torch.where(d_p.abs() > 1e-300, d_p,
                                          torch.ones_like(d_p))
                M_inv = lambda r: d_inv * r
            lat = ((lambda v: v.reshape(plan_shape)) if plan_shape
                   else (lambda v: v))
            # non-orthogonal correctors: the cross-diffusion k_no . grad_f(p)
            # enters as a deferred source rebuilt from the latest p; one
            # solve on orthogonal meshes
            has_no = _has_nonortho(m)
            n_solves = 1 + (cfg.n_nonortho if has_no else 0)
            p_res = None
            for _ in range(n_solves):
                src_no = (laplacian_nonortho_corr_fl(m, rhorAUf, p,
                                                     gamma_b=rhorAU_b)
                          if has_no else 0.0)
                b_p = m.restrict((eqn_p.rhs() + src_no) * Vn)
                res_p = cg(apply_v, lat(b_p), lat(p), M_inv, tol=cfg.p_tol,
                           rel_tol=cfg.p_rel_tol, max_iter=cfg.max_iter_p,
                           nd=3 if plan_shape else 1)
                p = res_p.x.reshape(-1)
                if p_res is None:
                    p_res = res_p.initial_residual
                stats["iters_p"] = stats.get("iters_p", 0) + res_p.iterations
            # flux reconstruction, with the non-orthogonal part of the last
            # corrector's face gradient (OpenFOAM pEqn.flux())
            phi = phiH - rhorAUf * sngrad_fl(m, p)
            if m.k_no is not None:
                gf_p = face_grad_fl(m, p)
                phi = phi - rhorAUf * (m.k_no * gf_p).sum(1) / m.mag_sf
            phi_b = []
            for ip, p_ in enumerate(m.patches):
                po = p[p_.owner]
                ghost = p_.a * po + p_.b
                phi_b.append(phiH_b[ip]
                             - rhorAU_b[ip] * (ghost - po) / p_.delta)
            phi_b = list(self._fix_boundary_fluxes(phi_b, rho_bf))
            gp = grad_fl(self.m_p, p)
            U = HbyA - rAU[:, None] * gp
            dpdt = (p - p_old) / dt
        rho = rho_old - dt * div_flux_fl(m, phi, phi_b)
        if src_rho is not None:
            rho = rho + dt * src_rho
        return p, phi, tuple(phi_b), U, dpdt, rho, p_res


def make_step_fl(solver):
    """`step(state, dt, sources=None) -> (state, diag)` of a face-list
    solver (LowMachSolverFL or FGMSolverFL). JAX compiles its step here;
    the port runs eagerly, so this is the solver's own step."""
    return solver.step
