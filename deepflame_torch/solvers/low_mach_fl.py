"""Low-Mach PIMPLE solver on the face-list backend (general meshes).

Port of deepflame_tpu/solvers/low_mach_fl.py for meshes without a shift
plan: the dfLowMachFoam loop of solvers/low_mach.py (chemistry, then rhoEqn,
UEqn, YEqn, EEqn, correctThermo and the pEqn correctors with Rhie-Chow
ddtCorr), discretised by gathers over owner/neighbour and ELL row sums
(ops/fv_facelist.py), so any mesh given as owner/neighbour face lists
(blockMesh, polyMesh) runs the same step.

State layout is flat cells as in the JAX package: scalars (n,), vectors
(n, 3), species (n, ns), interior face flux (nf,) and per-patch boundary
fluxes. Each field has its own FaceListMesh carrying its boundary
coefficients over one geometry; species may come in BC groups
(`m_Y_groups`). Each group's species, and the three velocity components,
are one batched Krylov solve with per-lane convergence and counts (the JAX
package vmaps the scalar solve). With `p_ell` set, the pressure-CG matvec
goes through the ELLPACK SpMV kernel `ell_matvec` on the card.

Not in this slice (they raise): RAS (`m_k`, `m_eps`, `wall_fns`), the AMG
pressure preconditioner (`p_mg`) and spray `sources`.
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
from ..ops.linsolve import cg, solve_fvmatrix
from ..parallel.context import gmax, gmean, gmin
from .low_mach import LowMachConfig

__all__ = ["LowMachFLState", "LowMachSolverFL", "make_step_fl"]


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
    p_ell: m_p.ell_connectivity(), computed once."""
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
    p_mg: Any = None
    p_ell: Any = None
    les: Any = None

    def __post_init__(self):
        for name in ("m_k", "m_eps", "wall_fns"):
            if getattr(self, name) is not None:
                raise NotImplementedError(f"{name}: RAS on the face-list "
                                          "backend is a later slice")
        if self.p_mg is not None:
            raise NotImplementedError("p_mg: the AMG pressure preconditioner "
                                      "(ops/amg_fl.py) is a later slice")
        dev = self.m_p.device
        for name, t in (("thermo", self.thermo.W), ("transport", self.transport.W),
                        ("kinetics", self.combustion.kinetics.W)):
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

    def initial_state(self, p, T, Y, U=None, time: float = 0.0) -> LowMachFLState:
        """State from p, T (n,), Y (n, ns) and U (n, 3), tensors or arrays,
        placed on the solver's device in the thermo tables' dtype."""
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
        return LowMachFLState(rho=rho, U=U, p=p, ha=self.thermo.h_mass(T, Y),
                              Y=Y, T=T, phi=phi, phi_b=phi_b,
                              dpdt=torch.zeros(n, dtype=dtype, device=dev),
                              time=f(time), chem_dt=chem_dt)

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

    # ---------------------------------------------------------------- step
    def step(self, s: LowMachFLState, dt, sources=None):
        if sources is not None:
            raise NotImplementedError("spray sources on the face-list "
                                      "backend: ROADMAP A13")
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

        # ===== chemistry (operator split, once per step)
        if cfg.chemistry:
            turb_q = None
            if self.les is not None:
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

        for outer in range(cfg.n_outer):
            # ===== rhoEqn
            rho = rho_old - dt * div_flux_fl(m, phi, phi_b)

            # ===== coefficients, molecular + SGS effective
            mu, alpha, rhoD = self._mixture_update(p, T, Y)
            if self.les is not None:
                mu_t = self.les.mu_t_fl(rho, U, self.m_U, m.volumes)
                mu = mu + mu_t
                alpha = alpha + mu_t / self.les.Pr_t
                rhoD = rhoD + mu_t[None] / self.les.Sc_t
            mu_f, mu_bf = _face_product(m, mu)

            # ===== UEqn
            U, HbyA, rAU = self._momentum(rho, rho_old, U, U_old, phi, phi_b,
                                          p, mu_f, mu_bf, mu, dt, diag)

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
            eqn_h = eqn_h.with_source(dpdt - dKdt + hcorr_div)
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
                (s.phi, s.phi_b), rhoU_old, diag)
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
        return LowMachFLState(rho=rho, U=U, p=p, ha=ha, Y=Y, T=T, phi=phi,
                              phi_b=phi_b, dpdt=dpdt, time=s.time + dt,
                              chem_dt=chem_dt_new), diag

    # ----------------------------------------------------------- momentum
    def _momentum(self, rho, rho_old, U, U_old, phi, phi_b, p, mu_f, mu_bf,
                  mu, dt, stats):
        """Implicit momentum predictor: (U, HbyA, rAU). The three components
        (each with its own BC mesh) are one batched solve."""
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
        qf = interpolate_fl(m, q)                            # (nf, ...)
        sf_vec = m.mag_sf[:, None] * m.normal                # (nf, 3)
        fv = qf[..., None] * sf_vec.reshape(
            (sf_vec.shape[0],) + (1,) * (qf.dim() - 1) + (3,))
        out = m.scatter_faces(fv)                            # (n, ..., 3)
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
                       phi_old_all, rhoU_old, stats):
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
            eqn_p = eqn_p.with_source(rho_old / dt
                                      - div_flux_fl(m, phiH, phiH_b))
            # CG needs SPD: solve the volume-scaled system (V/V_mean) A x =
            # (V/V_mean) b, symmetric by construction (exactly 1 on uniform
            # meshes)
            Vn = m.vol_local / gmean(m.vol_local)
            if self.p_ell is not None:
                nbr_e, coef_e = eqn_p.ell(conn=self.p_ell)
                apply_v = lambda x: m.restrict(
                    eqn_p.apply_ell(x, nbr_e, coef_e) * Vn)
            else:
                apply_v = lambda x: m.restrict(eqn_p.apply(x) * Vn)
            d_p = eqn_p.diag() * Vn
            d_inv = 1.0 / torch.where(d_p.abs() > 1e-300, d_p,
                                      torch.ones_like(d_p))
            M_inv = lambda r: d_inv * r
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
                res_p = cg(apply_v, b_p, p, M_inv, tol=cfg.p_tol,
                           rel_tol=cfg.p_rel_tol, max_iter=cfg.max_iter_p,
                           nd=1)
                p = res_p.x
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
        return p, phi, tuple(phi_b), U, dpdt, rho, p_res


def make_step_fl(solver):
    """`step(state, dt, sources=None) -> (state, diag)` of a face-list
    solver. JAX compiles its step here with the mesh as a traced argument;
    the port runs eagerly, so this is the solver's own step. Spray sources
    on the face-list backend raise NotImplementedError (ROADMAP A13)."""
    return solver.step
