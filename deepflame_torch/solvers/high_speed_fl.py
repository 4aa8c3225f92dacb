"""Density-based (dfHighSpeedFoam) solver on the face-list backend.

Port of deepflame_tpu/solvers/high_speed_fl.py: the algorithm of
solvers/high_speed.py (per-face Riemann fluxes of `ops.riemann`, SSP
Runge-Kutta, operator-split chemistry) over FaceListMesh owner/neighbour
connectivity. Reconstruction is the unstructured MUSCL ratio
r = 2 (grad_up . d)/(q_nei - q_own) - 1, which reduces to the structured
far-cell form on uniform interior cells; WENO5-Z on meshes with a shift
plan (the lattice gives the 5-cell stencils by rolls; faces within two
cells of a non-cyclic boundary keep the vanLeer MUSCL value), vanLeer MUSCL
off the plan. Face tangent frames are built per face; boundary patches take
a ghost face state from each field's affine coefficients (pure pressure
flux on symmetry, wedge, empty and slip patches).

Two changes in the translation, neither changing what a lane computes:
all 5 + ns primitives are reconstructed as one batch (their gradients in one
grad_multi_fl over the per-field BC meshes) where JAX reconstructs field by
field; and the split chemistry gathers the cells above T_threshold into the
lane-batched integrator (`chemistry.integrator.rosenbrock_integrate`, one
`gj_inverse` launch a trip on the card) where JAX maps the single-cell
integrator over every cell with t_end = 0 below the threshold.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..chemistry.integrator import rosenbrock_integrate
from ..chemistry.kinetics import production_rates
from ..chemistry.reactor import constant_volume_rhs_batched
from ..constants import GAS_CONSTANT
from ..mesh.facelist import FaceListMesh, _plan_segments
from ..ops.fv_facelist import _segment_sum, grad_multi_fl
from ..ops.riemann import FLUX_SCHEMES
from .high_speed import HighSpeedConfig, _limiter, _weno5_core

__all__ = ["HighSpeedFLState", "HighSpeedSolverFL"]


class HighSpeedFLState(NamedTuple):
    rho: torch.Tensor       # (n,)
    rhoU: torch.Tensor      # (n, 3)
    rhoE: torch.Tensor      # (n,) total energy density, absolute [J/m^3]
    rhoY: torch.Tensor      # (n, ns)
    T: torch.Tensor         # (n,) cached temperature (Newton warm start)
    time: torch.Tensor


def _face_tangents(normal: torch.Tensor):
    """Orthonormal (t1, t2) per face, deterministic from the normal."""
    n = normal
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    a = torch.where((n[:, 0].abs() < 0.9)[:, None], ex, ey)
    t1 = a - (a * n).sum(1, keepdim=True) * n
    t1 = t1 / torch.sqrt((t1 * t1).sum(1, keepdim=True))
    return t1, torch.cross(n, t1, dim=1)


def _muscl(q_o, q_n, g_o, g_n, lim):
    """Limited face states from the owner and neighbour values and the
    gradient projections on d = C_nei - C_own."""
    dq = q_n - q_o
    eps = 1e-30
    safe = torch.where(dq.abs() > eps, dq, torch.full_like(dq, eps))
    return (q_o + 0.5 * _limiter(2.0 * g_o / safe - 1.0, lim) * dq,
            q_n - 0.5 * _limiter(2.0 * g_n / safe - 1.0, lim) * dq)


@dataclasses.dataclass(frozen=True)
class HighSpeedSolverFL:
    """Per-field FaceListMesh instances carry the boundary coefficients over
    one geometry (as LowMachSolverFL's); thermo and kinetics on the meshes'
    device."""
    m_rho: FaceListMesh
    m_p: FaceListMesh
    m_Y: FaceListMesh
    m_U: tuple              # (3,) per velocity component
    thermo: Any
    kinetics: Any
    config: HighSpeedConfig = HighSpeedConfig()

    @property
    def mesh(self) -> FaceListMesh:
        return self.m_rho

    @property
    def device(self) -> torch.device:
        return self.m_rho.device

    @property
    def dtype(self) -> torch.dtype:
        return self.thermo.W.dtype

    # ------------------------------------------------------------- state IO
    def initial_state(self, p, T, Y, U=None, time=0.0) -> HighSpeedFLState:
        """State from p, T (n,), Y (n, ns) and U (n, 3), tensors or arrays,
        on the solver's device in the thermo tables' dtype."""
        dtype, dev = self.dtype, self.device
        f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
        p, T, Y = f(p), f(T), f(Y)
        n = T.shape[0]
        U = torch.zeros((n, 3), dtype=dtype, device=dev) if U is None else f(U)
        rho = self.thermo.rho(p, T, Y)
        e = self.thermo.e_mass(T, Y)
        K = 0.5 * (U * U).sum(1)
        return HighSpeedFLState(rho=rho, rhoU=rho[:, None] * U,
                                rhoE=rho * (e + K), rhoY=rho[:, None] * Y,
                                T=T, time=f(time))

    def primitives(self, s: HighSpeedFLState):
        rho = torch.clamp(s.rho, min=1e-10)
        U = s.rhoU / rho[:, None]
        Y = torch.clamp(s.rhoY / rho[:, None], 0.0, 1.0)
        Y = Y / Y.sum(1, keepdim=True)
        K = 0.5 * (U * U).sum(1)
        e = s.rhoE / rho - K
        T = self.thermo.T_from_e(e, Y, s.T)
        p = rho / self.thermo.psi(T, Y)
        return rho, U, p, T, Y

    # ------------------------------------------------------ reconstruction
    def _field_meshes(self, ns: int) -> list:
        """The BC mesh of each column of the stacked primitives
        [rho, U0, U1, U2, p, Y...]."""
        return [self.m_rho, *self.m_U, self.m_p] + [self.m_Y] * ns

    def _face_lr(self, Q: torch.Tensor, d_vec: torch.Tensor):
        """Face states (qL, qR) (nf, k) of the stacked primitives Q (n, k)
        on interior faces."""
        m = self.m_rho
        qo, qn = m.gather_own(Q), m.gather_nei(Q)
        lim = self.config.limiter
        if lim == "none":
            return qo, qn
        g = grad_multi_fl(self._field_meshes(Q.shape[1] - 5), Q)  # (n, k, 3)
        gO = (m.gather_own(g) * d_vec[:, None, :]).sum(-1)
        gN = (m.gather_nei(g) * d_vec[:, None, :]).sum(-1)
        if lim == "WENO5":
            qL, qR = _muscl(qo, qn, gO, gN, "vanLeer")
            if m.plan is not None:
                return self._face_lr_weno_plan(Q, qL, qR)
            return qL, qR
        return _muscl(qo, qn, gO, gN, lim)

    def _face_lr_weno_plan(self, Q, qL, qR):
        """WENO5-Z face states on a plan mesh from the lattice's rolled
        5-cell stencils (exact across cyclic wraps); faces within two cells
        of a non-cyclic boundary keep the MUSCL values qL, qR."""
        m = self.m_rho
        pl = m.plan
        k = Q.shape[1]
        Xl = Q.reshape(pl.shape + (k,))
        wrap_of = {ax: wrap for ax, wrap, _, _ in pl.families}
        qL, qR = qL.clone(), qR.clone()
        for ax, is_wrap, start, count in _plan_segments(pl):
            n_ax = pl.shape[ax]
            if n_ax < 5:
                continue                      # the stencil never fits
            s = [torch.roll(Xl, -j, dims=ax) for j in (-2, -1, 0, 1, 2, 3)]
            fL = _weno5_core(s[0], s[1], s[2], s[3], s[4])   # face (i, i+1)
            fR = _weno5_core(s[5], s[4], s[3], s[2], s[1])
            sl = [slice(None)] * 3
            sl[ax] = (slice(n_ax - 1, n_ax) if is_wrap
                      else slice(0, n_ax - 1))
            segL = fL[tuple(sl)].reshape(-1, k)
            segR = fR[tuple(sl)].reshape(-1, k)
            if not wrap_of[ax] and not is_wrap:
                # the rolls wrap across a physical boundary: faces i < 2 and
                # i > n - 4 keep MUSCL
                lat = list(pl.shape)
                lat[ax] = n_ax - 1
                shp = [1, 1, 1]
                shp[ax] = n_ax - 1
                ii = torch.arange(n_ax - 1, device=Q.device).reshape(
                    shp).expand(lat).reshape(-1, 1)
                ok = (ii >= 2) & (ii <= n_ax - 4)
                segL = torch.where(ok, segL, qL[start:start + count])
                segR = torch.where(ok, segR, qR[start:start + count])
            qL[start:start + count] = segL
            qR[start:start + count] = segR
        return qL, qR

    def _face_state(self, rho_, u_, v_, w_, p_, Y_):
        """Face primitives with Y trailing: T from the ideal-gas law, E and
        the frozen sound speed."""
        W = 1.0 / (Y_ @ self.thermo.inv_W)
        T_ = p_ * W / (rho_ * GAS_CONSTANT)
        e_ = self.thermo.e_mass(T_, Y_)
        cp = self.thermo.cp_mass(T_, Y_)
        gamma = cp / (cp - GAS_CONSTANT / W)
        a_ = torch.sqrt(gamma * p_ / rho_)
        E_ = e_ + 0.5 * (u_ ** 2 + v_ ** 2 + w_ ** 2)
        return dict(rho=rho_, u=u_, v=v_, w=w_, p=p_, E=E_, a=a_, Y=Y_)

    # ------------------------------------------------------------ RHS L(U)
    def _flux_divergence(self, s: HighSpeedFLState):
        m = self.m_rho
        rho, U, p, T, Y = self.primitives(s)
        flux_fn = FLUX_SCHEMES[self.config.flux]
        nrm = m.normal
        t1v, t2v = _face_tangents(nrm)
        d_vec = m.gather_nei(m.centers) - m.gather_own(m.centers)
        Q = torch.cat([rho[:, None], U, p[:, None], Y], dim=1)   # (n, 5 + ns)
        q = torch.stack(self._face_lr(Q, d_vec))                 # (2, nf, k)
        Yf = q[..., 5:]
        Yf = Yf / torch.clamp(Yf.sum(-1, keepdim=True), min=1e-12)
        Uf = q[..., 1:4]
        st = self._face_state(
            torch.clamp(q[..., 0], min=1e-10), (Uf * nrm).sum(-1),
            (Uf * t1v).sum(-1), (Uf * t2v).sum(-1),
            torch.clamp(q[..., 4], min=1.0), Yf)
        mass, momn, momt1, momt2, ener, Yflux = flux_fn(
            *({k: v[i] for k, v in st.items()} for i in (0, 1)))
        # momentum flux back into Cartesian components
        Fmom = (momn[:, None] * nrm + momt1[:, None] * t1v
                + momt2[:, None] * t2v)
        pack = torch.cat([mass[:, None], Fmom, ener[:, None], Yflux],
                         dim=1) * m.mag_sf[:, None]
        acc = m.scatter_faces(pack)                       # (n, 5 + ns)
        for ip, pch in enumerate(m.patches):
            if pch.owner.shape[0] == 0:
                continue
            acc = acc + _segment_sum(self._boundary_flux(ip, pch, rho, U, p,
                                                         Y),
                                     pch.owner, m.n_cells)
        d = -acc / m.volumes[:, None]
        L = dict(rho=d[:, 0], rhoU=d[:, 1:4], rhoE=d[:, 4], rhoY=d[:, 5:])
        if self.config.chemistry == "direct":
            wdot = production_rates(self.kinetics, self.thermo, T, rho, Y)
            mask = (T > self.config.T_threshold)[:, None]
            L["rhoY"] = L["rhoY"] + torch.where(mask, wdot * self.kinetics.W,
                                                torch.zeros_like(wdot))
        return L

    def _boundary_flux(self, ip: int, pch, rho, U, p, Y):
        """Outward flux (times area) through one boundary patch: the pure
        pressure flux on symmetry, wedge, empty and slip patches; otherwise
        the physical flux of the ghost face state from each field's affine
        coefficients."""
        nrm = pch.normal
        ob = pch.owner
        if pch.kind in ("symmetry", "wedge", "empty", "slip"):
            p_o = p[ob]
            pack = torch.zeros((ob.shape[0], 5 + Y.shape[1]), dtype=p.dtype,
                               device=p.device)
            pack[:, 1:4] = p_o[:, None] * nrm
            return pack * pch.mag_sf[:, None]

        def ghost_face(pm, q):
            pc = pm.patches[ip]
            qo = q[ob]
            return 0.5 * (qo + pc.a * qo + pc.b)

        rho_b = torch.clamp(ghost_face(self.m_rho, rho), min=1e-10)
        p_b = torch.clamp(ghost_face(self.m_p, p), min=1.0)
        U_b = torch.stack([ghost_face(self.m_U[c], U[:, c])
                           for c in range(3)], dim=1)
        pc = self.m_Y.patches[ip]
        Yo = Y[ob]
        Y_b = 0.5 * (Yo + pc.a[:, None] * Yo + pc.b[:, None])
        Y_b = Y_b / torch.clamp(Y_b.sum(1, keepdim=True), min=1e-12)
        t1v, t2v = _face_tangents(nrm)
        st = self._face_state(rho_b, (U_b * nrm).sum(1), (U_b * t1v).sum(1),
                              (U_b * t2v).sum(1), p_b, Y_b)
        mass = st["rho"] * st["u"]
        momn = mass * st["u"] + st["p"]
        Fm = (momn[:, None] * nrm + (mass * st["v"])[:, None] * t1v
              + (mass * st["w"])[:, None] * t2v)
        ener = st["u"] * (st["rho"] * st["E"] + st["p"])
        pack = torch.cat([mass[:, None], Fm, ener[:, None],
                          st["Y"] * mass[:, None]], dim=1)
        return pack * pch.mag_sf[:, None]

    def _apply(self, s, L, coef_old, coef_new, dt, s_old):
        """SSP convex update coef_old * s_old + coef_new * (s + dt L(s)); dt
        a number or a per-cell field (LTS)."""
        def upd(old, cur, dL):
            d = dt
            if torch.is_tensor(dt) and dt.dim() > 0 and dL.dim() > 1:
                d = dt[:, None]
            return coef_old * old + coef_new * (cur + d * dL)
        return HighSpeedFLState(
            rho=upd(s_old.rho, s.rho, L["rho"]),
            rhoU=upd(s_old.rhoU, s.rhoU, L["rhoU"]),
            rhoE=upd(s_old.rhoE, s.rhoE, L["rhoE"]),
            rhoY=upd(s_old.rhoY, s.rhoY, L["rhoY"]),
            T=s.T, time=s.time)

    # ---------------------------------------------------------------- step
    def step(self, s: HighSpeedFLState, dt):
        """One step of dt (a number or a per-cell field): the SSP transport,
        the split chemistry, T decoded; diag T_max, p_max, u_max and, with
        split chemistry, the active lanes and the trips of their drain."""
        stages = {1: ((0.0, 1.0),), 2: ((0.0, 1.0), (0.5, 0.5)),
                  3: ((0.0, 1.0), (0.75, 0.25), (1.0 / 3.0, 2.0 / 3.0))}
        if self.config.rk_order not in stages:
            raise ValueError(self.config.rk_order)
        s0 = s
        for c_old, c_new in stages[self.config.rk_order]:
            s = self._apply(s, self._flux_divergence(s), c_old, c_new, dt, s0)
        stats = {}
        if self.config.chemistry == "ode":
            s = self._chemistry_split(s, dt, stats)
        rho, U, p, T, Y = self.primitives(s)
        dt_clock = dt.min() if torch.is_tensor(dt) and dt.dim() > 0 else dt
        s = s._replace(T=T, time=s.time + dt_clock)
        return s, dict(T_max=T.max(), p_max=p.max(), u_max=U.abs().max(),
                       **stats)

    def _chemistry_split(self, s: HighSpeedFLState, dt, stats=None):
        """Constant-volume chemistry over dt in every cell above
        T_threshold: rho, rhoU and rhoE unchanged."""
        rho, U, p, T, Y = self.primitives(s)
        st0 = torch.cat([T[:, None], Y], dim=1)
        idx = torch.nonzero(T > self.config.T_threshold).squeeze(1)
        dt_t = torch.as_tensor(dt, dtype=T.dtype, device=T.device)
        dt_act = (dt_t.reshape(-1)[idx] if dt_t.dim() > 0
                  else dt_t.expand(idx.shape[0]))
        st1 = st0
        need = torch.zeros((), dtype=torch.int64, device=T.device)
        if idx.numel():
            rhs = constant_volume_rhs_batched(self.thermo, self.kinetics,
                                              rho[idx])
            y1, nstep = rosenbrock_integrate(rhs, st0[idx], dt_act,
                                             self.config.ode_opts,
                                             return_nstep=True)
            st1 = st0.index_copy(0, idx, y1)
            need = nstep.max()
        if stats is not None:
            stats["chem_lanes"] = idx.numel()
            stats["chem_trips"] = need
        Y1 = torch.clamp(st1[:, 1:], 0.0, 1.0)
        Y1 = Y1 / Y1.sum(1, keepdim=True)
        return s._replace(rhoY=Y1 * rho[:, None])

    def acoustic_courant(self, s: HighSpeedFLState, dt):
        rho, U, p, T, Y = self.primitives(s)
        a = self.thermo.sound_speed(T, Y)
        h = self.m_rho.volumes ** (1.0 / 3.0)
        return ((torch.sqrt((U * U).sum(1)) + a) * dt / h).max()
