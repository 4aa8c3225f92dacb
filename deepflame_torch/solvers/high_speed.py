"""Density-based fully-compressible reacting solver (dfHighSpeedFoam parity).

Port of deepflame_tpu/solvers/high_speed.py: conservative variables (rho,
rhoU, rhoE, rhoY), a runtime-selected Riemann flux (`ops.riemann`), MUSCL
(vanLeer, minmod), WENO5-Z or first-order reconstruction, SSP Runge-Kutta
of order 1 to 3, and chemistry operator-split at constant (rho, e)
(`"ode"`), as direct rates in every stage (`"direct"`) or off (`"none"`).
The total energy carries the absolute (chemical) internal energy, so the
split chemistry needs no heat-release source.

Two changes in the translation, neither changing what a lane computes:

* Reconstruction: JAX reconstructs rho, each velocity component, p and each
  species one after another. Here all 5 + ns primitives go through one
  reconstruction per axis as one stacked tensor, their BCs stacked along
  the lane axis (`mesh.structured.stack_bcs`: a face whose BCs agree keeps
  its BC, any other becomes the affine ghost a * owner + b of each lane,
  the relation BC.coeffs gives and JAX pads with); the two sides' face
  states are one (2, ...) batch.
* Split chemistry: JAX maps the single-cell integrator over every cell,
  t_end = 0 where T <= T_threshold, so those lanes never take a step. Here
  only the active cells are gathered into the lane-batched integrator
  (`chemistry.integrator.rosenbrock_integrate`: one `gj_inverse` launch a
  trip) and scattered back; the others keep their state, as JAX's do.

A state may carry a batch of R independent blocks of the mesh's shape (the
row patches of `mesh.patch_amr.FrontPatchAMR2D`, which JAX steps under
`jax.vmap`): rho, rhoE and T (R, nx, ny, nz), rhoU (3, R, nx, ny, nz),
rhoY (ns, R, nx, ny, nz), time (R,). One step then evaluates each RK
stage's fluxes once and drains the hot cells of every block in one
integrator call. A state without the batch axis takes the same path as
before, with the same numbers.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import torch

from ..chemistry.integrator import RosenbrockOptions, rosenbrock_integrate
from ..chemistry.kinetics import KineticsData, production_rates
from ..chemistry.reactor import constant_volume_rhs_batched
from ..chemistry.thermo import ThermoData
from ..constants import GAS_CONSTANT
from ..mesh.structured import (BC, StructuredMesh, extend_padded, pad_field,
                               pad_n, stack_bcs)
from ..ops.fv import _face_diff, _sl, _trim, face_pair
from ..ops.riemann import FLUX_SCHEMES

__all__ = ["HighSpeedState", "HighSpeedConfig", "HighSpeedSolver"]


class HighSpeedState(NamedTuple):
    rho: torch.Tensor          # (nx, ny, nz)
    rhoU: torch.Tensor         # (3, nx, ny, nz)
    rhoE: torch.Tensor         # total energy density, absolute [J/m^3]
    rhoY: torch.Tensor         # (ns, nx, ny, nz)
    T: torch.Tensor            # cached temperature (Newton warm start)
    time: torch.Tensor


@dataclasses.dataclass(frozen=True)
class HighSpeedConfig:
    flux: str = "HLLC"             # HLLC | HLLCP | AUSMDV | Kurganov | Tadmor
    rk_order: int = 2              # 1 | 2 | 3 (SSP)
    limiter: str = "vanLeer"       # vanLeer | minmod | none | WENO5
    viscous: bool = False
    chemistry: str = "ode"         # 'ode' (split) | 'direct' | 'none'
    ode_opts: RosenbrockOptions = RosenbrockOptions(rtol=1e-6, atol=1e-12)
    T_threshold: float = 500.0     # freeze chemistry below

    def __post_init__(self):
        # a typo like 'od' must not silently disable chemistry
        if self.chemistry not in ("ode", "direct", "none"):
            raise ValueError(
                f"chemistry must be 'ode'|'direct'|'none', got "
                f"{self.chemistry!r}")


def _limiter(r, kind):
    if kind == "vanLeer":
        return (r + r.abs()) / (1.0 + r.abs())
    if kind == "minmod":
        return torch.clamp(r, 0.0, 1.0)
    raise ValueError(kind)


@dataclasses.dataclass(frozen=True)
class HighSpeedSolver:
    """Runs where its mesh lives; thermo and kinetics on the same device."""
    mesh: StructuredMesh
    thermo: ThermoData
    kinetics: KineticsData
    bcs_rho: Any
    bcs_U: tuple           # per-component FieldBCs
    bcs_p: Any
    bcs_Y: Any             # shared FieldBCs for species
    config: HighSpeedConfig = HighSpeedConfig()

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def dtype(self) -> torch.dtype:
        return self.thermo.W.dtype

    @functools.cached_property
    def bcs_prim(self):
        """The BCs of the stacked primitives [rho, U0, U1, U2, p, Y...]."""
        ns = self.thermo.W.shape[0]
        return stack_bcs([self.bcs_rho, *self.bcs_U, self.bcs_p]
                         + [self.bcs_Y] * ns, self.mesh, self.dtype)

    @functools.cached_property
    def bcs_prim_batched(self):
        """bcs_prim for primitives with a batch axis after the lane axis
        (S, R, nx, ny, nz): each stacked ghost coefficient (S, ...) gains a
        unit axis, so that S meets S and not R."""
        def one(bc):
            if bc.kind != "affine" or not any(
                    torch.is_tensor(v) and v.dim() > 3 for v in bc.value):
                return bc
            return BC("affine", tuple(
                v.unsqueeze(1) if torch.is_tensor(v) and v.dim() > 3 else v
                for v in bc.value))
        return tuple(tuple(one(bc) for bc in pair) for pair in self.bcs_prim)

    # ------------------------------------------------------------- state IO
    def initial_state(self, p, T, Y, U=None, time=0.0) -> HighSpeedState:
        """State from p, T (nx, ny, nz), Y (ns, nx, ny, nz) and U (3, nx,
        ny, nz), tensors or arrays, placed on the solver's device in the
        thermo tables' dtype."""
        dtype, dev = self.dtype, self.device
        f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
        p, T, Y = f(p), f(T), f(Y)
        sh = self.mesh.shape
        U = torch.zeros((3,) + sh, dtype=dtype, device=dev) if U is None else f(U)
        Yt = torch.movedim(Y, 0, -1)
        rho = self.thermo.rho(p, T, Yt)
        e = self.thermo.e_mass(T, Yt)
        K = 0.5 * (U * U).sum(0)
        return HighSpeedState(rho=rho, rhoU=rho * U, rhoE=rho * (e + K),
                              rhoY=rho * Y, T=T, time=f(time))

    def primitives(self, s: HighSpeedState):
        rho = torch.clamp(s.rho, min=1e-10)
        U = s.rhoU / rho
        Y = torch.clamp(s.rhoY / rho, 0.0, 1.0)
        Y = Y / Y.sum(0, keepdim=True)
        K = 0.5 * (U * U).sum(0)
        e = s.rhoE / rho - K
        Yt = torch.movedim(Y, 0, -1)
        T = self.thermo.T_from_e(e, Yt, s.T)
        p = rho / self.thermo.psi(T, Yt)
        return rho, U, p, T, Y

    # ------------------------------------------------------ reconstruction
    def _reconstruct(self, q, bcs, axis):
        """Face states (qL, qR) along axis from a cell field (..., nx, ny,
        nz): MUSCL/TVD (vanLeer, minmod), WENO5-Z or piecewise-constant."""
        if self.config.limiter == "WENO5":
            return _weno5_faces(q, bcs, self.mesh, axis)
        P = pad_field(q, bcs, self.mesh)
        own, nei = face_pair(P, axis)
        if self.config.limiter == "none":
            return own, nei
        Pm, Pp = extend_padded(P, axis, bcs)
        t = _trim(Pm, axis)
        nf = t.shape[axis - 3]
        far_own = _sl(t, axis, 0, nf - 2)
        far_nei = _sl(_trim(Pp, axis), axis, 2, nf)
        d = nei - own
        eps = torch.tensor(1e-30, dtype=P.dtype, device=P.device)
        safe = torch.where(d.abs() > eps, d, eps)
        phiL = _limiter((own - far_own) / safe, self.config.limiter)
        phiR = _limiter((far_nei - nei) / safe, self.config.limiter)
        return own + 0.5 * phiL * d, nei - 0.5 * phiR * d

    def _face_state(self, rho_, u_, v_, w_, p_, Y_):
        """Face primitives with Y trailing: T from the ideal-gas law, E and
        the frozen sound speed."""
        W = 1.0 / (Y_ @ self.thermo.inv_W)
        T_ = p_ * W / (rho_ * GAS_CONSTANT)
        e_ = self.thermo.e_mass(T_, Y_)
        cp = self.thermo.cp_mass(T_, Y_)
        gamma = cp / (cp - GAS_CONSTANT / W)
        a_ = torch.sqrt(gamma * p_ / rho_)
        E_ = e_ + 0.5 * (u_**2 + v_**2 + w_**2)
        return dict(rho=rho_, u=u_, v=v_, w=w_, p=p_, E=E_, a=a_, Y=Y_)

    # ------------------------------------------------------------ RHS L(U)
    def _flux_divergence(self, s: HighSpeedState, want_flux_x: bool = False):
        """-div of the Riemann fluxes of every conservative variable.

        want_flux_x also returns the raw x-face fluxes (per unit area),
        keyed like the state: rho (nfx, ny, nz), rhoU (3, nfx, ny, nz),
        rhoE (nfx, ny, nz), rhoY (ns, nfx, ny, nz)."""
        rho, U, p, T, Y = self.primitives(s)
        flux_fn = FLUX_SCHEMES[self.config.flux]
        prim = torch.cat([rho[None], U, p[None], Y])
        bcs = self.bcs_prim if rho.dim() == 3 else self.bcs_prim_batched
        flux_x = None
        d_rho = 0.0
        d_rhoU = [0.0, 0.0, 0.0]
        d_rhoE = 0.0
        d_rhoY = 0.0
        for ax in range(3):
            if self.mesh.shape[ax] == 1:
                continue
            t1, t2 = [(1, 2), (0, 2), (0, 1)][ax]
            # both sides as one (2, ...) batch through the face state
            q = torch.stack(self._reconstruct(prim, bcs, ax))
            Y_ = torch.movedim(q[:, 5:], 1, -1)
            Y_ = Y_ / torch.clamp(Y_.sum(-1, keepdim=True), min=1e-12)
            st = self._face_state(
                torch.clamp(q[:, 0], min=1e-10), q[:, 1 + ax], q[:, 1 + t1],
                q[:, 1 + t2], torch.clamp(q[:, 4], min=1.0), Y_)
            mass, momn, momt1, momt2, ener, Yflux = flux_fn(
                *({k: v[i] for k, v in st.items()} for i in (0, 1)))
            Yflux = torch.movedim(Yflux, -1, 0)
            if want_flux_x and ax == 0:
                flux_x = dict(rho=mass, rhoU=torch.stack([momn, momt1, momt2]),
                              rhoE=ener, rhoY=Yflux)
            h = self.mesh.spacing[ax]
            d_rho = d_rho - _face_diff(mass, ax) / h
            d_rhoU[ax] = d_rhoU[ax] - _face_diff(momn, ax) / h
            d_rhoU[t1] = d_rhoU[t1] - _face_diff(momt1, ax) / h
            d_rhoU[t2] = d_rhoU[t2] - _face_diff(momt2, ax) / h
            d_rhoE = d_rhoE - _face_diff(ener, ax) / h
            d_rhoY = d_rhoY - _face_diff(Yflux, ax) / h

        zeros = torch.zeros_like(s.rho)
        L = dict(rho=d_rho + zeros,
                 rhoU=torch.stack([c + zeros for c in d_rhoU]),
                 rhoE=d_rhoE + zeros, rhoY=d_rhoY + torch.zeros_like(s.rhoY))

        if self.config.chemistry == "direct":
            Yt = torch.movedim(Y, 0, -1)
            wdot = production_rates(self.kinetics, self.thermo, T, rho, Yt)
            mask = (T > self.config.T_threshold)[..., None]
            RR = torch.where(mask, wdot * self.kinetics.W,
                             torch.zeros_like(wdot))
            L["rhoY"] = L["rhoY"] + torch.movedim(RR, -1, 0)
        if want_flux_x:
            return L, flux_x
        return L

    def _apply(self, s: HighSpeedState, L, coef_old, coef_new, dt,
               s_old: HighSpeedState):
        """SSP convex update: coef_old * s_old + coef_new * (s + dt L(s))."""
        def upd(old, cur, dL):
            return coef_old * old + coef_new * (cur + dt * dL)
        return HighSpeedState(
            rho=upd(s_old.rho, s.rho, L["rho"]),
            rhoU=upd(s_old.rhoU, s.rhoU, L["rhoU"]),
            rhoE=upd(s_old.rhoE, s.rhoE, L["rhoE"]),
            rhoY=upd(s_old.rhoY, s.rhoY, L["rhoY"]),
            T=s.T, time=s.time)

    # ---------------------------------------------------------------- step
    def _rk(self, s: HighSpeedState, dt, want_flux_x: bool):
        """The SSP Runge-Kutta transport; with want_flux_x also the
        RK-weighted x-face fluxes (rk1 [1]; rk2 [1/2, 1/2]; rk3 [1/6, 1/6,
        2/3])."""
        order = self.config.rk_order
        stages = {1: ((0.0, 1.0),), 2: ((0.0, 1.0), (0.5, 0.5)),
                  3: ((0.0, 1.0), (0.75, 0.25), (1.0 / 3.0, 2.0 / 3.0))}
        if order not in stages:
            raise ValueError(order)
        s0, Fs = s, []
        for c_old, c_new in stages[order]:
            out = self._flux_divergence(s, want_flux_x)
            if want_flux_x:
                out, F = out
                Fs.append(F)
            s = self._apply(s, out, c_old, c_new, dt, s0)
        if not want_flux_x:
            return s, None
        if order == 1:
            Fx = Fs[0]
        elif order == 2:
            Fx = {k: 0.5 * (Fs[0][k] + Fs[1][k]) for k in Fs[0]}
        else:
            Fx = {k: (Fs[0][k] + Fs[1][k] + 4.0 * Fs[2][k]) / 6.0
                  for k in Fs[0]}
        return s, Fx

    def _finish(self, s: HighSpeedState, dt):
        """Split chemistry, T decoded, the clock advanced; (state, diag)."""
        stats = {}
        if self.config.chemistry == "ode":
            s = self._chemistry_split(s, dt, stats)
        rho, U, p, T, Y = self.primitives(s)
        # LTS (per-cell dt field): pseudo-time, the clock advances by the
        # smallest local step
        dt_clock = torch.as_tensor(dt).min() if torch.is_tensor(dt) \
            and dt.dim() > 0 else dt
        s = s._replace(T=T, time=s.time + dt_clock)
        diag = dict(T_max=T.max(), p_max=p.max(), u_max=U.abs().max(),
                    **stats)
        return s, diag

    def step(self, s: HighSpeedState, dt) -> tuple[HighSpeedState, dict]:
        """One step of dt: a number, or a per-cell field (LTS). The
        diagnostics carry T_max, p_max, u_max and, with split chemistry,
        the active lanes and the trips their drain needed."""
        s, _ = self._rk(s, dt, False)
        return self._finish(s, dt)

    def step_with_flux_x(self, s: HighSpeedState, dt):
        """step() that also returns the RK-effective x-face fluxes: the
        per-area fluxes F with q^{n+1} = q^n - dt (F_{i+1} - F_i)/dx (+ y/z
        terms), the time-integrated interface flux of refluxing."""
        s, Fx = self._rk(s, dt, True)
        s, diag = self._finish(s, dt)
        return s, diag, Fx

    def _chemistry_split(self, s: HighSpeedState, dt, stats=None):
        """Constant-volume chemistry over dt in every cell above
        T_threshold: rho, rhoU and rhoE unchanged, T decoded later."""
        rho, U, p, T, Y = self.primitives(s)
        sh = T.shape
        ns = Y.shape[0]
        Tf = T.reshape(-1)
        rhof = rho.reshape(-1)
        st0 = torch.cat([Tf[:, None], torch.movedim(Y, 0, -1).reshape(-1, ns)],
                        dim=1)
        idx = torch.nonzero(Tf > self.config.T_threshold).squeeze(1)
        dt_flat = torch.as_tensor(dt, dtype=Tf.dtype, device=Tf.device)
        dt_act = (dt_flat.reshape(-1)[idx] if dt_flat.dim() > 0
                  else dt_flat.expand(idx.shape[0]))
        st1 = st0
        need = torch.zeros((), dtype=torch.int64, device=Tf.device)
        if idx.numel():
            rhs = constant_volume_rhs_batched(self.thermo, self.kinetics,
                                              rhof[idx])
            y1, nstep = rosenbrock_integrate(rhs, st0[idx], dt_act,
                                             self.config.ode_opts,
                                             return_nstep=True)
            st1 = st0.index_copy(0, idx, y1)
            need = nstep.max()
        if stats is not None:
            stats["chem_lanes"] = idx.numel()
            stats["chem_trips"] = need
        Y1 = torch.clamp(st1[:, 1:], 0.0, 1.0)
        Y1 = Y1 / Y1.sum(-1, keepdim=True)
        rhoY = torch.movedim(Y1.reshape(sh + (ns,)), -1, 0) * rho
        return s._replace(rhoY=rhoY)

    def acoustic_courant(self, s: HighSpeedState, dt):
        rho, U, p, T, Y = self.primitives(s)
        a = self.thermo.sound_speed(T, torch.movedim(Y, 0, -1))
        co = torch.zeros((), dtype=a.dtype, device=a.device)
        for ax, h in enumerate(self.mesh.spacing):
            if self.mesh.shape[ax] > 1:
                co = torch.maximum(co, (U[ax].abs() + a).max() * dt / h)
        return co


def _weno5_core(s0, s1, s2, s3, s4):
    """WENO5-Z value at the right face of the centre cell s2 from the
    stencil s0..s4 = q_{i-2}..q_{i+2} (Borges et al. 2008)."""
    eps = 1e-12
    b0 = (13.0 / 12.0) * (s0 - 2 * s1 + s2) ** 2 \
        + 0.25 * (s0 - 4 * s1 + 3 * s2) ** 2
    b1 = (13.0 / 12.0) * (s1 - 2 * s2 + s3) ** 2 + 0.25 * (s1 - s3) ** 2
    b2 = (13.0 / 12.0) * (s2 - 2 * s3 + s4) ** 2 \
        + 0.25 * (3 * s2 - 4 * s3 + s4) ** 2
    tau = (b0 - b2).abs()
    a0 = 0.1 * (1.0 + (tau / (b0 + eps)) ** 2)
    a1 = 0.6 * (1.0 + (tau / (b1 + eps)) ** 2)
    a2 = 0.3 * (1.0 + (tau / (b2 + eps)) ** 2)
    w = a0 + a1 + a2
    p0 = (2 * s0 - 7 * s1 + 11 * s2) / 6.0
    p1 = (-s1 + 5 * s2 + 2 * s3) / 6.0
    p2 = (2 * s2 + 5 * s3 - s4) / 6.0
    return (a0 * p0 + a1 * p1 + a2 * p2) / w


def _weno5_faces(q, bcs, mesh, axis):
    """5th-order WENO-Z left/right face states along `axis`."""
    P = pad_n(q, bcs, mesh, 3)           # n + 6 along every axis
    t = P
    for ax in range(3):
        if ax != axis:
            t = _sl(t, ax, 3, t.shape[ax - 3] - 3)
    n = mesh.shape[axis]
    # cell (face_own + k) of faces 0..n: padded index f + 2 + k
    sl = lambda k: _sl(t, axis, k + 2, k + 3 + n)
    qL = _weno5_core(sl(-2), sl(-1), sl(0), sl(1), sl(2))
    qR = _weno5_core(sl(3), sl(2), sl(1), sl(0), sl(-1))
    return qL, qR
