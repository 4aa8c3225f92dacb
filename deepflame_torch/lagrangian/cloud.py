"""Lagrangian spray cloud: fixed-capacity structure-of-arrays parcels.

Port of deepflame_tpu/lagrangian/cloud.py (the reference's
KinematicCloud -> ThermoCloud -> ReactingCloud -> SprayCloud stack):
injection, drag, evaporation with the boiling limit, Ranz-Marshall heat
transfer with the Bird correction, breakup, collision, dispersion, wall
interaction and films, devolatilisation, and the gas-phase sources Srho, SU,
Sh and SY that the solvers take.

Layout, as in the JAX package: parcels are fixed-capacity arrays (3, N) and
(N,) with an `active` mask; injection fills a fixed number of slots per step
from a device-side pointer with a per-parcel multiplicity matching the mass
rate, so no shape changes and nothing is read back to the host (stats do
that). Gas -> parcel sampling is a nearest-cell gather; parcel -> gas
sources are `index_put_(..., accumulate=True)` scatter-adds. Every loop the
JAX package runs a fixed number of times (the 50-trip boiling fixed point)
runs that many times here.

Random draws: the JAX package draws from threefry keys split in a fixed
order each step (injection k1, k2, k3; O'Rourke's uniform; dispersion's
normal). A torch.Generator cannot reproduce them, so the cloud state carries
a torch.Generator on the cloud's device (`SprayCloud.init(generator,
dtype)`) and every draw goes through the module-level `draw`, in the JAX
package's order. Replacing `draw` replays any other source of draws, for
example the JAX package's, draw for draw.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ..mesh.structured import StructuredMesh
from .liquids import Liquid

__all__ = ["CloudState", "ConeInjector", "ManualInjector",
           "PatchFuncInjector", "SprayCloud", "CloudSources", "draw"]


def draw(generator, dist: str, shape, dtype, low: float = 0.0,
         high: float = 1.0):
    """One random draw on the generator's device: dist "uniform" (in [low,
    high)) or "normal" (standard). Every draw of the cloud goes through
    here, in the JAX package's order."""
    dev = generator.device
    if dist == "normal":
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=dev)
    u = torch.rand(shape, generator=generator, dtype=dtype, device=dev)
    return u if (low, high) == (0.0, 1.0) else u * (high - low) + low


class CloudState(NamedTuple):
    pos: torch.Tensor        # (3, N)
    vel: torch.Tensor        # (3, N)
    d: torch.Tensor          # (N,) droplet diameter [m]
    T: torch.Tensor          # (N,) droplet temperature
    n_part: torch.Tensor     # (N,) droplets per parcel
    active: torch.Tensor     # (N,) 0/1
    inject_ptr: torch.Tensor  # 0-d int: next slot to fill
    m_injected: torch.Tensor  # 0-d: total injected mass
    generator: Any           # torch.Generator on the cloud's device
    m_vol: torch.Tensor      # (C, N) volatile mass per droplet and component
    films: tuple = ()        # per film wall: WallFilmState


class CloudSources(NamedTuple):
    Srho: torch.Tensor       # (nx, ny, nz) mass [kg/m^3/s]
    SU: torch.Tensor         # (3, nx, ny, nz) momentum
    Sh: torch.Tensor         # (nx, ny, nz) energy [J/m^3/s]
    SY: torch.Tensor         # (nx, ny, nz) vapour species mass


def _interp(x, xp, fp):
    """jnp.interp of a 0-d x on the table (xp, fp), tensors of x's dtype."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.reshape(1), right=True),
                    1, n - 1)[0]
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    f = fp[i - 1] + (delta / dx) * df
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _time(time, dtype, dev):
    """The clock as a 0-d tensor on `dev` (a number in `dtype`)."""
    if isinstance(time, torch.Tensor):
        return time.to(dev)
    return torch.as_tensor(time, dtype=dtype, device=dev)


def _size_sample(inj, generator, K, dtype):
    """Droplet diameters of one injection: truncated Rosin-Rammler by the
    renormalised inverse CDF, or lognormal about d_mean."""
    if inj.size_dist == "RosinRammler":
        u = draw(generator, "uniform", (K,), dtype)
        Fmin = 1.0 - math.exp(-(inj.rr_min / inj.rr_d) ** inj.rr_n)
        Fmax = 1.0 - math.exp(-(inj.rr_max / inj.rr_d) ** inj.rr_n)
        F = Fmin + u * (Fmax - Fmin)
        dm = inj.rr_d * (-torch.log1p(-F)) ** (1.0 / inj.rr_n)
        return torch.clamp(dm, inj.rr_min, inj.rr_max)
    dm = inj.d_mean * torch.exp(inj.d_spread
                                * draw(generator, "normal", (K,), dtype))
    return torch.clamp(dm, 0.2 * inj.d_mean, 4.0 * inj.d_mean)


@dataclasses.dataclass(frozen=True)
class ManualInjector:
    """manualInjection (the water-mist detonation): `positions` (N0, 3),
    all released in the step whose interval holds `soi`, with a fixed
    multiplicity and diameter. The cloud's max_parcels must be >= N0."""
    positions: Any = ()
    soi: float = 0.0
    d0: float = 5e-6
    n_particle: float = 275.0
    T_inject: float = 300.0
    U0: tuple = (0.0, 0.0, 0.0)
    rho_liquid: float = 997.0

    @property
    def parcels_per_step(self) -> int:
        return int(np.asarray(self.positions).shape[0])

    @property
    def t_start(self) -> float:
        return self.soi

    @property
    def t_end(self) -> float:
        return self.soi          # one-shot

    def sample(self, generator, time, dt, dtype):
        dev = generator.device
        pos = torch.as_tensor(np.asarray(self.positions, dtype=np.float64).T,
                              dtype=dtype, device=dev)
        K = pos.shape[1]
        vel = torch.as_tensor(self.U0, dtype=dtype,
                              device=dev)[:, None].expand(3, K)
        dm = torch.full((K,), self.d0, dtype=dtype, device=dev)
        m_drop = self.rho_liquid * math.pi / 6.0 * self.d0 ** 3
        mass_step = K * self.n_particle * m_drop
        # release exactly once: the step whose interval holds SOI
        time = _time(time, dtype, dev)
        injecting = (time <= self.soi) & (time + dt > self.soi)
        return pos, vel, dm, mass_step, injecting


@dataclasses.dataclass(frozen=True)
class ConeInjector:
    """Cone-nozzle injection (coneInjection with flowRateAndDischarge, a
    size distribution and a flowRateProfile table). cone_angle_deg is the
    full cone angle. mdot_profile: ((t, relative rate), ...), normalised so
    that its integral equals mass_total. u_from_flow: speed from the flow
    through the orifice, U = mdot / (rho_l Cd pi/4 (d_outer^2 -
    d_inner^2))."""
    position: tuple
    direction: tuple = (0.0, -1.0, 0.0)
    cone_angle_deg: float = 10.0
    u_mag: float = 200.0
    mdot: float = 1e-3            # kg/s
    t_start: float = 0.0
    t_end: float = 1.25e-3
    d_mean: float = 8e-5
    d_spread: float = 0.3
    parcels_per_step: int = 8
    T_inject: float = 320.0
    mdot_profile: tuple = ()
    mass_total: float | None = None
    size_dist: str = "lognormal"  # lognormal | RosinRammler
    rr_d: float = 1.5e-4
    rr_n: float = 3.0
    rr_min: float = 1e-6
    rr_max: float = 1.5e-4
    u_from_flow: bool = False
    Cd: float = 0.9
    d_outer: float = 1.2e-4
    d_inner: float = 0.0
    rho_liquid: float = 680.0     # liquid density at T_inject

    def _mdot_now(self, time, dtype):
        """Instantaneous mass flow rate [kg/s]."""
        dev = time.device
        if not self.mdot_profile:
            return torch.as_tensor(self.mdot, dtype=dtype, device=dev)
        tab = np.asarray(self.mdot_profile, dtype=np.float64)
        ts, rs = tab[:, 0].copy(), tab[:, 1].copy()
        if self.mass_total is not None:
            # the trapezoidal integral of the table is mass_total
            integral = (np.diff(ts) * (rs[1:] + rs[:-1]) / 2.0).sum()
            rs = rs * (self.mass_total / integral)
        f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        return _interp(time.to(dtype), f(ts), f(rs))

    def sample(self, generator, time, dt, dtype):
        """(pos (3, K), vel (3, K), d (K,), mass of this step, injecting)."""
        K = self.parcels_per_step
        dev = generator.device
        dm = _size_sample(self, generator, K, dtype)
        half = math.radians(self.cone_angle_deg / 2.0)
        axis = np.asarray(self.direction, dtype=np.float64)
        axis = axis / np.linalg.norm(axis)
        ref = np.array([1.0, 0.0, 0.0]) if abs(axis[0]) < 0.9 \
            else np.array([0.0, 1.0, 0.0])
        a1 = np.cross(axis, ref)
        a1 = a1 / np.linalg.norm(a1)
        a2 = np.cross(axis, a1)
        phi = draw(generator, "uniform", (K,), dtype, 0.0, 2.0 * math.pi)
        cos_t = 1.0 - draw(generator, "uniform", (K,), dtype) \
            * (1.0 - math.cos(half))
        sin_t = torch.sqrt(1.0 - cos_t**2)
        f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)[:, None]
        dirs = (f(axis) * cos_t[None, :]
                + f(a1) * (sin_t * torch.cos(phi))[None, :]
                + f(a2) * (sin_t * torch.sin(phi))[None, :])
        pos = f(self.position) + 0.0 * dirs
        time = _time(time, dtype, dev)
        injecting = (time >= self.t_start) & (time < self.t_end)
        mdot_now = self._mdot_now(time, dtype)
        if self.u_from_flow:
            A = math.pi / 4.0 * (self.d_outer ** 2 - self.d_inner ** 2)
            u_mag = mdot_now / (self.rho_liquid * self.Cd * A)
        else:
            u_mag = torch.as_tensor(self.u_mag, dtype=dtype, device=dev)
        return pos, u_mag * dirs, dm, mdot_now * dt, injecting


@dataclasses.dataclass(frozen=True)
class PatchFuncInjector:
    """Patch-function injection (PatchFuncInjection): positions uniform over
    the rectangle [lo, hi] (flat along the patch normal), velocity
    `u_fn(x, y, z, t)` -> (3, K) or the constant `u_const`, flow rate
    `mdot_fn(t)` or the constant `mdot`; with `radial_axis`, that
    coordinate is drawn area-weighted (an axisymmetric wedge patch)."""
    lo: tuple
    hi: tuple
    u_const: tuple = (0.0, -10.0, 0.0)
    u_fn: Any = None
    mdot: float = 1e-3
    mdot_fn: Any = None
    t_start: float = 0.0
    t_end: float = 1e-3
    d_mean: float = 8e-5
    d_spread: float = 0.3
    parcels_per_step: int = 8
    T_inject: float = 320.0
    size_dist: str = "lognormal"  # lognormal | RosinRammler
    rr_d: float = 2e-5
    rr_n: float = 3.0
    rr_min: float = 5e-6
    rr_max: float = 1e-4
    radial_axis: int | None = None

    def sample(self, generator, time, dt, dtype):
        K = self.parcels_per_step
        dev = generator.device
        dm = _size_sample(self, generator, K, dtype)
        lo = torch.as_tensor(self.lo, dtype=dtype, device=dev)
        hi = torch.as_tensor(self.hi, dtype=dtype, device=dev)
        u01 = draw(generator, "uniform", (3, K), dtype)
        if self.radial_axis is not None:
            u01 = u01.clone()
            u01[self.radial_axis] = torch.sqrt(u01[self.radial_axis])
        pos = lo[:, None] + u01 * (hi - lo)[:, None]
        if self.u_fn is not None:
            vel = torch.as_tensor(self.u_fn(pos[0], pos[1], pos[2], time),
                                  dtype=dtype, device=dev)
            vel = vel.reshape(3, -1).expand(3, K)
        else:
            vel = torch.as_tensor(self.u_const, dtype=dtype,
                                  device=dev)[:, None].expand(3, K)
        time = _time(time, dtype, dev)
        mdot_now = self.mdot_fn(time) if self.mdot_fn is not None \
            else self.mdot
        injecting = (time >= self.t_start) & (time < self.t_end)
        return pos, vel, dm, mdot_now * dt, injecting


@dataclasses.dataclass(frozen=True)
class SprayCloud:
    """The spray cloud on a structured mesh; its state lives on the mesh's
    device. Sub-models as in the JAX package: evaporation Spalding | D2law
    | none; drag SchillerNaumann | sphereDrag; breakup ReitzDiwakar | KHRT
    | none; collision ORourke | none; stochastic dispersion (reads the
    gas dict's k_turb); wall_interaction ((axis, side, mode), ...) with mode
    escape | rebound | stick | film (each film wall has its WallFilm in
    `films`); devolatilisation ((A1, E, Y0), ...); gravity; mass_first
    (phase change before the drag, the reference's v1.4 order)."""
    mesh: StructuredMesh
    liquid: Liquid
    injector: Any
    max_parcels: int = 8192
    evaporation: str = "Spalding"
    drag: str = "SchillerNaumann"
    gravity: tuple = (0.0, 0.0, 0.0)
    breakup: str = "none"
    collision: str = "none"
    dispersion: bool = False
    wall_interaction: tuple = ()
    films: tuple = ()
    devolatilisation: tuple = ()
    restitution: float = 0.7
    mass_first: bool = False
    Sc_gas: float = 0.7
    Pr_gas: float = 0.7
    film_w: float = 2.0 / 3.0     # film temperature weight on the droplet
    # ReitzDiwakar coefficients
    Cbag: float = 6.0
    Cb: float = 0.785
    Cstrip: float = 0.5
    Cs: float = 10.0
    # ReitzKHRT coefficients
    b0: float = 0.61
    b1: float = 40.0
    cTau: float = 1.0
    cRT: float = 0.1
    weber_limit: float = 6.0
    d_min: float = 1e-6

    def init(self, generator=None, dtype=torch.float64) -> CloudState:
        """Empty cloud state; `generator` (a torch.Generator on the mesh's
        device; default: one seeded with 0) takes every draw."""
        dev = self.mesh.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        if generator.device.type != dev.type:
            raise ValueError(f"the generator is on {generator.device}, the "
                             f"mesh on {dev}")
        N = self.max_parcels
        z = torch.zeros((N,), dtype=dtype, device=dev)
        return CloudState(
            pos=torch.zeros((3, N), dtype=dtype, device=dev),
            vel=torch.zeros((3, N), dtype=dtype, device=dev),
            d=z + 1e-6, T=z + 300.0, n_part=z, active=z,
            inject_ptr=torch.zeros((), dtype=torch.int64, device=dev),
            m_injected=torch.zeros((), dtype=dtype, device=dev),
            generator=generator,
            m_vol=torch.zeros((len(self.devolatilisation), N), dtype=dtype,
                              device=dev),
            films=tuple(fl.init(self.mesh, dtype) for fl in self.films))

    # ------------------------------------------------------------ helpers
    def _cell_index(self, pos):
        m = self.mesh
        ix = lambda x, o, h, n: torch.clamp(((x - o) / h).to(torch.int32),
                                            0, n - 1).long()
        return (ix(pos[0], m.x0, m.dx, m.nx), ix(pos[1], m.y0, m.dy, m.ny),
                ix(pos[2], m.z0, m.dz, m.nz))

    def _in_domain(self, pos):
        m = self.mesh
        return ((pos[0] >= m.x0) & (pos[0] <= m.x0 + m.nx * m.dx)
                & (pos[1] >= m.y0) & (pos[1] <= m.y0 + m.ny * m.dy)
                & (pos[2] >= m.z0) & (pos[2] <= m.z0 + m.nz * m.dz))

    def _scatter(self, idx, vals, shape=None):
        out = torch.zeros(self.mesh.shape if shape is None else shape,
                          dtype=vals.dtype, device=vals.device)
        return out.index_put_(idx, vals, accumulate=True)

    # ------------------------------------------------------------- evolve
    def _phase_change(self, liq, gas, g, d, Tp, Re, rho_g, T_g, mu_g,
                      p_g, Yv_g, dt):
        """Phase change of one substep (LiquidEvaporationBoil): (dm_dt, dm,
        m_new, m_d, (T_film, Sh, Nu, cp_c, kappa_c))."""
        rho_l = liq.rho(Tp)
        m_d = rho_l * math.pi / 6.0 * d**3
        # vapour diffusivity at film conditions (2/3 rule)
        T_film = self.film_w * Tp + (1.0 - self.film_w) * T_g
        D_v = liq.D_vap(T_film, p_g)
        Sc_f = mu_g / torch.clamp(rho_g * D_v, min=1e-20)
        sqrt_Re = torch.sqrt(torch.clamp(Re, min=0.0))
        Sh = 2.0 + 0.6 * sqrt_Re * Sc_f**(1/3)
        Nu = 2.0 + 0.6 * sqrt_Re * self.Pr_gas**(1/3)
        # the carrier's cp and kappa where the solver gives them
        cp_c = g(gas["cp"]) if "cp" in gas else torch.full_like(rho_g, 1005.0)
        kappa_c = g(gas["kappa"]) if "kappa" in gas \
            else mu_g * 1005.0 / self.Pr_gas
        if self.evaporation == "none":
            dm_dt = torch.zeros_like(d)
        else:
            T_boil_pc = liq.T_boil_at(p_g)
            Td = torch.minimum(Tp, 0.999 * T_boil_pc)
            p_sat = liq.p_sat(Td)
            # evaporation: molar Spalding ratio with the film density
            x_s = torch.clamp(p_sat / torch.clamp(p_g, min=1.0), 0.0, 0.999)
            W_g = 28.9
            W_mix = 1.0 / (Yv_g / liq.W + (1.0 - Yv_g) / W_g)
            X_c = Yv_g * W_mix / liq.W
            Xr = torch.clamp((x_s - X_c) / torch.clamp(1.0 - x_s, min=1e-6),
                             0.0, 50.0)
            rho_s = rho_g * T_g / torch.clamp(T_film, min=200.0)
            dm_dt_evap = math.pi * d * Sh * rho_s * D_v * torch.log1p(Xr)
            if self.evaporation != "Spalding":   # the classic D2 law
                dm_dt_evap = math.pi * d * Sh * rho_s * D_v * Xr
            # boiling: heat-limited Spalding-log rate, iterated, plus the
            # nucleate flash-boil
            hv = liq.latent_heat(Td)
            dT_sup = torch.clamp(Tp - T_boil_pc, min=0.5)
            alphaS = torch.where(
                dT_sup < 5.0, 760.0 * dT_sup**0.26,
                torch.where(dT_sup < 25.0, 27.0 * dT_sup**2.33,
                            13800.0 * dT_sup**0.39))
            Gf = alphaS * dT_sup * math.pi * d**2 / hv
            cp_s = liq.cp_vap(T_film)
            A_sp = torch.clamp(cp_c * (T_g - T_film), min=0.0) / hv
            B_sp = math.pi * (kappa_c / torch.clamp(cp_s, min=1.0)) * d * Sh
            Gr = torch.full_like(d, 1e-5)
            for _ in range(50):                  # jax.lax.fori_loop(0, 50)
                G = B_sp / (1.0 + Gr) * torch.log1p(A_sp * (1.0 + Gr))
                Gr = Gf / torch.clamp(G, min=1e-30)
            G_heat = torch.where(
                A_sp > 0.0, B_sp / (1.0 + Gr) * torch.log1p(A_sp * (1.0 + Gr)),
                torch.zeros_like(A_sp))
            dm_dt_boil = G_heat + Gf
            boiling = p_sat > 0.999 * torch.clamp(p_g, min=1.0)
            saturated = X_c * torch.clamp(p_g, min=1.0) > p_sat
            dm_dt = torch.where(boiling, dm_dt_boil,
                                torch.where(saturated,
                                            torch.zeros_like(dm_dt_evap),
                                            dm_dt_evap))
        dm = torch.minimum(torch.clamp(dm_dt * dt, min=0.0), 0.95 * m_d)
        m_new = m_d - dm
        return dm_dt, dm, m_new, m_d, (T_film, Sh, Nu, cp_c, kappa_c)

    def evolve(self, c: CloudState, gas: dict, dt,
               time) -> tuple[CloudState, CloudSources]:
        """One Lagrangian substep (parcels.evolve()). gas: cell fields rho,
        U (3, ...), T, mu, p and optionally Yv (vapour mass fraction), cp,
        kappa and k_turb. `time` (a 0-d tensor or a number) and dt set the
        injection."""
        inj = self.injector
        liq = self.liquid
        dtype = c.d.dtype
        dev = c.d.device
        N = self.max_parcels
        gen = c.generator
        zero = torch.zeros((), dtype=dtype, device=dev)

        # ==== injection: K slots per step, multiplicity matches the mass
        K = inj.parcels_per_step
        slots = (c.inject_ptr + torch.arange(K, device=dev)) % N
        pos_inj, vel_inj, dm, mass_step, injecting = inj.sample(
            gen, time, dt, dtype)
        mass_step = torch.as_tensor(mass_step, dtype=dtype, device=dev)
        m_drop = liq.rho(inj.T_inject) * math.pi / 6.0 * dm**3
        n_per = torch.where(injecting, mass_step / K / m_drop, zero)

        def set_slots(arr, vals):
            out = arr.clone()
            out[..., slots] = torch.where(injecting, vals, arr[..., slots])
            return out

        pos = set_slots(c.pos, pos_inj)
        vel = set_slots(c.vel, vel_inj)
        d = set_slots(c.d, dm)
        Tp = set_slots(c.T, torch.full((K,), inj.T_inject, dtype=dtype,
                                       device=dev))
        n_part = set_slots(c.n_part, n_per)
        if self.devolatilisation:
            Y0 = torch.as_tensor([y0 for (_, _, y0) in self.devolatilisation],
                                 dtype=dtype, device=dev)
            m_vol = set_slots(c.m_vol, Y0[:, None] * m_drop[None, :])
        else:
            m_vol = c.m_vol
        active = set_slots(c.active, torch.where(
            injecting, torch.ones((K,), dtype=dtype, device=dev), zero))
        ptr = torch.where(injecting, (c.inject_ptr + K) % N, c.inject_ptr)
        m_injected = c.m_injected + torch.where(injecting, mass_step, zero)

        # ==== gas state at the parcels (nearest cell)
        idx = self._cell_index(pos)
        g = lambda f: f[idx]
        rho_g = g(gas["rho"])
        T_g = g(gas["T"])
        mu_g = g(gas["mu"])
        p_g = g(gas["p"])
        u_g = torch.stack([g(gas["U"][a]) for a in range(3)])
        Yv_g = g(gas["Yv"]) if "Yv" in gas else torch.zeros_like(rho_g)

        # ==== kinematic prelude (drag and evaporation)
        rho_l = liq.rho(Tp)
        rel = u_g - vel
        rel_mag = torch.sqrt((rel**2).sum(0) + 1e-30)
        Re = rho_g * rel_mag * d / torch.clamp(mu_g, min=1e-12)

        if self.mass_first:
            # phase change first; the drag sees the reduced mass
            dm_dt, dm, m_new, m_d, evap_aux = self._phase_change(
                liq, gas, g, d, Tp, Re, rho_g, T_g, mu_g, p_g, Yv_g, dt)
            d_drag = (6.0 * m_new / (math.pi * rho_l)) ** (1.0 / 3.0)
        else:
            d_drag = d

        # ==== drag, analytically implicit
        if self.drag == "sphereDrag":
            Cd_Re24 = torch.where(Re < 1000.0, 1.0 + Re ** (2.0 / 3.0) / 6.0,
                                  0.424 * Re / 24.0)
        else:                                     # Schiller-Naumann
            Cd_Re24 = 1.0 + 0.15 * Re**0.687
        tau_p = rho_l * d_drag**2 \
            / (18.0 * torch.clamp(mu_g, min=1e-12) * Cd_Re24)
        f_rel = dt / torch.clamp(tau_p, min=1e-12)
        # gravity and buoyancy g (1 - rho_g/rho_l): relax toward
        # u_g + tau_p g_eff
        if any(self.gravity):
            g_vec = torch.as_tensor(self.gravity, dtype=dtype, device=dev)
            g_eff = g_vec[:, None] * (1.0 - rho_g / rho_l)[None, :]
        else:
            g_eff = torch.zeros((3, 1), dtype=dtype, device=dev)
        rel_eq = rel + tau_p[None, :] * g_eff
        vel_new = vel + rel_eq * (1.0 - torch.exp(-f_rel))
        # the gas exchanges the drag impulse only
        dmom = (vel_new - vel) - g_eff * dt

        # ==== evaporation (done above in the mass_first order)
        if not self.mass_first:
            dm_dt, dm, m_new, m_d, evap_aux = self._phase_change(
                liq, gas, g, d, Tp, Re, rho_g, T_g, mu_g, p_g, Yv_g, dt)
        T_film, Sh, Nu, cp_c, kappa_c = evap_aux

        # ==== devolatilisation: dm = min(dt A1 exp(-E/(R T)) m_vol, m_vol)
        if self.devolatilisation:
            R_kmol = 8314.462618
            A1 = torch.as_tensor([a for (a, _, _) in self.devolatilisation],
                                 dtype=dtype, device=dev)
            E = torch.as_tensor([e for (_, e, _) in self.devolatilisation],
                                dtype=dtype, device=dev)
            kappa_dv = A1[:, None] * torch.exp(-E[:, None]
                                               / (R_kmol * Tp[None, :]))
            dm_dv = torch.minimum(dt * kappa_dv * m_vol, m_vol) \
                * (active > 0)[None, :]
            dm_dv_sum = dm_dv.sum(0)
            dm_dv_tot = torch.minimum(dm_dv_sum, 0.95 * m_new)
            m_vol = m_vol - dm_dv * torch.where(
                dm_dv_sum > 0.0,
                dm_dv_tot / torch.clamp(dm_dv_sum, min=1e-300), zero)[None, :]
            m_new = m_new - dm_dv_tot
        else:
            dm_dv_tot = torch.zeros_like(m_new)

        # ==== heat transfer (Ranz-Marshall, implicit) and the latent sink
        h_conv = Nu * kappa_c / torch.clamp(d, min=1e-9)
        area = math.pi * d**2
        if self.evaporation != "none":
            # Bird correction: htc *= phi/(e^phi - 1), phi = NCpW/htc
            NCpW = (dm_dt / torch.clamp(area, min=1e-20)) * liq.cp_vap(T_film)
            phi_bird = torch.clamp(NCpW / torch.clamp(h_conv, min=1e-20),
                                   0.0, 50.0)
            h_conv = torch.where(
                phi_bird > 1e-3,
                h_conv * phi_bird / torch.expm1(torch.clamp(phi_bird,
                                                            min=1e-6)),
                h_conv)
        cp_l = liq.cp(Tp)
        tau_T = m_d * cp_l / torch.clamp(h_conv * area, min=1e-20)
        L = liq.latent_heat(Tp)
        T_new = T_g + (Tp - T_g) * torch.exp(-dt / torch.clamp(tau_T,
                                                                min=1e-12))
        T_new = T_new - dm * L / torch.clamp(m_d * cp_l, min=1e-20)
        # no hotter than the local-pressure boiling point
        T_cap = liq.T_boil_at(p_g) if self.evaporation != "none" \
            else torch.full_like(T_new, liq.T_crit - 1.0)
        T_new = torch.minimum(torch.clamp(T_new, min=250.0), T_cap)
        # diameter from the parcel mass at the new liquid density
        d_new = (6.0 * m_new / (math.pi * liq.rho(T_new))) ** (1.0 / 3.0)

        # ==== breakup
        if self.breakup == "ReitzDiwakar":
            # OpenFOAM-7 ReitzDiwakar::update: We with the 1/2, bag and
            # stripping stable diameters, implicit relaxation
            sigma = max(liq.sigma, 1e-10)
            rho_l_b = liq.rho(T_new)
            urel = torch.clamp(rel_mag, min=1e-10)
            We = 0.5 * rho_g * urel**2 * d_new / sigma
            Re_b = torch.clamp(Re, min=1e-10)
            strip = We > self.Cstrip * torch.sqrt(Re_b)
            d_strip = (2.0 * self.Cstrip * sigma) ** 2 \
                / (rho_g * urel**3 * torch.clamp(mu_g, min=1e-12))
            tau_strip = self.Cs * d_new \
                * torch.sqrt(rho_l_b / torch.clamp(rho_g, min=1e-10)) / urel
            d_bag = 2.0 * self.Cbag * sigma / (rho_g * urel**2)
            tau_bag = self.Cb * d_new * torch.sqrt(rho_l_b * d_new / sigma)
            d_stable = torch.clamp(torch.where(strip, d_strip, d_bag),
                                   min=self.d_min)
            tau = torch.where(strip, tau_strip, tau_bag)
            breaking = We > self.Cbag
            f_b = torch.where(breaking, dt / torch.clamp(tau, min=1e-12),
                              zero)
            d_broken = (f_b * d_stable + d_new) / (1.0 + f_b)
            d_broken = torch.maximum(d_broken, torch.minimum(d_stable, d_new))
            # parcel liquid mass conserved: n d^3 constant
            n_part = n_part * (d_new / torch.clamp(d_broken, min=1e-9)) ** 3
            d_new = d_broken
        elif self.breakup == "KHRT":
            # Kelvin-Helmholtz / Rayleigh-Taylor (ReitzKHRT), both as
            # diameter relaxation toward the child size
            sigma = max(liq.sigma, 1e-10)
            rho_l_b = liq.rho(T_new)
            mu_l = liq.mu(T_new)
            r = torch.clamp(0.5 * d_new, min=1e-9)
            urel = torch.clamp(rel_mag, min=1e-10)
            we_g = rho_g * urel**2 * r / sigma
            we_l = rho_l_b * urel**2 * r / sigma
            re_l = rho_l_b * urel * r / torch.clamp(mu_l, min=1e-10)
            oh = torch.sqrt(we_l) / re_l
            ta = oh * torch.sqrt(we_g)
            lam_kh = 9.02 * r * (1.0 + 0.45 * torch.sqrt(oh)) \
                * (1.0 + 0.4 * ta**0.7) \
                / (1.0 + 0.865 * we_g**1.67) ** 0.6
            omega_kh = (0.34 + 0.38 * we_g**1.5) \
                / ((1.0 + oh) * (1.0 + 1.4 * ta**0.6)) \
                * torch.sqrt(sigma / (rho_l_b * r**3))
            d_kh = torch.clamp(2.0 * self.b0 * lam_kh, min=self.d_min)
            tau_kh = 3.726 * self.b1 * r / torch.clamp(omega_kh * lam_kh,
                                                        min=1e-20)
            kh_on = (we_g > self.weber_limit) & (d_kh < d_new)
            # RT: the deceleration along the trajectory
            g_t = 0.375 * (24.0 / torch.clamp(Re, min=1e-6)) * Cd_Re24 \
                * rho_g * urel**2 / (rho_l_b * r)
            drho = torch.clamp(rho_l_b - rho_g, min=1e-3)
            k_rt = torch.sqrt(g_t * drho / (3.0 * sigma))
            omega_rt = torch.sqrt(
                (2.0 / (3.0 * math.sqrt(3.0 * sigma)))
                * (g_t * drho) ** 1.5 / (rho_l_b + rho_g))
            lam_rt = 2.0 * math.pi * self.cRT / torch.clamp(k_rt, min=1e-6)
            d_rt = torch.clamp(lam_rt, min=self.d_min)
            tau_rt = self.cTau / torch.clamp(omega_rt, min=1e-20)
            rt_on = d_rt < d_new
            use_rt = rt_on & (~kh_on | (tau_rt < tau_kh))
            d_child = torch.where(use_rt, d_rt, d_kh)
            tau = torch.where(use_rt, tau_rt, tau_kh)
            breaking = kh_on | rt_on
            frac = torch.where(breaking,
                               1.0 - torch.exp(-dt / torch.clamp(tau,
                                                                 min=1e-12)),
                               zero)
            d_broken = torch.maximum(d_new - frac * (d_new - d_child),
                                     torch.minimum(d_child, d_new))
            n_part = n_part * (d_new / torch.clamp(d_broken, min=1e-9)) ** 3
            d_new = d_broken

        # ==== O'Rourke collision against the cell-mean population
        if self.collision == "ORourke":
            Vc = self.mesh.volume
            w_act = n_part * (active > 0)
            num = self._scatter(idx, w_act)
            d2s = self._scatter(idx, w_act * d**2)
            d3s = self._scatter(idx, w_act * d**3)
            mom_c = [self._scatter(idx, w_act * vel_new[a]) for a in range(3)]
            n_cell = num[idx]
            d32_c = d3s[idx] / torch.clamp(d2s[idx], min=1e-30)
            u_cell = torch.stack([mom_c[a][idx] for a in range(3)]) \
                / torch.clamp(n_cell, min=1e-30)
            n_dens = torch.clamp(n_cell - n_part, min=0.0) / Vc
            v_rel_c = torch.sqrt(((vel_new - u_cell) ** 2).sum(0) + 1e-30)
            freq = n_dens * math.pi / 4.0 * (d_new + d32_c) ** 2 * v_rel_c
            p_coll = 1.0 - torch.exp(-freq * dt)
            rho_l_c = liq.rho(T_new)
            We_c = rho_l_c * v_rel_c**2 * torch.minimum(d_new, d32_c) \
                / max(liq.sigma, 1e-10)
            coal_eff = torch.clamp(torch.clamp(
                2.4 / torch.clamp(We_c, min=1e-6), max=1.0), 0.0, 1.0)
            u_rand = draw(gen, "uniform", (N,), dtype)
            coalesce = (u_rand < p_coll * coal_eff) & (active > 0) \
                & (n_dens > 0.0)
            # pair-volume diameter; the multiplicity falls (two -> one)
            d_coal = (d_new**3 + d32_c**3) ** (1.0 / 3.0)
            v_coal = (vel_new * d_new[None] ** 3
                      + u_cell * d32_c[None] ** 3) \
                / torch.clamp(d_new**3 + d32_c**3, min=1e-30)[None]
            grow = torch.where(coalesce,
                               d_coal / torch.clamp(d_new, min=1e-12),
                               torch.ones_like(d_new))
            d_new = d_new * grow
            n_part = n_part / grow**3
            vel_new = torch.where(coalesce[None, :], v_coal, vel_new)

        # ==== stochastic turbulent dispersion from the local k
        if self.dispersion and "k_turb" in gas:
            k_t = g(gas["k_turb"])
            sigma_u = torch.sqrt(torch.clamp(2.0 * k_t / 3.0, min=0.0))
            xi = draw(gen, "normal", (3, N), dtype)
            vel_new = vel_new + sigma_u * xi * (active > 0)

        # ==== move; wall interaction, then deactivate the escaped and the
        # evaporated (culled small parcels flash-evaporate into dm)
        pos_new = pos + vel_new * dt
        m = self.mesh
        lo_b = (m.x0, m.y0, m.z0)
        hi_b = tuple(o + n * h for o, n, h in
                     zip(lo_b, m.shape, m.spacing))
        films = list(c.films)
        absorbed = torch.zeros((N,), dtype=torch.bool, device=dev)
        for (w_ax, w_side, w_mode) in self.wall_interaction:
            bound = lo_b[w_ax] if w_side == 0 else hi_b[w_ax]
            crossed = (pos_new[w_ax] < bound) if w_side == 0 \
                else (pos_new[w_ax] > bound)
            if w_mode == "rebound":
                pos_new = pos_new.clone()
                vel_new = vel_new.clone()
                pos_new[w_ax] = torch.where(crossed, 2.0 * bound
                                            - pos_new[w_ax], pos_new[w_ax])
                vel_new[w_ax] = torch.where(
                    crossed, -self.restitution * vel_new[w_ax], vel_new[w_ax])
                for t_ax in range(3):        # tangential restitution too
                    if t_ax != w_ax:
                        vel_new[t_ax] = torch.where(
                            crossed, self.restitution * vel_new[t_ax],
                            vel_new[t_ax])
            elif w_mode == "stick":
                eps_in = 1e-6 * (hi_b[w_ax] - lo_b[w_ax])
                park = bound + eps_in if w_side == 0 else bound - eps_in
                pos_new = pos_new.clone()
                pos_new[w_ax] = torch.where(
                    crossed, torch.as_tensor(park, dtype=dtype, device=dev),
                    pos_new[w_ax])
                vel_new = torch.where(crossed[None, :],
                                      torch.zeros_like(vel_new), vel_new)
            elif w_mode == "film":
                # deposit liquid mass, tangential momentum and temperature
                # on the wall face the parcel crossed
                fi = next(i for i, fl in enumerate(self.films)
                          if fl.axis == w_ax and fl.side == w_side)
                fl = self.films[fi]
                t1, t2 = fl.tangential_axes()
                i1 = torch.clamp(((pos_new[t1] - lo_b[t1]) / m.spacing[t1])
                                 .to(torch.int32), 0, m.shape[t1] - 1)
                i2 = torch.clamp(((pos_new[t2] - lo_b[t2]) / m.spacing[t2])
                                 .to(torch.int32), 0, m.shape[t2] - 1)
                hit = crossed & (active > 0) & ~absorbed
                A_f = fl.face_area(m)
                w_m = torch.where(hit, m_new * n_part, zero) / A_f
                mom_t = torch.stack([vel_new[t1], vel_new[t2]]) * w_m[None]
                films[fi] = fl.absorb(films[fi], i1, i2, w_m, mom_t, T_new)
                absorbed = absorbed | hit
        too_small = (active > 0) & (d_new <= 0.5 * self.d_min) & ~absorbed
        dm = dm + torch.where(too_small, m_new, zero)
        m_new = torch.where(too_small, zero, m_new)
        alive = (active > 0) & self._in_domain(pos_new) & ~too_small \
            & ~absorbed
        mask = alive.to(dtype)

        # ==== gas sources per unit volume (scatter-adds); parcels absorbed
        # into a film this step keep theirs
        V = self.mesh.volume
        src_mask = (alive | absorbed).to(dtype)
        w = n_part * src_mask / (V * dt)
        dm_tot = (dm + dm_dv_tot) * w
        Srho = self._scatter(idx, dm_tot)
        SY = Srho
        # momentum: drag reaction minus the momentum the vapour carries
        mom = (-m_d * dmom / dt + (dm + dm_dv_tot) / dt * vel_new) \
            * (n_part * src_mask / V)
        SU = torch.stack([self._scatter(idx, mom[a]) for a in range(3)])
        # energy: convective exchange and the latent heat
        q_conv = -h_conv * area * (T_g - Tp) * (n_part * src_mask / V)
        h_vap = -dm * w * L
        Sh_src = self._scatter(idx, q_conv + h_vap)

        # ==== wall films: heat-up and evaporation into the wall layer
        for fi, fl in enumerate(self.films):
            sl = [slice(None)] * 3
            sl[fl.axis] = 0 if fl.side == 0 else -1
            sl = tuple(sl)
            gw = {k2d: gas[k2d][sl] for k2d in ("rho", "T", "mu", "p")
                  if k2d in gas}
            if "Yv" in gas:
                gw["Yv"] = gas["Yv"][sl]
            dn = m.spacing[fl.axis]
            gw["dn"] = dn
            films[fi], fsrc = fl.evolve(films[fi], gw, liq, dt,
                                        face_area=fl.face_area(m))
            Srho, SY, Sh_src = Srho.clone(), SY.clone(), Sh_src.clone()
            Srho[sl] += fsrc["Srho"] / dn
            SY[sl] += fsrc["SY"] / dn
            Sh_src[sl] += fsrc["Sh"] / dn

        c_new = CloudState(pos=pos_new, vel=vel_new, d=d_new, T=T_new,
                           n_part=n_part, active=mask, inject_ptr=ptr,
                           m_injected=m_injected, generator=gen,
                           m_vol=m_vol * mask[None, :], films=tuple(films))
        return c_new, CloudSources(Srho=Srho, SU=SU, Sh=Sh_src, SY=SY)

    def stats(self, c: CloudState):
        """Active parcels, liquid mass and Sauter diameter (and the films'
        mass and evaporated mass), as 0-d tensors on the cloud's device."""
        m = (self.liquid.rho(c.T) * math.pi / 6.0 * c.d**3 * c.n_part
             * c.active)
        out = dict(n_active=c.active.sum(), liquid_mass=m.sum(),
                   d32=(c.d**3 * c.n_part * c.active).sum()
                   / torch.clamp((c.d**2 * c.n_part * c.active).sum(),
                                 min=1e-30))
        if self.films:
            out["film_mass"] = sum(fs.m.sum() * fl.face_area(self.mesh)
                                   for fs, fl in zip(c.films, self.films))
            out["film_evaporated"] = sum(fs.m_evap for fs in c.films)
        return out
