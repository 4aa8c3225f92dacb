"""The port's face-list density-based solver (solvers/high_speed_fl.py)
against the JAX package's, float64 on the CPU.

Cases: the Sod tube on a face-list mesh with a shift plan, once per flux
scheme, 10 steps, within 1e-10 of each field's largest value; the same tube
without its plan (gathers and ELL sums: the reconstruction's other route);
WENO5-Z on a plan mesh, periodic (against the port's structured WENO5,
1e-11 as JAX holds its own) and with physical ends (the vanLeer fallback
next to them, against JAX, 1e-10); the face-list tube against the
structured one (5e-3, the JAX package's bound for the two backends, whose
boundary-adjacent gradient stencils differ); the 2D H2-air detonation
channel on the face-list backend with split chemistry, 2 steps, 1e-8
(the stiff drain's round-off, as tests/test_torch_high_speed.py).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflame_tpu.chemistry import load_mechanism, make_kinetics, make_thermo
from deepflame_tpu.mesh import StructuredMesh, empty, symmetry, zero_gradient
from deepflame_tpu.mesh.facelist import from_structured as j_from_structured
from deepflame_tpu.solvers.high_speed import HighSpeedConfig
from deepflame_tpu.solvers.high_speed_fl import (HighSpeedFLState as JState,
                                                HighSpeedSolverFL as JSolver)
from deepflame_tpu.chemistry.integrator import RosenbrockOptions

import deepflame_torch.mesh as tmesh
from deepflame_torch.cases import (detonation_2d_h2_fl, detonation_dt,
                                   sod_shock_tube)
from deepflame_torch.convert import hs_fl_state_from_numpy
from deepflame_torch.mesh.facelist import from_structured
from deepflame_torch.solvers.high_speed_fl import HighSpeedSolverFL
from test_torch_high_speed import _rel

DATA = os.path.join(os.path.dirname(__file__), "data")
AIR = os.path.join(DATA, "air.yaml")
MECH = os.path.join(DATA, "h2_air_9sp.json")
FIELDS = ("rho", "rhoU", "rhoE", "rhoY", "T")


def _flat(x):
    return x.reshape(-1) if x.dim() == 3 else x.reshape(x.shape[0], -1).T


def _fl_of(solver_s, state_s, plan=True):
    """The face-list solver and state of a port structured solver (the mesh
    through from_structured with each field's BCs)."""
    fl = lambda b: from_structured(solver_s.mesh, b, device="cpu")
    sol = HighSpeedSolverFL(
        m_rho=fl(solver_s.bcs_rho), m_p=fl(solver_s.bcs_p),
        m_Y=fl(solver_s.bcs_Y), m_U=tuple(fl(b) for b in solver_s.bcs_U),
        thermo=solver_s.thermo, kinetics=solver_s.kinetics,
        config=solver_s.config)
    if not plan:
        nop = lambda m: dataclasses.replace(m, plan=None)
        sol = dataclasses.replace(sol, m_rho=nop(sol.m_rho),
                                  m_p=nop(sol.m_p), m_Y=nop(sol.m_Y),
                                  m_U=tuple(nop(m) for m in sol.m_U))
    from deepflame_torch.solvers.high_speed_fl import HighSpeedFLState
    return sol, HighSpeedFLState(*(_flat(x) if x.dim() else x
                                   for x in state_s))


def _jax_solver(solver_s, bcs_j, mech_path):
    mj = load_mechanism(mech_path)
    m = solver_s.mesh
    mesh = StructuredMesh(m.nx, m.ny, m.nz, m.dx, m.dy, m.dz, m.x0, m.y0,
                          m.z0)
    fl = lambda b: j_from_structured(mesh, b)
    c = solver_s.config
    return JSolver(m_rho=fl(bcs_j[0]), m_p=fl(bcs_j[2]), m_Y=fl(bcs_j[3]),
                   m_U=tuple(fl(b) for b in bcs_j[1]),
                   thermo=make_thermo(mj), kinetics=make_kinetics(mj),
                   config=HighSpeedConfig(
                       flux=c.flux, rk_order=c.rk_order, limiter=c.limiter,
                       chemistry=c.chemistry, T_threshold=c.T_threshold,
                       ode_opts=RosenbrockOptions(*c.ode_opts)))


def _to_jax(s):
    return JState(*(jnp.asarray(x.numpy()) for x in s))


def _run_pair(sj, st, solver_j, solver_t, dt, n, tol):
    step = jax.jit(lambda s: solver_j.step(s, dt))
    for _ in range(n):
        sj, dj = step(sj)
        st, dtd = solver_t.step(st, dt)
    for k in FIELDS:
        assert _rel(getattr(sj, k), getattr(st, k)) <= tol, k
    for k in ("T_max", "p_max", "u_max"):
        assert abs(float(dj[k]) - float(dtd[k])) <= tol * abs(float(dj[k])), k
    return sj, st, dtd


_BX = ((zero_gradient(), zero_gradient()), (empty(), empty()),
       (empty(), empty()))


@pytest.mark.parametrize("flux,limiter,plan", [
    ("HLLC", "vanLeer", True), ("HLLCP", "minmod", True),
    ("AUSMDV", "vanLeer", True), ("Kurganov", "vanLeer", True),
    ("Tadmor", "none", True), ("HLLC", "vanLeer", False),
    ("HLLC", "WENO5", True), ("HLLC", "WENO5", False)])
def test_sod_fl_matches_jax(flux, limiter, plan):
    """The Sod tube (64 cells) on the face-list backend, 10 steps, every
    flux scheme; with and without the shift plan; WENO5 (on the plan: the
    lattice stencils with the vanLeer fallback at the ends; off it:
    vanLeer)."""
    s_solver, s_state, p = sod_shock_tube(AIR, n=64, flux=flux,
                                          limiter=limiter, device="cpu")
    sol_t, st = _fl_of(s_solver, s_state, plan)
    sol_j = _jax_solver(s_solver, (_BX, (_BX,) * 3, _BX, _BX), AIR)
    if not plan:
        nop = lambda m: dataclasses.replace(m, plan=None)
        sol_j = dataclasses.replace(sol_j, m_rho=nop(sol_j.m_rho),
                                    m_p=nop(sol_j.m_p), m_Y=nop(sol_j.m_Y),
                                    m_U=tuple(nop(m) for m in sol_j.m_U))
    _run_pair(_to_jax(st), st, sol_j, sol_t, p["dt"], 10, 1e-10)


def test_fl_matches_structured_uniform_box():
    """The same tube through the port's structured and face-list solvers
    (128 cells, 30 steps): within 5e-3, the JAX package's bound for its
    two backends (tests/test_high_speed_fl.py)."""
    s_solver, s_state, p = sod_shock_tube(AIR, n=128, device="cpu")
    sol_f, sf = _fl_of(s_solver, s_state)
    ss = s_state
    for _ in range(30):
        ss, _ = s_solver.step(ss, p["dt"])
        sf, _ = sol_f.step(sf, p["dt"])
    for k in ("rho", "rhoE"):
        a, b = _flat(getattr(ss, k)), getattr(sf, k)
        assert float((a - b).abs().max() / a.abs().max()) < 5e-3, k


def test_weno5_plan_periodic_matches_structured():
    """WENO5-Z on a fully periodic plan mesh: the lattice rolls are the
    structured 5-cell stencils, so the port's two backends agree to
    round-off (1e-11, as the JAX package's test)."""
    from deepflame_torch.solvers.high_speed import (HighSpeedConfig as TCfg,
                                                    HighSpeedSolver as TSolver)
    import deepflame_torch.chemistry as tc
    mt = tc.load_mechanism(AIR, device="cpu")
    n = 64
    bx = ((tmesh.cyclic(), tmesh.cyclic()), (tmesh.empty(), tmesh.empty()),
          (tmesh.empty(), tmesh.empty()))
    s_solver = TSolver(
        mesh=tmesh.StructuredMesh.box([1.0, 1e-2, 1e-2], [n, 1, 1],
                                      device="cpu"),
        thermo=tc.make_thermo(mt), kinetics=tc.make_kinetics(mt),
        bcs_rho=bx, bcs_U=(bx, bx, bx), bcs_p=bx, bcs_Y=bx,
        config=TCfg(flux="HLLC", rk_order=2, limiter="WENO5",
                    chemistry="none"))
    x = (np.arange(n) + 0.5) / n
    W = float(mt.molecular_weights[0])
    rho0 = 1.0 + 0.3 * np.sin(2 * np.pi * x)
    p0 = 1e5 * (1.0 + 0.1 * np.cos(4 * np.pi * x))
    T0 = p0 * W / (rho0 * 8314.46261815324)
    sh = (n, 1, 1)
    ss = s_solver.initial_state(p0.reshape(sh), T0.reshape(sh),
                                np.ones((1,) + sh))
    sol_f, sf = _fl_of(s_solver, ss)
    assert sol_f.m_rho.plan is not None
    dt = 0.3 * (1.0 / n) / 500.0
    for _ in range(20):
        ss, _ = s_solver.step(ss, dt)
        sf, _ = sol_f.step(sf, dt)
    for k in ("rho", "rhoE"):
        a, b = _flat(getattr(ss, k)), getattr(sf, k)
        assert float((a - b).abs().max() / a.abs().max()) < 1e-11, k


def test_detonation_fl_split_chemistry_matches_jax():
    """The 2D H2-air channel on the face-list backend at 24 x 4 (igniters
    over the lower half), split ODE chemistry on the test mechanism, 2
    steps within 1e-8; the burning lanes go through the drain; the state
    converter round-trips."""
    bands = ((0.0, 0.05),)
    sol_t, st = detonation_2d_h2_fl(MECH, nx=24, ny=4, dtype=torch.float64,
                                    device="cpu", igniters=bands)
    from deepflame_torch.cases import detonation_2d_h2
    s_solver, _ = detonation_2d_h2(MECH, nx=24, ny=4, dtype=torch.float64,
                                   device="cpu", igniters=bands)
    e = (empty(), empty())
    zg = (zero_gradient(), zero_gradient())
    wall = (symmetry(negate=True), symmetry(negate=True))
    bs = (zg, zg, e)
    bU = (((symmetry(negate=True), zero_gradient()), zg, e), (zg, wall, e),
          bs)
    sol_j = _jax_solver(s_solver, (bs, bU, bs, bs), MECH)
    st2 = hs_fl_state_from_numpy({k: getattr(st, k).numpy()
                                  for k in st._fields}, device="cpu")
    for a, b in zip(st, st2):
        assert torch.equal(a, b)
    dt = detonation_dt(sol_t)
    _, st, diag = _run_pair(_to_jax(st), st, sol_j, sol_t, dt, 2, 1e-8)
    assert diag["chem_lanes"] >= 4 and int(diag["chem_trips"]) > 0
    assert float(st.T.max()) > 1500.0
