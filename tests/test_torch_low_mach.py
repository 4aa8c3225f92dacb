"""PyTorch port of the low-Mach step against the JAX package (float64, CPU).

Both packages start from one state (the JAX state carried over with
deepflame_torch.convert.state_from_numpy) and take the same steps. Tolerance:
each field's largest deviation over its largest magnitude <= 1e-8 (velocity
and face fluxes: 1e-6, see RTOL_FLOW; dp/dt
through the pressure change it implies: |d(dp/dt)| dt <= 1e-10 max|p|), and
equal Krylov iteration counts. Why not tighter: the Krylov
recurrences see dot products summed in another order by XLA and PyTorch, and
the pressure matvec is the Helmholtz form on the port's CPU path where the
JAX CPU path applies the folded 7-point stencil; both are round-off, but the
pressure solve stops at a relative tolerance of 1e-2, so its round-off
differences are not damped away, and dp/dt divides the small pressure change
of one step.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepflame_tpu.chemistry import (load_mechanism, make_kinetics,
                                     make_thermo, make_transport)
from deepflame_tpu.combustion import NoCombustion
from deepflame_tpu.mesh import StructuredMesh, cyclic, empty
from deepflame_tpu.solvers.low_mach import LowMachConfig, LowMachSolver

import deepflame_torch.chemistry as tc
import deepflame_torch.combustion as tcomb
import deepflame_torch.mesh as tmesh
import deepflame_torch.solvers as tsol
from deepflame_torch.convert import state_from_numpy

DATA = os.path.join(os.path.dirname(__file__), "data")
MECH = os.path.join(DATA, "h2_air_9sp.json")
FIELDS = ("p", "T", "U", "Y", "rho", "ha")
# tolerance of velocity and face fluxes: a pressure deviation dp moves them by
# rAU grad(dp) and rho rAU snGrad(dp), so they carry the pressure's round-off
# differences amplified; in the 2D reacting case the JAX step's own response
# to a 1e-14 relative perturbation of p reaches 7.5e-7 of the largest velocity
# after two steps
RTOL_FLOW = 1e-6


def _to_port(s):
    d = {k: np.asarray(getattr(s, k)) for k in
         ("rho", "U", "p", "ha", "Y", "T", "dpdt", "time")}
    d["phi"] = tuple(np.asarray(f) for f in s.phi)
    d["turb"] = tuple(np.asarray(f) for f in s.turb)
    d["cscalars"] = tuple(np.asarray(f) for f in s.cscalars)
    d["chem_dt"] = s.chem_dt if isinstance(s.chem_dt, tuple) \
        else np.asarray(s.chem_dt)
    return state_from_numpy(d, device="cpu")


def _rel(a, b):
    """Largest deviation over largest magnitude."""
    a = np.asarray(a)
    return np.abs(a - b.numpy()).max() / max(np.abs(a).max(), 1e-300)


def check_chem_dt(a, b, cell_rtol=None):
    """The warm-start chemistry steps: within 1e-8 of the largest, or, with
    `cell_rtol`, within that share of each cell's own value."""
    if cell_rtol is None:
        assert _rel(a, b) <= 1e-8
    else:
        a = np.asarray(a)
        assert (np.abs(a - b.numpy()) <= cell_rtol * np.abs(a)).all()


def run_both(solver_j, state_j, solver_t, dt, n_steps, iters_p_slack=0,
             chem_dt_rtol=None):
    """Step both packages from the JAX state; assert parity after each step.
    Krylov iteration counts must be equal, the pressure count within
    `iters_p_slack`; chem_dt as check_chem_dt(..., chem_dt_rtol)."""
    state_t = _to_port(state_j)
    step = jax.jit(lambda s: solver_j.step(s, dt))
    for _ in range(n_steps):
        state_j, dj = step(state_j)
        state_t, dt_ = solver_t.step(state_t, dt)
        for k in ("iters_U", "iters_Y", "iters_h", "iters_p"):
            if k in dj:
                slack = iters_p_slack if k == "iters_p" else 0
                assert abs(int(dj[k]) - int(dt_[k])) <= slack, \
                    (k, dj[k], dt_[k])
        for k in FIELDS:
            tol = RTOL_FLOW if k == "U" else 1e-8
            assert _rel(getattr(state_j, k), getattr(state_t, k)) <= tol, k
        # dp/dt through the pressure change it implies over the step
        ddp = np.abs(np.asarray(state_j.dpdt) - state_t.dpdt.numpy()).max()
        assert ddp * dt <= 1e-10 * np.abs(np.asarray(state_j.p)).max()
        for ax in range(3):
            assert _rel(state_j.phi[ax], state_t.phi[ax]) <= RTOL_FLOW, \
                ("phi", ax)
        if not isinstance(state_j.chem_dt, tuple):
            check_chem_dt(state_j.chem_dt, state_t.chem_dt, chem_dt_rtol)
    assert torch.isfinite(state_t.T).all()
    return state_j, state_t


def test_inert_air_tgv_2d():
    """2D Taylor-Green vortex in inert air (the JAX test_tgv_inert_flow
    configuration), 3 steps."""
    n = 16
    L = 2.0 * np.pi * 1e-3
    bcs = ((cyclic(), cyclic()), (cyclic(), cyclic()), (empty(), empty()))
    mech = load_mechanism(os.path.join(DATA, "air.yaml"))
    th, tr, kin = make_thermo(mech), make_transport(mech), make_kinetics(mech)
    mesh = StructuredMesh.box([L, L, L / n], [n, n, 1])
    solver_j = LowMachSolver(
        mesh=mesh, thermo=th, transport=tr, combustion=NoCombustion(th, kin),
        bcs_U=(bcs, bcs, bcs), bcs_p=bcs, bcs_h=bcs, bcs_Y=bcs, bcs_rho=bcs,
        config=LowMachConfig(chemistry=False))
    X, Yg, _ = mesh.cell_centers()
    k = 2 * np.pi / L
    U = jnp.stack([jnp.sin(k * X) * jnp.cos(k * Yg),
                   -jnp.cos(k * X) * jnp.sin(k * Yg), jnp.zeros_like(X)])
    state_j = solver_j.initial_state(jnp.full(mesh.shape, 101325.0),
                                     jnp.full(mesh.shape, 300.0),
                                     jnp.ones((1,) + mesh.shape), U)

    mech_t = tc.load_mechanism(os.path.join(DATA, "air.yaml"), device="cpu")
    th_t = tc.make_thermo(mech_t)
    tbcs = ((tmesh.cyclic(), tmesh.cyclic()), (tmesh.cyclic(), tmesh.cyclic()),
            (tmesh.empty(), tmesh.empty()))
    solver_t = tsol.LowMachSolver(
        mesh=tmesh.StructuredMesh.box([L, L, L / n], [n, n, 1], device="cpu"),
        thermo=th_t, transport=tc.make_transport(mech_t),
        combustion=tcomb.NoCombustion(th_t, tc.make_kinetics(mech_t)),
        bcs_U=(tbcs, tbcs, tbcs), bcs_p=tbcs, bcs_h=tbcs, bcs_Y=tbcs,
        bcs_rho=tbcs, config=tsol.LowMachConfig(chemistry=False))
    _, state_t = run_both(solver_j, state_j, solver_t, 2e-6, 3)
    # the port's own initial state equals the JAX one
    s0 = solver_t.initial_state(np.full((n, n, 1), 101325.0),
                                np.full((n, n, 1), 300.0),
                                np.ones((1, n, n, 1)), np.asarray(U))
    np.testing.assert_allclose(s0.rho.numpy(), np.asarray(state_j.rho),
                               rtol=1e-14)


def test_reacting_hot_spot_2d():
    """The 2D reacting case of __graft_entry__._build at n = 8 on the
    9-species test mechanism, 2 steps of 1 us. From the third step on the
    igniting kernel amplifies round-off about a thousandfold per step (the JAX
    step alone turns a 1e-14 perturbation of p into 4e-8 of p after three
    steps), so further steps would test that amplification, not the port."""
    from __graft_entry__ import _build
    from deepflame_torch.cases import reacting_hot_spot_2d

    import deepflame_tpu.chemistry as jc
    orig = jc.load_mechanism
    jc.load_mechanism = lambda path, *a, **k: orig(MECH)
    try:
        solver_j, state_j = _build(n=8, dtype=jnp.float64)
    finally:
        jc.load_mechanism = orig
    solver_t, state_t0 = reacting_hot_spot_2d(MECH, n=8, dtype=torch.float64,
                                              device="cpu")
    for k in FIELDS:
        assert _rel(getattr(state_j, k), getattr(state_t0, k)) <= 1e-14, k
    state_j, state_t = run_both(solver_j, state_j, solver_t, 1e-6, 2)
    assert float(state_t.T.max()) > 1900.0
