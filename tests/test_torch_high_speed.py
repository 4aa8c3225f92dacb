"""PyTorch port of the density-based solver against the JAX package (float64,
CPU): the Riemann fluxes, pad_n, the lane-batched single-cell Rosenbrock
integrator, the Sod tube with every scheme, periodic conservation, LTS, and
the 2D H2-air detonation channel with split chemistry.

Tolerances: fluxes 1e-12 of each output's largest value (elementwise math in
another order); pad_n exact (copies); the integrator 1e-10 in y and equal
per-lane trip counts; whole steps 1e-10 (Sod, no chemistry) and 1e-8 (the
detonation: the stiff drain's round-off through its adaptive trips).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflame_tpu.chemistry import load_mechanism, make_kinetics, make_thermo
from deepflame_tpu.chemistry.integrator import (RosenbrockOptions,
                                                rosenbrock_integrate)
from deepflame_tpu.chemistry.reactor import constant_volume_rhs
from deepflame_tpu.mesh import (StructuredMesh, cyclic, empty, fixed_value,
                                symmetry, zero_gradient)
from deepflame_tpu.mesh.structured import pad_n
from deepflame_tpu.ops.riemann import FLUX_SCHEMES
from deepflame_tpu.solvers.high_speed import (HighSpeedConfig, HighSpeedSolver,
                                             HighSpeedState as JState)

import deepflame_torch.chemistry as tc
import deepflame_torch.mesh as tmesh
from deepflame_torch.cases import detonation_2d_h2, detonation_dt, sod_shock_tube
from deepflame_torch.chemistry.integrator import (
    RosenbrockOptions as TOpts, rosenbrock_integrate as t_integrate)
from deepflame_torch.chemistry.reactor import constant_volume_rhs_batched
from deepflame_torch.mesh.structured import pad_n as t_pad_n
from deepflame_torch.ops.riemann import FLUX_SCHEMES as T_FLUX
from deepflame_torch.solvers.high_speed import HighSpeedState

DATA = os.path.join(os.path.dirname(__file__), "data")
AIR = os.path.join(DATA, "air.yaml")
MECH = os.path.join(DATA, "h2_air_9sp.json")
FIELDS = ("rho", "rhoU", "rhoE", "rhoY", "T")


def _rel(a, b):
    """Largest deviation over the largest magnitude."""
    a, b = np.asarray(a), b.detach().cpu().numpy()
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _face_states(rng, n, ns):
    """Random face states: subsonic, supersonic and zero-velocity faces on
    each side, positive rho, p, E, a."""
    def side():
        a = rng.uniform(300.0, 900.0, n)
        mach = np.concatenate([rng.uniform(-0.9, 0.9, n // 3),
                               rng.choice([-1, 1], n // 3)
                               * rng.uniform(1.1, 3.0, n // 3),
                               np.zeros(n - 2 * (n // 3))])
        rng.shuffle(mach)
        Y = rng.uniform(0.0, 1.0, (n, ns))
        Y /= Y.sum(1, keepdims=True)
        u = mach * a
        v, w = rng.normal(0, 50, n), rng.normal(0, 50, n)
        return dict(rho=rng.uniform(0.1, 5.0, n), u=u, v=v, w=w,
                    p=rng.uniform(1e4, 5e6, n), a=a, Y=Y,
                    E=rng.uniform(1e5, 3e6, n) + 0.5 * (u * u + v * v + w * w))
    return side(), side()


@pytest.mark.parametrize("scheme", sorted(FLUX_SCHEMES))
def test_flux_schemes_match_jax(scheme):
    rng = np.random.default_rng(7)
    L, R = _face_states(rng, 300, 3)
    # some faces with the same state on both sides, some with u = 0 on both
    for k in ("rho", "u", "v", "w", "p", "a", "E", "Y"):
        R[k][:20] = L[k][:20]
    L["u"][20:40] = R["u"][20:40] = 0.0
    assert set(FLUX_SCHEMES) == set(T_FLUX)
    out_j = FLUX_SCHEMES[scheme]({k: jnp.asarray(v) for k, v in L.items()},
                                 {k: jnp.asarray(v) for k, v in R.items()})
    out_t = T_FLUX[scheme]({k: torch.as_tensor(v) for k, v in L.items()},
                           {k: torch.as_tensor(v) for k, v in R.items()})
    assert len(out_j) == len(out_t) == 6
    for j, t in zip(out_j, out_t):
        assert j.shape == tuple(t.shape)
        assert _rel(j, t) <= 1e-12


def test_flux_guards_float32_match_jax():
    """The 1e-300 guards are 0 in float32 in both packages: HLLC's contact
    speed on a face where rho (S - u) cancels, Kurganov at a zero wave
    span, AUSMDV's sign(0) = 0."""
    one = np.ones(4, np.float32)
    st = dict(rho=one, u=0 * one, v=0 * one, w=0 * one, p=1e5 * one,
              E=2e5 * one, a=0 * one, Y=np.ones((4, 1), np.float32))
    for scheme in ("HLLC", "Kurganov", "AUSMDV"):
        st_a = dict(st, a=one * (0.0 if scheme != "AUSMDV" else 340.0))
        out_j = FLUX_SCHEMES[scheme]({k: jnp.asarray(v) for k, v in st_a.items()},
                                     {k: jnp.asarray(v) for k, v in st_a.items()})
        out_t = T_FLUX[scheme]({k: torch.as_tensor(v) for k, v in st_a.items()},
                               {k: torch.as_tensor(v) for k, v in st_a.items()})
        for j, t in zip(out_j, out_t):
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(np.isnan(np.asarray(j)),
                                          np.isnan(t.numpy()))
            ok = ~np.isnan(np.asarray(j))
            np.testing.assert_allclose(np.asarray(j)[ok], t.numpy()[ok],
                                       rtol=1e-6)


def test_pad_n_matches_jax():
    """Three ghost layers on a cyclic, a zeroGradient and a symmetryNegate
    axis (and a fixedValue face): the copies are exact."""
    rng = np.random.default_rng(3)
    f = rng.normal(size=(5, 4, 3))
    bj = ((cyclic(), cyclic()), (zero_gradient(), fixed_value(2.5)),
          (symmetry(negate=True), zero_gradient()))
    bt = ((tmesh.cyclic(), tmesh.cyclic()),
          (tmesh.zero_gradient(), tmesh.fixed_value(2.5)),
          (tmesh.symmetry(negate=True), tmesh.zero_gradient()))
    mj = StructuredMesh.box([1.0, 1.0, 1.0], [5, 4, 3])
    mt = tmesh.StructuredMesh.box([1.0, 1.0, 1.0], [5, 4, 3], device="cpu")
    for ng in (1, 2, 3):
        Pj = np.asarray(pad_n(jnp.asarray(f), bj, mj, ng))
        Pt = t_pad_n(torch.as_tensor(f), bt, mt, ng).numpy()
        assert Pj.shape == Pt.shape == (5 + 2 * ng, 4 + 2 * ng, 3 + 2 * ng)
        np.testing.assert_array_equal(Pj, Pt)


def _reactor_lanes(dtype):
    """Six lanes of the test mechanism: three hot, one cold, two with
    t_end = 0 (frozen from the start)."""
    mj = load_mechanism(MECH)
    ns = mj.n_species
    Y = np.zeros((6, ns))
    for s, y in (("H2", 0.0285), ("O2", 0.2264), ("N2", 0.7451)):
        Y[:, mj.species_index(s)] = y
    T = np.array([1500.0, 1800.0, 2200.0, 400.0, 1600.0, 2000.0])
    p = np.array([1e5, 2e6, 5e5, 1e5, 1e5, 1e5])
    t_end = np.array([2e-6, 5e-6, 1e-6, 3e-6, 0.0, 0.0])
    thj = make_thermo(mj, dtype)
    rho = np.asarray(thj.rho(jnp.asarray(p, dtype), jnp.asarray(T, dtype),
                             jnp.asarray(Y, dtype)))
    y0 = np.concatenate([T[:, None], Y], 1).astype(dtype)
    return mj, y0, rho, t_end.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_rosenbrock_lanes_match_vmap(dtype):
    """The lane-batched integrator against jax.vmap(rosenbrock_integrate),
    per-lane y and controller step, and the trip count: JAX with each lane's
    max_steps set to the port's count finishes the lane (same y), with one
    trip fewer it does not (another step)."""
    mj, y0, rho, t_end = _reactor_lanes(dtype)
    thj, kj = make_thermo(mj, dtype), make_kinetics(mj, dtype)
    mt = tc.load_mechanism(MECH, device="cpu")
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tht, kt = tc.make_thermo(mt, tdt), tc.make_kinetics(mt, tdt)
    rtol, atol = (1e-6, 1e-12) if dtype == np.float64 else (1e-4, 1e-8)

    @jax.jit
    def run_j(y, rho_c, te, max_steps):
        def one(y, r, t, m):
            o = RosenbrockOptions(rtol=rtol, atol=atol, max_steps=m)
            return rosenbrock_integrate(constant_volume_rhs(thj, kj, r), y, t,
                                        o, return_dt=True)
        return jax.vmap(one)(y, rho_c, te, max_steps)

    rhs = constant_volume_rhs_batched(tht, kt, torch.as_tensor(rho))
    yt, dtt, nstep = t_integrate(rhs, torch.as_tensor(y0),
                                 torch.as_tensor(t_end),
                                 TOpts(rtol=rtol, atol=atol), return_dt=True,
                                 return_nstep=True)
    big = jnp.full(6, 10_000)
    yj, dtj = run_j(y0, rho, t_end, big)
    tol = 1e-10 if dtype == np.float64 else 1e-5
    assert yt.dtype == tdt and dtt.dtype == tdt
    assert _rel(yj, yt) <= tol
    # the next step comes from the error estimate k1 - 2 k2 + k3, a
    # cancellation that leaves it with round-off of about 1e-7 of itself in
    # float64; in float32 the last step is the remainder t_end - t, which
    # cancels too, so only float64 compares it
    if dtype == np.float64:
        assert np.abs(np.asarray(dtj) - dtt.numpy()).max() \
            <= 1e-5 * np.abs(np.asarray(dtj)).max()
    n = nstep.numpy()
    assert (n[4:] == 0).all() and (n[:4] > 0).all()
    yj1, dtj1 = run_j(y0, rho, t_end, jnp.asarray(n))
    np.testing.assert_array_equal(np.asarray(yj1), np.asarray(yj))
    yj0, dtj0 = run_j(y0, rho, t_end, jnp.asarray(np.maximum(n - 1, 0)))
    assert (np.asarray(dtj0)[:4] != np.asarray(dtj)[:4]).all()


def _air_pair():
    mj = load_mechanism(AIR)
    return mj, make_thermo(mj), make_kinetics(mj)


def _to_port(s):
    return HighSpeedState(*(torch.as_tensor(np.asarray(x)) for x in s))


def _to_jax(s):
    return JState(*(jnp.asarray(x.numpy()) for x in s))


def _jax_twin(solver_t, mj, thj, kj, bcs_j):
    """The JAX solver of a port solver's mesh and config."""
    m = solver_t.mesh
    c = solver_t.config
    return HighSpeedSolver(
        mesh=StructuredMesh(m.nx, m.ny, m.nz, m.dx, m.dy, m.dz),
        thermo=thj, kinetics=kj, bcs_rho=bcs_j[0], bcs_U=bcs_j[1],
        bcs_p=bcs_j[2], bcs_Y=bcs_j[3], config=HighSpeedConfig(
            flux=c.flux, rk_order=c.rk_order, limiter=c.limiter,
            chemistry=c.chemistry, T_threshold=c.T_threshold,
            ode_opts=RosenbrockOptions(*c.ode_opts)))


def _run_pair(sj, st, solver_j, solver_t, dt, n, tol, fields=FIELDS):
    step = jax.jit(lambda s: solver_j.step(s, dt))
    for _ in range(n):
        sj, dj = step(sj)
        st, dtd = solver_t.step(st, dt)
    for k in fields:
        assert _rel(getattr(sj, k), getattr(st, k)) <= tol, k
    for k in ("T_max", "p_max", "u_max"):
        assert abs(float(dj[k]) - float(dtd[k])) <= tol * abs(float(dj[k])), k
    assert float(st.time) == pytest.approx(float(sj.time), rel=1e-14)
    return sj, st


_BX = ((zero_gradient(), zero_gradient()), (empty(), empty()),
       (empty(), empty()))


@pytest.mark.parametrize("flux,limiter", [
    ("HLLC", "vanLeer"), ("HLLCP", "minmod"), ("AUSMDV", "vanLeer"),
    ("Kurganov", "vanLeer"), ("Tadmor", "none"), ("HLLC", "WENO5")])
def test_sod_matches_jax(flux, limiter):
    """The Sod tube at n = 64, 10 steps, every scheme and reconstruction."""
    solver_t, st, plan = sod_shock_tube(AIR, n=64, flux=flux, limiter=limiter,
                                        device="cpu")
    mj, thj, kj = _air_pair()
    solver_j = _jax_twin(solver_t, mj, thj, kj, (_BX, (_BX,) * 3, _BX, _BX))
    sj = _to_jax(st)
    _run_pair(sj, st, solver_j, solver_t, plan["dt"], 10, 1e-10)


def test_sod_exact_star_state():
    """The port's Sod tube to its end (about 450 steps of n = 400): the
    plateau's pressure and velocity within 3 % of the exact p*, u*, as the
    JAX package's test holds its own."""
    solver, s, plan = sod_shock_tube(AIR, n=400, device="cpu")
    for _ in range(plan["n_steps"]):
        s, _ = solver.step(s, plan["dt"])
    rho, U, p, T, _ = solver.primitives(s)
    X = solver.mesh.cell_centers(torch.float64)[0].squeeze()
    m = (X > plan["window"][0]) & (X < plan["window"][1])
    assert abs(float(p.squeeze()[m].mean()) - plan["p_star"]) < 0.03 * plan["p_star"]
    assert abs(float(U[0].squeeze()[m].mean()) - plan["u_star"]) < 0.03 * plan["u_star"]
    assert float(rho.min()) > 0 and float(p.min()) > 0


def test_periodic_2d_conservation_and_flux_x_match_jax():
    """Smooth periodic 2D flow, HLLC with RK3: the port's step and
    step_with_flux_x against JAX's, and exact conservation of rho, rhoU,
    rhoE and rhoY over 5 steps."""
    mj, thj, kj = _air_pair()
    n = 12
    b = ((cyclic(), cyclic()), (cyclic(), cyclic()), (empty(), empty()))
    bt = ((tmesh.cyclic(), tmesh.cyclic()), (tmesh.cyclic(), tmesh.cyclic()),
          (tmesh.empty(), tmesh.empty()))
    mt = tc.load_mechanism(AIR, device="cpu")
    from deepflame_torch.solvers.high_speed import (
        HighSpeedConfig as TCfg, HighSpeedSolver as TSolver)
    solver_t = TSolver(mesh=tmesh.StructuredMesh.box(
        [1.0, 1.0, 1.0 / n], [n, n, 1], device="cpu"),
        thermo=tc.make_thermo(mt), kinetics=tc.make_kinetics(mt),
        bcs_rho=bt, bcs_U=(bt, bt, bt), bcs_p=bt, bcs_Y=bt,
        config=TCfg(flux="HLLC", rk_order=3, chemistry="none"))
    solver_j = _jax_twin(solver_t, mj, thj, kj, (b, (b, b, b), b, b))
    X, Yg, _ = solver_j.mesh.cell_centers()
    T = 300.0 + 50.0 * jnp.sin(2 * jnp.pi * X) * jnp.cos(2 * jnp.pi * Yg)
    p = jnp.full(solver_j.mesh.shape, 1e5) + 1e3 * jnp.cos(2 * jnp.pi * X)
    U = jnp.stack([50.0 * jnp.sin(2 * jnp.pi * Yg),
                   30.0 * jnp.cos(2 * jnp.pi * X), jnp.zeros_like(X)])
    sj = solver_j.initial_state(p, T, jnp.ones((1,) + X.shape), U)
    st = _to_port(sj)
    dt = 1e-5 / n
    tot0 = [float(x.sum()) for x in (st.rho, st.rhoU[0], st.rhoU[1], st.rhoE)]
    sj2, st2 = _run_pair(sj, st, solver_j, solver_t, dt, 5, 1e-10)
    for a, x in zip(tot0, (st2.rho, st2.rhoU[0], st2.rhoU[1], st2.rhoE)):
        assert abs(float(x.sum()) - a) <= 1e-10 * max(abs(a), 1e-6 * abs(tot0[3]))
    oj = solver_j.step_with_flux_x(sj2, dt)
    ot = solver_t.step_with_flux_x(st2, dt)
    for k in FIELDS:
        assert _rel(getattr(oj[0], k), getattr(ot[0], k)) <= 1e-10, k
    for k in ("rho", "rhoU", "rhoE", "rhoY"):
        assert _rel(oj[2][k], ot[2][k]) <= 1e-10, k
    co_j = float(solver_j.acoustic_courant(sj2, dt))
    assert float(solver_t.acoustic_courant(st2, dt)) == pytest.approx(
        co_j, rel=1e-12)


def test_lts_dt_field_matches_scalar_and_jax():
    """A per-cell dt field equal to the scalar step gives the scalar step's
    state (1e-10) and JAX's field step; the clock advances by its
    minimum."""
    solver_t, st, plan = sod_shock_tube(AIR, n=32, device="cpu")
    mj, thj, kj = _air_pair()
    solver_j = _jax_twin(solver_t, mj, thj, kj, (_BX, (_BX,) * 3, _BX, _BX))
    sj = _to_jax(st)
    dt = plan["dt"]
    field = torch.full(solver_t.mesh.shape, dt, dtype=torch.float64)
    field[3] = 0.5 * dt
    s_scalar, _ = solver_t.step(st, dt)
    s_uniform, _ = solver_t.step(st, torch.full_like(field, dt))
    for k in FIELDS:
        assert _rel(getattr(s_scalar, k).numpy(), getattr(s_uniform, k)) <= 1e-10
    s_f, _ = solver_t.step(st, field)
    sj_f, _ = solver_j.step(sj, jnp.asarray(field.numpy()))
    for k in FIELDS:
        assert _rel(getattr(sj_f, k), getattr(s_f, k)) <= 1e-10, k
    assert float(s_f.time) == pytest.approx(0.5 * dt, rel=1e-14)


def test_detonation_2d_matches_jax():
    """The 2D H2-air detonation channel at 24 x 4 on the test mechanism,
    igniters over the lower half so that cells burn: 2 steps with split ODE
    chemistry, within 1e-8; the active lanes go through the drain."""
    bands = ((0.0, 0.05),)
    solver_t, st = detonation_2d_h2(MECH, nx=24, ny=4, dtype=torch.float64,
                                    device="cpu", igniters=bands)
    mj = load_mechanism(MECH)
    thj, kj = make_thermo(mj), make_kinetics(mj)
    e = (empty(), empty())
    zg = (zero_gradient(), zero_gradient())
    wall = (symmetry(negate=True), symmetry(negate=True))
    bs = (zg, zg, e)
    bU = (((symmetry(negate=True), zero_gradient()), zg, e), (zg, wall, e), bs)
    solver_j = _jax_twin(solver_t, mj, thj, kj, (bs, bU, bs, bs))
    sj = _to_jax(st)
    assert int((st.T > 500.0).sum()) == 4
    dt = detonation_dt(solver_t)
    step = jax.jit(lambda s: solver_j.step(s, dt))
    for _ in range(2):
        sj, _ = step(sj)
        st, diag = solver_t.step(st, dt)
    for k in FIELDS:
        assert _rel(getattr(sj, k), getattr(st, k)) <= 1e-8, k
    assert diag["chem_lanes"] >= 4 and int(diag["chem_trips"]) > 0
    assert float(st.T.max()) > 1500.0


def test_detonation_through_factory_and_run_case():
    """The detonation built by factory.build_high_speed_solver from a
    CaseConfig and run by run_case: the same state as stepping the solver
    by hand."""
    from deepflame_torch.runtime import config as C
    from deepflame_torch.runtime.driver import run_case
    case = C.CaseConfig(chemistry=C.ChemistryProperties(
        mechanism_file=MECH, ode_rtol=1e-4, ode_atol=1e-8),
        dtype="float64")
    solver, s0 = detonation_2d_h2(MECH, nx=16, ny=4, device="cpu", case=case,
                                  igniters=((0.0, 0.05),))
    assert solver.config.ode_opts.max_steps == 20000
    dt = detonation_dt(solver)
    out = run_case(solver, s0, C.ControlDict(end_time=2 * dt, delta_t=dt,
                                             write_interval=1.0))
    s = s0
    for _ in range(2):
        s, _ = solver.step(s, dt)
    for k in FIELDS:
        assert torch.equal(getattr(out, k), getattr(s, k)), k
