"""Three of the examples' density-based and Lagrangian families in the
PyTorch port (cases.detonation_1d, shock_watermist_1d,
single_droplet_motion and their readings) against the same cases built
with the JAX package's functions exactly as examples/detonation_1d.py,
shock_watermist_1d.py and single_droplet_motion.py build them, float64 on
the CPU (the first two on the 9-species test mechanism: the examples load
H2_Li, which the repository lacks).

Tolerances: initial states within 1e-14 of each field's largest value;
after the steps every conservative field, T and every parcel array within
TOL of its largest value; the readings within 1e-12; the whole droplet
runs within 2 % of the reference integration (the example's own assert)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflame_tpu.chemistry import (load_mechanism, make_kinetics,
                                     make_thermo, make_transport)
from deepflame_tpu.chemistry.integrator import RosenbrockOptions
from deepflame_tpu.lagrangian.cloud import ManualInjector, SprayCloud
from deepflame_tpu.lagrangian.liquids import water
from deepflame_tpu.mesh import StructuredMesh, empty, symmetry, zero_gradient
from deepflame_tpu.solvers.high_speed import HighSpeedConfig, HighSpeedSolver
from deepflame_tpu.solvers.spray import HighSpeedSpraySolver

from deepflame_torch import cases
from deepflame_torch.lagrangian import cloud as tcloud
from deepflame_torch.ops import kernels as K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MECH = os.path.join(ROOT, "tests", "data", "h2_air_9sp.json")
FIELDS = ("rho", "rhoU", "rhoE", "rhoY", "T")
PARCELS = ("pos", "vel", "d", "T", "n_part", "active", "m_injected")
TOL = 1e-10


def _rel(a, b):
    """Largest deviation of the port's b from JAX's a over a's largest."""
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _check(sj, st, names, tol):
    devs = {k: _rel(getattr(sj, k), getattr(st, k)) for k in names}
    bad = {k: v for k, v in devs.items() if not v <= tol}
    assert not bad, bad


def _droplet_example():
    """examples/single_droplet_motion.py as a module (its main() is not
    run; it imports numpy at its top and scipy in reference_history)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "single_droplet_motion",
        os.path.join(ROOT, "examples", "single_droplet_motion.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def no_draws(monkeypatch):
    """The port's cloud may draw nothing: its manual injection places every
    parcel, and neither case breaks up, collides or disperses."""
    def draw(*args, **kw):
        raise AssertionError("the cloud drew a random number")
    monkeypatch.setattr(tcloud, "draw", draw)


# ---------------------------------------------------- A19 detonation_1d.py

def _jax_detonation_1d(n, Lx):
    """examples/detonation_1d.py:56-100 in float64 at n cells over Lx."""
    dtype = jnp.float64
    mech = load_mechanism(MECH)
    th, kin = make_thermo(mech, dtype), make_kinetics(mech, dtype)
    mesh = StructuredMesh.box([Lx, Lx / n, Lx / n], [n, 1, 1])
    e = (empty(), empty())
    b_scalar = ((zero_gradient(), zero_gradient()), e, e)
    b_un = ((symmetry(negate=True), zero_gradient()), e, e)
    cfg = HighSpeedConfig(
        flux="HLLC", rk_order=2, limiter="vanLeer", chemistry="ode",
        ode_opts=RosenbrockOptions(rtol=1e-6, atol=1e-12, max_steps=5000),
        T_threshold=500.0)
    solver = HighSpeedSolver(mesh=mesh, thermo=th, kinetics=kin,
                             bcs_rho=b_scalar,
                             bcs_U=(b_un, b_scalar, b_scalar),
                             bcs_p=b_scalar, bcs_Y=b_scalar, config=cfg)
    ns = mech.n_species
    iH2, iO2, iN2 = (mech.species_index(s) for s in ("H2", "O2", "N2"))
    Yv = np.zeros(ns)
    Yv[iH2], Yv[iO2], Yv[iN2] = 0.02851, 0.226, 0.745
    Yv /= Yv.sum()
    X, _, _ = mesh.cell_centers(dtype)
    p0, T0 = 101325.0, 300.0
    drv_len = max(0.002 * Lx, 1.5 * mesh.dx)
    driver = X < drv_len
    T = jnp.where(driver, 2000.0, T0).astype(dtype)
    p = jnp.where(driver, 90.0 * p0, p0).astype(dtype)
    Y = jnp.asarray(np.tile(Yv[:, None, None, None], (1,) + mesh.shape), dtype)
    s = solver.initial_state(p, T, Y)
    return solver, s, 0.3 * mesh.dx / 3500.0, np.asarray(X).squeeze(), iH2


def test_detonation_1d_matches_the_example():
    """detonation_1d at 40 cells over 0.2 m (its driver one cell above
    500 K): dt and the initial state as the example's, 2 steps within TOL;
    the driver cell goes through the stiff drain; detonation_front reads
    the JAX state as the example's lines do."""
    solver_j, sj, dt_j, x, iH2 = _jax_detonation_1d(40, 0.2)
    solver_t, st, dt, info = cases.detonation_1d(MECH, n=40, length=0.2,
                                                 device="cpu")
    assert dt == dt_j and info["n_steps"] == int(2.2e-3 / dt)
    assert info["every"] == max(info["n_steps"] // 60, 1)
    np.testing.assert_array_equal(info["x"], x)
    _check(sj, st, FIELDS, 1e-14)
    assert int((st.T > 500.0).sum()) == 1
    step = jax.jit(lambda s: solver_j.step(s, dt))
    K.reset_launches()
    for _ in range(2):
        sj, dj = step(sj)
        st, d = solver_t.step(st, dt)
        _check(sj, st, FIELDS, TOL)
        assert d["chem_lanes"] >= 1 and int(d["chem_trips"]) > 0
    assert all(v == 0 for v in K.launches.values())
    got = cases.detonation_front(solver_t, st, info["x"], info["h2_index"])
    _, _, p, T, Y = solver_j.primitives(sj)
    p_now = np.asarray(p).squeeze()
    ix = int(np.argmax(p_now))
    behind = x < (x[ix] - 0.02)
    assert got["i_front"] == ix and got["x_front"] == x[ix]
    assert got["p_max"] == pytest.approx(p_now.max(), rel=1e-12)
    assert got["T_max"] == pytest.approx(float(np.asarray(T).max()),
                                         rel=1e-12)
    assert behind.sum() <= 2 and np.isnan(got["Y_H2_behind"])


def test_front_readings_match_the_examples():
    """front_speed and shock_front against the examples' lines: the
    detonation's fit over (0.3 L, 0.95 L), the shock's over (0.1, 1.0) m,
    None below 4 points; the shock at argmin diff p; Y_H2 behind a front
    far from the wall."""
    rng = np.random.default_rng(0)
    t = np.linspace(1e-5, 2.2e-3, 60)
    xf = 0.02 + 1979.0 * t + rng.normal(0, 1e-3, t.size)
    sel = (xf > 1.5) & (xf < 4.75)
    assert cases.front_speed(t, xf, 1.5, 4.75) == pytest.approx(
        np.polyfit(t[sel], xf[sel], 1)[0], rel=1e-12)
    assert cases.front_speed(t[:3], xf[:3], 0.0, 10.0) is None
    x = np.linspace(-0.1, 1.1, 240)
    p = 66000.0 + 43312.5 * 0.5 * (1 - np.tanh((x - 0.4) / 0.01))
    assert cases.shock_front(p, x) == x[int(np.argmin(np.diff(p)))]
    assert cases.shock_front(torch.as_tensor(p[None, :, None]), x) == \
        cases.shock_front(p, x)
    # the fresh state everywhere (the driver cell too), a pressure peak at
    # cell 30 (x = 0.1525 m) of a 0.2 m tube, Y_H2 growing along it: 26
    # cells lie more than 20 mm behind the front
    solver, s, _, info = cases.detonation_1d(MECH, n=40, length=0.2,
                                             device="cpu")
    s = s._replace(**{k: getattr(s, k)[..., -1:, :, :].expand_as(
        getattr(s, k)).clone() for k in ("rho", "rhoU", "rhoE", "rhoY")})
    heat = torch.zeros(40, 1, 1, dtype=torch.float64)
    heat[30] = 2e6                      # J/kg: about 2,700 K hotter
    grow = torch.linspace(0.5, 1.5, 40, dtype=torch.float64).reshape(40, 1, 1)
    iH2 = info["h2_index"]
    rhoY = s.rhoY.clone()
    rhoY[iH2] = rhoY[iH2] * grow
    s = s._replace(rhoE=s.rhoE + s.rho * heat, rhoY=rhoY)
    got = cases.detonation_front(solver, s, info["x"], iH2)
    _, _, p, _, Y = solver.primitives(s)
    ix = int(np.argmax(p.reshape(-1).numpy()))
    behind = info["x"] < info["x"][ix] - 0.02
    assert ix == 30 == got["i_front"] and behind.sum() == 26
    assert got["Y_H2_behind"] == Y[info["h2_index"]].reshape(-1).numpy()[
        behind].max()


# ----------------------------------------------- A20 shock_watermist_1d.py

def _jax_shock(n, dry):
    """examples/shock_watermist_1d.py:57-117 in float64 at n cells."""
    dtype = jnp.float64
    mech = load_mechanism(MECH)
    th, kin = make_thermo(mech, dtype), make_kinetics(mech, dtype)
    tr = make_transport(mech, dtype)
    x_lo, x_hi = -0.1, 1.1
    Lx = x_hi - x_lo
    w = Lx / n
    mesh = StructuredMesh.box([Lx, w, w], [n, 1, 1])
    e = (empty(), empty())
    zg = (zero_gradient(), zero_gradient())
    b_scalar = (zg, e, e)
    cfg = HighSpeedConfig(flux="HLLC", rk_order=2, limiter="vanLeer",
                          chemistry="none")
    gas = HighSpeedSolver(mesh=mesh, thermo=th, kinetics=kin,
                          bcs_rho=b_scalar, bcs_U=(b_scalar,) * 3,
                          bcs_p=b_scalar, bcs_Y=b_scalar, config=cfg)
    n_parcels = 220
    xs_p = 0.1 + 0.0025 + 0.005 * np.arange(n_parcels)
    half = 0.5 * w
    positions = np.stack([xs_p, np.full_like(xs_p, half),
                          np.full_like(xs_p, half)], axis=1)
    inj = ManualInjector(positions=positions, soi=0.0, d0=2.4e-6,
                         n_particle=2.2e5, T_inject=275.0,
                         rho_liquid=997.0)
    cloud = SprayCloud(mesh=mesh, liquid=water(), injector=inj,
                       max_parcels=n_parcels, evaporation="Spalding",
                       breakup="none", wall_interaction=())
    solver = HighSpeedSpraySolver(gas_solver=gas, cloud=cloud, transport=tr,
                                  vapor_index=int(mech.species_index("H2O")))
    ns = mech.n_species
    iO2, iN2 = mech.species_index("O2"), mech.species_index("N2")
    Yv = np.zeros(ns)
    Yv[iO2], Yv[iN2] = 0.23149482, 0.76204518
    Yv /= Yv.sum()
    X, _, _ = mesh.cell_centers(dtype)
    Xphys = X - 0.1
    driver = Xphys < 0.0
    T = jnp.where(driver, 318.0, 275.0).astype(dtype)
    p = jnp.where(driver, 109312.5, 66000.0).astype(dtype)
    Y = jnp.asarray(np.tile(Yv[:, None, None, None], (1,) + mesh.shape),
                    dtype)
    u0 = jnp.asarray(np.where(np.asarray(driver), 125.076, 0.0), dtype)
    U0 = jnp.stack([u0, jnp.zeros_like(u0), jnp.zeros_like(u0)])
    if dry:
        s = gas.initial_state(p, T, Y, U=U0)
        stepper, prims = gas, gas.primitives
    else:
        s = solver.initial_state(p, T, Y, U=U0)
        stepper, prims = solver, (lambda st: gas.primitives(st.gas))
    dt = 0.3 * mesh.dx / 900.0
    return stepper, s, dt, prims, np.asarray(Xphys).squeeze()


@pytest.mark.parametrize("dry", [True, False], ids=["dry", "fog"])
def test_shock_watermist_1d_matches_the_example(dry, no_draws):
    """shock_watermist_1d at 24 cells, dry and through the fog (all 220
    parcels released in the first step), float64: dt and the initial state
    as the example's, 2 steps with the gas fields and every parcel array
    within TOL; shock_front reads the port's pressure as the example's
    line reads JAX's."""
    stepper, sj, dt_j, prims_j, x = _jax_shock(24, dry)
    solver, st, dt, info = cases.shock_watermist_1d(
        MECH, n=24, dry=dry, dtype=torch.float64, device="cpu")
    assert dt == dt_j and info["n_steps"] == int(2e-3 / dt)
    np.testing.assert_allclose(info["x"], x, rtol=0, atol=1e-15)
    gas = lambda s: s if dry else s.gas
    _check(gas(sj), gas(st), FIELDS, 1e-14)
    step = jax.jit(lambda s: stepper.step(s, dt)[0])
    K.reset_launches()
    for _ in range(2):
        sj = step(sj)
        st, _ = solver.step(st, dt)
        _check(gas(sj), gas(st), FIELDS, TOL)
        if not dry:
            _check(sj.cloud, st.cloud, PARCELS, TOL)
    assert all(v == 0 for v in K.launches.values())
    if not dry:
        assert float(st.cloud.active.sum()) == 220.0
        assert float(st.cloud.m_injected) > 0.0
    p_j = np.asarray(prims_j(sj)[2]).squeeze()
    assert cases.shock_front(info["prims"](st)[2], info["x"]) == \
        x[int(np.argmin(np.diff(p_j)))]


def test_shock_watermist_1d_defaults_to_the_examples_float32():
    """The example runs float32 unless asked (--dtype f32); so does the
    builder, with the bare gas solver when dry."""
    solver, st, dt, info = cases.shock_watermist_1d(MECH, n=24, dry=True,
                                                    device="cpu")
    assert st.rho.dtype == torch.float32
    assert solver is info["gas_solver"]
    assert info["every"] == max(info["n_steps"] // 40, 1)


# ------------------------------------------- A21 single_droplet_motion.py

def _jax_droplet(d0, t_end, steps):
    """examples/single_droplet_motion.py:80-106 in float64 for d0, with
    `steps` of its scan and its module's constants: (u_p history, the last
    cloud state, dt, the example's step count)."""
    ex = _droplet_example()
    dtype = jnp.float64
    g = {k: getattr(ex, k) for k in cases.DROPLET_GAS}
    rho_g = g["P_GAS"] / (287.0 * g["T_GAS"])
    mesh = StructuredMesh.box([10.0, 0.01, 0.01], [100, 1, 1])
    gas = {
        "rho": jnp.full(mesh.shape, rho_g, dtype),
        "U": jnp.stack([jnp.full(mesh.shape, g["U_GAS"], dtype),
                        jnp.zeros(mesh.shape, dtype),
                        jnp.zeros(mesh.shape, dtype)]),
        "T": jnp.full(mesh.shape, g["T_GAS"], dtype),
        "p": jnp.full(mesh.shape, g["P_GAS"], dtype),
        "mu": jnp.full(mesh.shape, g["MU_G"], dtype),
    }
    inj = ManualInjector(positions=np.array([[0.05, 0.005, 0.005]]),
                         soi=0.0, d0=d0, n_particle=1.0,
                         T_inject=g["T_GAS"], rho_liquid=g["RHO_L"],
                         U0=(g["U_DROP"], 0.0, 0.0))
    cloud = SprayCloud(mesh=mesh, liquid=water(), injector=inj,
                       max_parcels=1, evaporation="none",
                       drag="sphereDrag", breakup="none",
                       wall_interaction=())
    c = cloud.init(jax.random.PRNGKey(0), dtype)
    tau = g["RHO_L"] * d0 ** 2 / (18.0 * g["MU_G"])
    dt = min(tau / 20.0, t_end / 200.0)

    def body(carry, _):
        c, t = carry
        c2, _src = cloud.evolve(c, gas, dt, t)
        return (c2, t + dt), c2.vel[0, 0]

    (c, _), u_hist = jax.lax.scan(body, (c, jnp.asarray(0.0, dtype)),
                                  None, length=steps)
    return np.asarray(u_hist), c, dt, int(round(t_end / dt))


@pytest.mark.parametrize("d_um,t_end", cases.DROPLET_RUNS)
def test_droplet_steps_match_the_examples_scan(d_um, t_end, no_draws):
    """droplet_relaxation, 10 steps of each of the example's diameters,
    against its lax.scan of cloud.evolve in JAX: u_p after every step and
    the parcel arrays within TOL; dt and the step count as the example's."""
    u_j, c_j, dt_j, n_j = _jax_droplet(d_um * 1e-6, t_end, 10)
    _, _, _, dt, n = cases.single_droplet_motion(d_um * 1e-6, t_end,
                                                 device="cpu")
    assert (dt, n) == (dt_j, n_j) == (dt, 200)
    u_t, c_t = cases.droplet_relaxation(d_um * 1e-6, t_end, device="cpu",
                                        steps=10)
    assert u_t.shape == (10,)
    assert _rel(u_j, u_t) <= TOL
    _check(c_j, c_t, PARCELS, TOL)
    assert np.all(np.diff(u_j) > 0)            # the drag accelerates it


def test_droplet_relaxation_within_two_percent_of_the_reference():
    """The example's check on the port, run whole on the CPU (3 x 200
    steps): u_p(t_end) within 2 % of droplet_reference's RK45 integration
    for every diameter; droplet_reference's integration equals the
    script's reference_history (:37-52) within 1e-12."""
    reference_history = _droplet_example().reference_history
    worst = 0.0
    for d_um, t_end in cases.DROPLET_RUNS:
        u, _ = cases.droplet_relaxation(d_um * 1e-6, t_end, device="cpu")
        ts, ref = cases.droplet_reference(d_um * 1e-6, t_end)
        ts_s, ref_s = reference_history(d_um * 1e-6, t_end)
        np.testing.assert_array_equal(ts, ts_s)
        np.testing.assert_allclose(ref, ref_s, rtol=1e-12)
        worst = max(worst, abs(float(u[-1]) - ref[-1]) / abs(ref[-1]))
    assert worst < 0.02


def test_fog_evaporation_heats_the_gas_like_jax(no_draws):
    """A fault of the JAX package that the port reproduces (ROADMAP section
    C's watch list): in HighSpeedSpraySolver the evaporated vapour joins
    rhoY[H2O] with no energy but the latent-heat sink (deepflame_tpu/
    lagrangian/cloud.py:833-834, solvers/spray.py:138), while the gas
    energy counts H2O's enthalpy of formation; so evaporation heats the
    gas. On the fog of shock_watermist_1d at 24 cells, quiescent air at 340
    K and 1e5 Pa, 10 steps: with Spalding evaporation the mean T rises in
    both packages (and the shock through the fog outruns the dry one);
    without evaporation the droplets' heat-up cools it. The port's mean
    T change within 1e-5 of JAX's (a quiescent gas: the momentum is the
    drag's round-off, so the fields are held to TOL by the 2-step test
    above, not here)."""
    import dataclasses
    for evap, sign in (("Spalding", 1.0), ("none", -1.0)):
        stepper, sj, dt, _, _ = _jax_shock(24, dry=False)
        solver, st, _, _ = cases.shock_watermist_1d(
            MECH, n=24, dtype=torch.float64, device="cpu")
        stepper = dataclasses.replace(stepper, cloud=dataclasses.replace(
            stepper.cloud, evaporation=evap))
        solver = dataclasses.replace(solver, cloud=dataclasses.replace(
            solver.cloud, evaporation=evap))
        Y = (st.gas.rhoY / st.gas.rho).numpy()
        shape = tuple(st.gas.T.shape)
        sj = stepper.initial_state(jnp.full(shape, 1e5), jnp.full(shape, 340.0),
                                   jnp.asarray(Y), U=jnp.zeros((3,) + shape))
        st = solver.initial_state(np.full(shape, 1e5), np.full(shape, 340.0),
                                  Y, U=np.zeros((3,) + shape))
        step = jax.jit(lambda s: stepper.step(s, dt)[0])
        for _ in range(10):
            sj = step(sj)
            st, _ = solver.step(st, dt)
        dT_j = float(jnp.mean(sj.gas.T)) - 340.0
        dT_t = float(st.gas.T.mean()) - 340.0
        assert sign * dT_j > 0.01 and sign * dT_t > 0.01, (evap, dT_j, dT_t)
        assert abs(dT_t - dT_j) <= 1e-5 * abs(dT_j), (evap, dT_j, dT_t)
