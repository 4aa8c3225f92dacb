"""PyTorch port of the RAS models and wall functions against the JAX package
(float64, CPU, seeded numpy inputs).

Tolerances: wall_distance and the wall-function masks exactly; each wall
function within 1e-12 of the largest value; one `advance` of each model
within 1e-10 (two Krylov solves that stop at 1e-8, whose dot products XLA
and PyTorch sum in different orders); two low-Mach steps with a RAS model
within 1e-8 (velocity and face fluxes RTOL_FLOW, as in
test_torch_low_mach.py, for the pressure solve's round-off).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflame_tpu.chemistry import (load_mechanism, make_kinetics,
                                     make_thermo, make_transport)
from deepflame_tpu.combustion import NoCombustion
from deepflame_tpu.mesh import (StructuredMesh, cyclic, empty, fixed_value,
                                zero_gradient)
from deepflame_tpu.solvers.low_mach import LowMachConfig, LowMachSolver
from deepflame_tpu.turbulence import (KEpsilon, KOmegaSST, WallFunctions,
                                      wall_distance)

import deepflame_torch.chemistry as tc
import deepflame_torch.combustion as tcomb
import deepflame_torch.mesh as tmesh
import deepflame_torch.solvers as tsol
import deepflame_torch.turbulence as tturb
from test_torch_low_mach import FIELDS, RTOL_FLOW, _rel, _to_port

DATA = os.path.join(os.path.dirname(__file__), "data")
AIR = os.path.join(DATA, "air.yaml")
# the channel of tests/test_wall_functions.py
CH_LEN, CH_CELLS = [0.1, 0.02, 0.02], [4, 16, 1]


def _bcs(pkg, kinds):
    """FieldBCs of one package from ((lo, hi), ...) kind names."""
    make = {"cyclic": pkg.cyclic, "empty": pkg.empty,
            "zg": pkg.zero_gradient, "wall": lambda: pkg.fixed_value(0.0)}
    return tuple(tuple(make[k]() for k in pair) for pair in kinds)


class _J:
    cyclic, empty, zero_gradient, fixed_value = (cyclic, empty, zero_gradient,
                                                 fixed_value)


CH_U = (("cyclic", "cyclic"), ("wall", "zg"), ("empty", "empty"))
CH_S = (("cyclic", "cyclic"), ("zg", "zg"), ("empty", "empty"))


def _meshes(lengths, cells, origin=(0.0, 0.0, 0.0)):
    return (StructuredMesh.box(lengths, cells, origin=origin),
            tmesh.StructuredMesh.box(lengths, cells, origin=origin,
                                     device="cpu"))


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _close(a, b, tol):
    assert _rel(a, b) <= tol, _rel(a, b)


@pytest.mark.parametrize("walls", [[], [(1, 0)], [(0, 0), (1, 1), (2, 1)]])
def test_wall_distance_is_exact(walls):
    mj, mt = _meshes([0.03, 0.02, 0.01], [6, 5, 4], origin=(-0.01, 0.0, 0.002))
    np.testing.assert_array_equal(np.asarray(wall_distance(mj, walls)),
                                  tturb.wall_distance(mt, walls).numpy())


@pytest.mark.parametrize("walls", [[(1, 0)], [(1, 0), (1, 1), (0, 0)]])
def test_wall_functions_match_jax(walls):
    """Masks exactly; yplus_lam, y*, nut, epsilon, omega, production and
    apply_mask within 1e-12 on seeded fields spanning the sublayer and the
    log layer."""
    mj, mt = _meshes(CH_LEN, CH_CELLS)
    wj = WallFunctions.for_walls(mj, walls, dtype=jnp.float64)
    wt = tturb.WallFunctions.for_walls(mt, walls, dtype=torch.float64)
    for f in ("mask", "y", "axis_field"):
        np.testing.assert_array_equal(np.asarray(getattr(wj, f)),
                                      getattr(wt, f).numpy())
    assert wt.yplus_lam == wj.yplus_lam
    rng = np.random.default_rng(3)
    sh = mj.shape
    rho = rng.uniform(0.5, 2.0, sh)
    k = 10.0 ** rng.uniform(-6, 1, sh)
    mu = rng.uniform(1e-5, 3e-5, sh)
    U = rng.normal(0.0, 10.0, (3,) + sh)
    mu_t = rng.uniform(0.0, 1e-3, sh)
    J = lambda x: jnp.asarray(x)
    pairs = [
        (wj.ystar(J(rho), J(k), J(mu)), wt.ystar(_t(rho), _t(k), _t(mu))),
        (wj.nut(J(rho), J(k), J(mu)), wt.nut(_t(rho), _t(k), _t(mu))),
        (wj.epsilon(J(k)), wt.epsilon(_t(k))),
        (wj.omega(J(rho), J(k), J(mu)), wt.omega(_t(rho), _t(k), _t(mu))),
        (wj.omega(J(rho), J(k), J(mu), 0.0828),
         wt.omega(_t(rho), _t(k), _t(mu), 0.0828)),
        (wj.production(J(rho), J(k), J(mu), J(mu_t), J(U), None, mj),
         wt.production(_t(rho), _t(k), _t(mu), _t(mu_t), _t(U), None, mt)),
        (wj.apply_mask(J(k), J(mu)), wt.apply_mask(_t(k), _t(mu)))]
    for a, b in pairs:
        _close(a, b, 1e-12)
    # the sublayer switch is exercised: some wall cells on, some off
    nut = wt.nut(_t(rho), _t(k), _t(mu)).numpy()
    on = wt.mask.numpy() > 0
    assert (nut[on] > 0).any() and (nut[on] == 0).any()


def _model_pair(name, wall_fns):
    """(JAX model, port model) on the channel, with or without the y = 0
    wall's wall functions."""
    mj, mt = _meshes(CH_LEN, CH_CELLS)
    wj = WallFunctions.for_walls(mj, [(1, 0)], dtype=jnp.float64) \
        if wall_fns else None
    wt = tturb.WallFunctions.for_walls(mt, [(1, 0)], dtype=torch.float64) \
        if wall_fns else None
    if name == "kEpsilon":
        return KEpsilon(wall_fns=wj), tturb.KEpsilon(wall_fns=wt)
    if name == "RNGkEpsilon":
        return KEpsilon.rng(wall_fns=wj), tturb.KEpsilon.rng(wall_fns=wt)
    return (KOmegaSST(y=wall_distance(mj, [(1, 0)]), wall_fns=wj),
            tturb.KOmegaSST(y=tturb.wall_distance(mt, [(1, 0)]),
                            wall_fns=wt))


@pytest.mark.parametrize("wall_fns", [False, True])
@pytest.mark.parametrize("name", ["kEpsilon", "RNGkEpsilon", "kOmegaSST"])
def test_advance_matches_jax(name, wall_fns):
    """One advance of (k, eps or omega) on the channel from seeded fields:
    k, the second field and mu_t within 1e-10."""
    mj, mt = _meshes(CH_LEN, CH_CELLS)
    jm, tm = _model_pair(name, wall_fns)
    assert tm.kind == jm.kind
    rng = np.random.default_rng(11)
    sh = mj.shape
    k = rng.uniform(0.05, 0.2, sh)
    e = rng.uniform(0.5, 5.0, sh) * (200.0 if name == "kOmegaSST" else 1.0)
    rho = rng.uniform(1.1, 1.3, sh)
    rho_old = rho * rng.uniform(0.99, 1.01, sh)
    _, Yc, _ = (c.numpy() for c in mt.cell_centers())
    U = np.stack([15.0 * np.sqrt(Yc / 0.02), np.zeros(sh), np.zeros(sh)])
    U = U + rng.normal(0.0, 0.5, (3,) + sh)
    mu = rng.uniform(1.7e-5, 1.9e-5, sh)
    phi = tuple(rng.normal(0.0, 1.0, s) for s in
                ((sh[0] + 1,) + sh[1:], (sh[0], sh[1] + 1, sh[2]),
                 sh[:2] + (sh[2] + 1,)))
    dt = 2e-5
    bUj, bSj = _bcs(_J, CH_U), _bcs(_J, CH_S)
    bUt, bSt = _bcs(tmesh, CH_U), _bcs(tmesh, CH_S)
    J = jnp.asarray
    out_j = jax.jit(lambda *a: jm.advance(*a[:4], a[4:7], a[7], a[8],
                                          (bUj,) * 3, bSj, mj, dt))(
        J(k), J(e), J(rho), J(rho_old), *(J(p) for p in phi), J(U), J(mu))
    out_t = tm.advance(_t(k), _t(e), _t(rho), _t(rho_old),
                       tuple(_t(p) for p in phi), _t(U), _t(mu),
                       (bUt,) * 3, bSt, mt, dt)
    for a, b in zip(out_j, out_t):
        _close(a, b, 1e-10)
    assert float((out_t[0] - _t(k)).abs().max()) > 1e-6


def _air_solvers(model_j, model_t, n, L):
    mech = load_mechanism(AIR)
    th, tr, kin = make_thermo(mech), make_transport(mech), make_kinetics(mech)
    kinds = (("cyclic", "cyclic"), ("cyclic", "cyclic"), ("empty", "empty"))
    b = _bcs(_J, kinds)
    mesh = StructuredMesh.box([L, L, L / n], [n, n, 1])
    sj = LowMachSolver(
        mesh=mesh, thermo=th, transport=tr, combustion=NoCombustion(th, kin),
        bcs_U=(b, b, b), bcs_p=b, bcs_h=b, bcs_Y=b, bcs_rho=b,
        config=LowMachConfig(chemistry=False), turbulence=model_j)
    mt_ = tc.load_mechanism(AIR, device="cpu")
    th_t = tc.make_thermo(mt_)
    bt = _bcs(tmesh, kinds)
    st = tsol.LowMachSolver(
        mesh=tmesh.StructuredMesh.box([L, L, L / n], [n, n, 1], device="cpu"),
        thermo=th_t, transport=tc.make_transport(mt_),
        combustion=tcomb.NoCombustion(th_t, tc.make_kinetics(mt_)),
        bcs_U=(bt, bt, bt), bcs_p=bt, bcs_h=bt, bcs_Y=bt, bcs_rho=bt,
        config=tsol.LowMachConfig(chemistry=False), turbulence=model_t)
    return sj, st


@pytest.mark.parametrize("name", ["kEpsilon", "kOmegaSST"])
def test_low_mach_ras_steps_match_jax(name):
    """Two low-Mach steps of the sheared box of tests/test_ras.py (air.yaml,
    24 x 24 x 1 cyclic, k0 = 0.05, eps0 = 0.5) with the RAS model: every
    field, k and its partner within 1e-8 (U, phi RTOL_FLOW), k_max too, the
    Krylov counts equal (the pressure's within one), the face fluxes within
    RTOL_FLOW of the largest face flux; the port's initial
    state equals JAX's."""
    n, L = 24, 0.1
    models = ((KEpsilon(), tturb.KEpsilon()) if name == "kEpsilon"
              else (KOmegaSST(), tturb.KOmegaSST()))
    sj, st = _air_solvers(*models, n, L)
    X, Yg, _ = sj.mesh.cell_centers()
    U = jnp.stack([10.0 * jnp.sin(2 * jnp.pi * Yg / L),
                   jnp.zeros(sj.mesh.shape), jnp.zeros(sj.mesh.shape)])
    args = (jnp.full(sj.mesh.shape, 101325.0), jnp.full(sj.mesh.shape, 300.0),
            jnp.ones((1,) + sj.mesh.shape), U)
    s_j = sj.initial_state(*args, k0=0.05, eps0=0.5)
    s0 = st.initial_state(*(np.asarray(a) for a in args), k0=0.05, eps0=0.5)
    for a, b in zip(s_j.turb, s0.turb):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    s_t = _to_port(s_j)
    dt = 5e-5
    step = jax.jit(lambda s: sj.step(s, dt))
    for _ in range(2):
        s_j, d_j = step(s_j)
        s_t, d_t = st.step(s_t, dt)
        for key in ("iters_U", "iters_h"):
            assert int(d_j[key]) == int(d_t[key]), key
        # the pressure CG stops at a relative tolerance: round-off moves
        # its count by one (iters_p_slack in test_torch_low_mach.py)
        assert abs(int(d_j["iters_p"]) - int(d_t["iters_p"])) <= 1
        for key in FIELDS:
            _close(getattr(s_j, key), getattr(s_t, key),
                   RTOL_FLOW if key == "U" else 1e-8)
        # the face fluxes over the largest of any axis: in the pure shear
        # the y and z fluxes are round-off (1e-6 against 12 kg/m^2/s)
        phi_max = max(float(np.abs(np.asarray(f)).max()) for f in s_j.phi)
        for ax in range(3):
            dev = np.abs(np.asarray(s_j.phi[ax]) - s_t.phi[ax].numpy()).max()
            assert dev <= RTOL_FLOW * phi_max, ("phi", ax, dev)
        for a, b in zip(s_j.turb, s_t.turb):
            _close(a, b, 1e-8)
        assert abs(float(d_j["k_max"]) - float(d_t["k_max"])) \
            <= 1e-8 * float(d_j["k_max"])
    assert float(s_t.turb[0].sum()) > 0.05 * n * n    # shear produced k


def test_run_case_kepsilon_matches_jax():
    """A kEpsilon case from a CaseConfig (RAS, the air mechanism, chemistry
    off, float64) through each package's factory and run_case: 2 steps of
    5e-5 s on the sheared box; fields, k and eps within 1e-8 (U, phi
    RTOL_FLOW of the largest face flux)."""
    from deepflame_tpu.runtime import config as jconfig
    from deepflame_tpu.runtime import driver as jdriver
    from deepflame_tpu.runtime import factory as jfactory
    from deepflame_torch.runtime import config as tconfig
    from deepflame_torch.runtime import driver as tdriver
    from deepflame_torch.runtime import factory as tfactory

    def case(C):
        return C.CaseConfig(
            chemistry=C.ChemistryProperties(mechanism_file=AIR,
                                            chemistry=False),
            turbulence=C.TurbulenceProperties(simulation_type="RAS",
                                              ras_model="kEpsilon"),
            control=C.ControlDict(end_time=1e-4, delta_t=5e-5,
                                  write_interval=1.0),
            dtype="float64")
    n, L = 16, 0.1
    kinds = (("cyclic", "cyclic"), ("cyclic", "cyclic"), ("empty", "empty"))
    bj, bt = _bcs(_J, kinds), _bcs(tmesh, kinds)
    mesh_j, mesh_t = _meshes([L, L, L / n], [n, n, 1])
    sj, _ = jfactory.build_low_mach_solver(case(jconfig), mesh_j, (bj,) * 3,
                                           bj, bj, bj, bj)
    st, _ = tfactory.build_low_mach_solver(case(tconfig), mesh_t, (bt,) * 3,
                                           bt, bt, bt, bt)
    assert st.is_ras and type(st.turbulence).__name__ == "KEpsilon"
    _, Yg, _ = mesh_j.cell_centers()
    U = jnp.stack([8.0 * jnp.sin(2 * jnp.pi * Yg / L),
                   jnp.zeros(mesh_j.shape), jnp.zeros(mesh_j.shape)])
    s_j = sj.initial_state(jnp.full(mesh_j.shape, 101325.0),
                           jnp.full(mesh_j.shape, 300.0),
                           jnp.ones((1,) + mesh_j.shape), U, k0=0.05,
                           eps0=0.5)
    s_t = tdriver.run_case(st, _to_port(s_j), case(tconfig).control)
    s_j = jdriver.run_case(sj, s_j, case(jconfig).control)
    assert abs(float(s_t.time) - 1e-4) < 1e-12
    for key in FIELDS:
        _close(getattr(s_j, key), getattr(s_t, key),
               RTOL_FLOW if key == "U" else 1e-8)
    phi_max = max(float(np.abs(np.asarray(f)).max()) for f in s_j.phi)
    for ax in range(3):
        assert np.abs(np.asarray(s_j.phi[ax]) - s_t.phi[ax].numpy()).max() \
            <= RTOL_FLOW * phi_max
    for a, b in zip(s_j.turb, s_t.turb):
        _close(a, b, 1e-8)
    assert float((s_t.turb[0] - 0.05).abs().max()) > 1e-6
