"""PyTorch port of the spray coupling against the JAX package (float64, CPU):
the low-Mach and FGM steps with non-zero spray sources, SpraySolver on the
low-Mach and on the FGM gas phase, and HighSpeedSpraySolver.

The clouds draw JAX's numbers, replayed into the port's `draw` as in
test_torch_lagrangian.py. Tolerances: every field within 1e-8 of its largest
value, velocity and face fluxes within RTOL_FLOW (the pressure solve's
round-off, as in test_torch_low_mach.py), the cloud state within 1e-8.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflame_tpu.chemistry import (load_mechanism, make_kinetics,
                                     make_thermo, make_transport)
from deepflame_tpu.chemistry.integrator import RosenbrockOptions
from deepflame_tpu.combustion import Laminar, NoCombustion
from deepflame_tpu.combustion.fgm.table import make_synthetic_table
from deepflame_tpu.lagrangian import cloud as jcloud
from deepflame_tpu.lagrangian import liquids as jliq
from deepflame_tpu.mesh import (StructuredMesh, empty, fixed_value,
                                symmetry, zero_gradient)
from deepflame_tpu.solvers.fgm import FGMConfig as JFGMConfig
from deepflame_tpu.solvers.fgm import FGMSolver as JFGMSolver
from deepflame_tpu.solvers.high_speed import (HighSpeedConfig as JHSConfig,
                                              HighSpeedSolver as JHSSolver)
from deepflame_tpu.solvers.low_mach import LowMachConfig, LowMachSolver
from deepflame_tpu.solvers.spray import (HighSpeedSpraySolver as JHSSpray,
                                         SpraySolver as JSpray)
from deepflame_tpu.turbulence import KEpsilon

import deepflame_torch.chemistry as tc
import deepflame_torch.combustion as tcomb
import deepflame_torch.mesh as tmesh
import deepflame_torch.solvers as tsol
from deepflame_torch.cases import (AACHEN_DT, AACHEN_FLOW_PROFILE,
                                   aachen_bomb_3d, watermist_detonation_1d)
from deepflame_torch.lagrangian import cloud as tcloud
from deepflame_torch.lagrangian import liquids as tliq
from test_torch_fgm import _port_table
from test_torch_lagrangian import Replay, _jax_draws
from test_torch_lagrangian import _rel as _rel_any
from test_torch_low_mach import FIELDS, RTOL_FLOW, _rel, _to_port

HERE = os.path.dirname(__file__)
DATA = os.path.join(HERE, "data")
MECH = os.path.join(DATA, "h2_air_9sp.json")
AIR = os.path.join(DATA, "air.yaml")
CLOUD = ("pos", "vel", "d", "T", "n_part", "active", "m_injected")


def _chem(path):
    mj = load_mechanism(path)
    thj = make_thermo(mj)
    mt = tc.load_mechanism(path, device="cpu")
    tht = tc.make_thermo(mt)
    return (mj, thj, make_transport(mj), NoCombustion(thj, make_kinetics(mj)),
            mt, tht, tc.make_transport(mt),
            tcomb.NoCombustion(tht, tc.make_kinetics(mt)))


def _zg(pkg):
    return ((pkg.zero_gradient(), pkg.zero_gradient()),) * 3


class _J:
    zero_gradient, fixed_value, empty, symmetry = (zero_gradient,
                                                   fixed_value, empty,
                                                   symmetry)


def _box(lengths, cells, origin=(0.0, 0.0, 0.0)):
    return (StructuredMesh.box(lengths, cells, origin=origin),
            tmesh.StructuredMesh.box(lengths, cells, origin=origin,
                                     device="cpu"))


def _check_gas(gj, gt, fields, label):
    for k in fields:
        tol = RTOL_FLOW if k == "U" else 1e-8
        assert _rel(getattr(gj, k), getattr(gt, k)) <= tol, (label, k)
    if hasattr(gj, "phi"):
        phi_max = max(float(np.abs(np.asarray(f)).max()) for f in gj.phi)
        for ax in range(3):
            dev = np.abs(np.asarray(gj.phi[ax]) - gt.phi[ax].numpy()).max()
            assert dev <= RTOL_FLOW * phi_max, (label, "phi", ax)


def _check_cloud(cj, ct, label):
    for k in CLOUD:
        assert _rel_any(getattr(cj, k), getattr(ct, k)) <= 1e-8, (label, k)


def _sources(shape, seed, ns_index):
    """Seeded non-zero spray sources of both packages."""
    rng = np.random.default_rng(seed)
    src = dict(Srho=rng.normal(0.0, 5.0, shape),
               SU=rng.normal(0.0, 500.0, (3,) + shape),
               Sh=rng.normal(0.0, 5e6, shape),
               SY=rng.uniform(0.0, 5.0, shape))
    sj = {k: jnp.asarray(v) for k, v in src.items()}
    st = {k: torch.as_tensor(v) for k, v in src.items()}
    sj["SY_index"] = st["SY_index"] = ns_index
    return sj, st


def test_low_mach_step_with_sources_matches_jax():
    """Two low-Mach steps of a closed 8 x 6 x 1 box of the 9-species gas
    with seeded random Srho, SU, Sh and SY (into H2O): every field within
    1e-8 (U, phi RTOL_FLOW) and the Krylov counts as in the no-source
    tests; the sources move the state."""
    mj, thj, trj, cj_, mt, tht, trt, ct_ = _chem(MECH)
    L, shape = [0.01, 0.008, 0.001], (8, 6, 1)
    mesh_j, mesh_t = _box(L, shape)
    bj, bt = _zg(_J), _zg(tmesh)
    bUj = ((fixed_value(0.0), fixed_value(0.0)),) * 2 + (
        (zero_gradient(), zero_gradient()),)
    bUt = ((tmesh.fixed_value(0.0), tmesh.fixed_value(0.0)),) * 2 + (
        (tmesh.zero_gradient(), tmesh.zero_gradient()),)
    sol_j = LowMachSolver(mesh=mesh_j, thermo=thj, transport=trj,
                          combustion=cj_, bcs_U=(bUj,) * 3, bcs_p=bj,
                          bcs_h=bj, bcs_Y=bj, bcs_rho=bj,
                          config=LowMachConfig(chemistry=False))
    sol_t = tsol.LowMachSolver(mesh=mesh_t, thermo=tht, transport=trt,
                               combustion=ct_, bcs_U=(bUt,) * 3, bcs_p=bt,
                               bcs_h=bt, bcs_Y=bt, bcs_rho=bt,
                               config=tsol.LowMachConfig(chemistry=False))
    rng = np.random.default_rng(4)
    Y = np.zeros((mj.n_species,) + shape)
    Y[mj.species_index("O2")] = 0.23
    Y[mj.species_index("N2")] = 0.77
    Y[mj.species_index("H2O")] = rng.uniform(0.0, 0.01, shape)
    Y = Y / Y.sum(0)
    p, T = np.full(shape, 2e6), 900.0 + rng.uniform(-50.0, 50.0, shape)
    U = rng.normal(0.0, 1.0, (3,) + shape)
    s_j = sol_j.initial_state(jnp.asarray(p), jnp.asarray(T), jnp.asarray(Y),
                              jnp.asarray(U))
    s_t = _to_port(s_j)
    src_j, src_t = _sources(shape, 5, mj.species_index("H2O"))
    dt = 1e-5
    step = jax.jit(lambda s, src: sol_j.step(s, dt, sources=src))
    plain = sol_t.step(s_t, dt)[0]
    for i in range(2):
        s_j, d_j = step(s_j, src_j)
        s_t, d_t = sol_t.step(s_t, dt, sources=src_t)
        for k in ("iters_U", "iters_h"):
            assert int(d_j[k]) == int(d_t[k]), k
        assert abs(int(d_j["iters_p"]) - int(d_t["iters_p"])) <= 1
        _check_gas(s_j, s_t, FIELDS, f"step {i}")
        if i == 0:
            assert _rel(s_j.rho, plain.rho) > 1e-6
            assert _rel(s_j.ha, plain.ha) > 1e-6


def _fgm_pair(mesh_j, mesh_t, cfg, thermo):
    """The JAX and port FGM solvers on the synthetic table, zero-gradient
    boxes (thermo: the air tables of each package, which the FGM step does
    not read)."""
    thj, trj, cj_, tht, trt, ct_ = thermo
    tb = make_synthetic_table(dtype=jnp.float64)
    bj, bt = _zg(_J), _zg(tmesh)
    sol_j = JFGMSolver(mesh=mesh_j, thermo=thj, transport=trj,
                       combustion=cj_, bcs_U=(bj,) * 3, bcs_p=bj, bcs_h=bj,
                       bcs_Y=bj, bcs_rho=bj, config=JFGMConfig(**cfg),
                       table=tb, bcs_Z=bj)
    sol_t = tsol.FGMSolver(mesh=mesh_t, thermo=tht, transport=trt,
                           combustion=ct_, bcs_U=(bt,) * 3, bcs_p=bt,
                           bcs_h=bt, bcs_Y=bt, bcs_rho=bt,
                           config=tsol.FGMConfig(**cfg),
                           table=_port_table(tb), bcs_Z=bt)
    return sol_j, sol_t


FGM_FIELDS = ("rho", "U", "p", "Z", "Zvar", "c", "cvar", "Zcvar", "T", "He")


def _fgm_state_t(s):
    d = {k: torch.as_tensor(np.asarray(getattr(s, k)))
         for k in s._fields if k != "phi"}
    return tsol.FGMState(phi=tuple(torch.as_tensor(np.asarray(f))
                                   for f in s.phi), **d)


def test_fgm_step_with_sources_matches_jax():
    """Two FGM steps on the synthetic table (6 x 8 x 4, the c, cvar, Zcvar
    and enthalpy equations all on) with seeded random Srho, SU and Sh:
    every field within 1e-8 (U, phi RTOL_FLOW); Srho moves Z."""
    _, thj, trj, cj_, _, tht, trt, ct_ = _chem(AIR)
    shape = (6, 8, 4)
    mesh_j, mesh_t = _box([0.006, 0.008, 0.004], shape)
    cfg = dict(chemistry=False, solve_zcvar=True, solve_enthalpy=True)
    sol_j, sol_t = _fgm_pair(mesh_j, mesh_t, cfg,
                             (thj, trj, cj_, tht, trt, ct_))
    rng = np.random.default_rng(6)
    s_j = sol_j.fgm_initial_state(jnp.full(shape, 1e5),
                                  jnp.asarray(rng.uniform(0.0, 0.5, shape)),
                                  jnp.asarray(rng.uniform(0.0, 1.0, shape)),
                                  jnp.asarray(rng.normal(0.0, 0.5,
                                                         (3,) + shape)))
    s_t = _fgm_state_t(s_j)
    src_j, src_t = _sources(shape, 7, None)
    for d in (src_j, src_t):
        d.pop("SY_index")
        d.pop("SY")
    dt = 2e-6
    step = jax.jit(lambda s, src: sol_j.step(s, dt, sources=src))
    plain = sol_t.step(s_t, dt)[0]
    for i in range(2):
        s_j, _ = step(s_j, src_j)
        s_t, _ = sol_t.step(s_t, dt, sources=src_t)
        _check_gas(s_j, s_t, FGM_FIELDS, f"step {i}")
        if i == 0:
            assert _rel(s_j.Z, plain.Z) > 1e-6


def _replayed(monkeypatch):
    replay = Replay()
    monkeypatch.setattr(tcloud, "draw", replay)
    return replay


def test_spray_solver_water_matches_jax(monkeypatch):
    """SpraySolver on the 9-species gas with water (test_spray.py's coupled
    case, water in place of n-heptane, fuel_index H2O): a 6 x 12 x 1
    chamber at 2 MPa and 900 K, 3 steps of 1e-5 s; gas fields 1e-8 (U, phi
    RTOL_FLOW), the cloud 1e-8; vapour reaches the gas."""
    mj, thj, trj, cj_, mt, tht, trt, ct_ = _chem(MECH)
    mesh_j, mesh_t = _box([0.02, 0.05, 0.02 / 6], [6, 12, 1],
                          origin=(-0.01, -0.05, 0.0))
    bj, bt = _zg(_J), _zg(tmesh)
    gas_j = LowMachSolver(mesh=mesh_j, thermo=thj, transport=trj,
                          combustion=cj_, bcs_U=(bj,) * 3, bcs_p=bj,
                          bcs_h=bj, bcs_Y=bj, bcs_rho=bj,
                          config=LowMachConfig(chemistry=False))
    gas_t = tsol.LowMachSolver(mesh=mesh_t, thermo=tht, transport=trt,
                               combustion=ct_, bcs_U=(bt,) * 3, bcs_p=bt,
                               bcs_h=bt, bcs_Y=bt, bcs_rho=bt,
                               config=tsol.LowMachConfig(chemistry=False))
    inj = dict(position=(0.0, -0.002, 0.00166), direction=(0, -1, 0),
               u_mag=30.0, mdot=5e-4, t_end=1e-3, d_mean=4e-5,
               parcels_per_step=8)
    iH2O = mj.species_index("H2O")
    sol_j = JSpray(gas_solver=gas_j, cloud=jcloud.SprayCloud(
        mesh=mesh_j, liquid=jliq.water(),
        injector=jcloud.ConeInjector(**inj), max_parcels=512),
        fuel_index=iH2O)
    sol_t = tsol.SpraySolver(gas_solver=gas_t, cloud=tcloud.SprayCloud(
        mesh=mesh_t, liquid=tliq.water(),
        injector=tcloud.ConeInjector(**inj), max_parcels=512),
        fuel_index=iH2O)
    Y = np.zeros((mj.n_species,) + mesh_j.shape)
    Y[mj.species_index("O2")] = 0.23
    Y[mj.species_index("N2")] = 0.77
    s_j = sol_j.initial_state(jnp.full(mesh_j.shape, 2e6),
                              jnp.full(mesh_j.shape, 900.0), jnp.asarray(Y))
    s_t = tsol.SprayState(gas=_to_port(s_j.gas), cloud=sol_t.cloud.init(
        torch.Generator().manual_seed(0), torch.float64))
    replay = _replayed(monkeypatch)
    dt = 1e-5
    step = jax.jit(lambda s: sol_j.step(s, dt))
    for i in range(3):
        replay.queue, _ = _jax_draws(sol_j.cloud, s_j.cloud.key,
                                     jnp.float64, {})
        s_j, d_j = step(s_j)
        s_t, d_t = sol_t.step(s_t, dt)
        assert not replay.queue
        _check_gas(s_j.gas, s_t.gas, FIELDS, f"step {i}")
        _check_cloud(s_j.cloud, s_t.cloud, f"step {i}")
        assert float(d_j["cloud_n_active"]) == float(d_t["cloud_n_active"])
    assert float(s_t.gas.Y[iH2O].max()) > 1e-8
    assert float(s_t.gas.T.min()) < 900.0


def test_spray_solver_fgm_matches_jax(monkeypatch):
    """initial_state_fgm and two steps of the spray on the FGM gas phase
    (test_spray.py's FGM coupling: synthetic table, n-heptane, 6 x 12 x 6,
    gas T set to 900 K): gas fields 1e-8 (U, phi RTOL_FLOW), the cloud
    1e-8; the vapour feeds Z."""
    _, thj, trj, cj_, _, tht, trt, ct_ = _chem(AIR)
    mesh_j, mesh_t = _box([0.02, 0.04, 0.02], [6, 12, 6],
                          origin=(-0.01, -0.04, -0.01))
    gas_j, gas_t = _fgm_pair(mesh_j, mesh_t,
                             dict(chemistry=False, combustion_on=False),
                             (thj, trj, cj_, tht, trt, ct_))
    inj = dict(position=(0.0, -0.001, 0.0), direction=(0, -1, 0),
               u_mag=20.0, mdot=5e-4, t_start=0.0, t_end=1e-3, d_mean=2e-5,
               parcels_per_step=8)
    kw = dict(max_parcels=512, evaporation="Spalding")
    sol_j = JSpray(gas_solver=gas_j, cloud=jcloud.SprayCloud(
        mesh=mesh_j, liquid=jliq.n_heptane(),
        injector=jcloud.ConeInjector(**inj), **kw), fuel_index=0)
    sol_t = tsol.SpraySolver(gas_solver=gas_t, cloud=tcloud.SprayCloud(
        mesh=mesh_t, liquid=tliq.n_heptane(),
        injector=tcloud.ConeInjector(**inj), **kw), fuel_index=0)
    sh = mesh_j.shape
    s_j = sol_j.initial_state_fgm(jnp.full(sh, 5e5), jnp.zeros(sh),
                                  jnp.zeros(sh))
    s_t = sol_t.initial_state_fgm(np.full(sh, 5e5), np.zeros(sh),
                                  np.zeros(sh))
    for k in FGM_FIELDS:
        assert _rel(getattr(s_j.gas, k), getattr(s_t.gas, k)) <= 1e-14, k
    s_j = s_j._replace(gas=s_j.gas._replace(T=jnp.full(sh, 900.0)))
    s_t = s_t._replace(gas=s_t.gas._replace(
        T=torch.full(sh, 900.0, dtype=torch.float64)))
    replay = _replayed(monkeypatch)
    dt = 5e-6
    step = jax.jit(lambda s: sol_j.step(s, dt))
    for i in range(2):
        replay.queue, _ = _jax_draws(sol_j.cloud, s_j.cloud.key,
                                     jnp.float64, {})
        s_j, _ = step(s_j)
        s_t, _ = sol_t.step(s_t, dt)
        _check_gas(s_j.gas, s_t.gas, FGM_FIELDS, f"step {i}")
        _check_cloud(s_j.cloud, s_t.cloud, f"step {i}")
    assert float(s_t.gas.Z.max()) > 1e-10


HS_FIELDS = ("rho", "rhoU", "rhoE", "rhoY", "T")


def test_high_speed_spray_solver_matches_jax(monkeypatch):
    """HighSpeedSpraySolver on a 64-cell tube (cases.watermist_detonation_1d
    at n = 64 with 400 parcels released in the first step; its JAX twin
    built as examples/detonation_1d_watermist.py builds it), chemistry off
    (the split chemistry is held to JAX by test_torch_high_speed.py), 3
    steps: the conservative state within 1e-8, the cloud 1e-8; the mist
    takes mass from nothing and slows the gas."""
    solver_t, s_t = watermist_detonation_1d(MECH, n=64, n_parcels=400,
                                            soi=1e-9, dtype=torch.float64,
                                            device="cpu")
    solver_t = dataclasses.replace(solver_t, gas_solver=dataclasses.replace(
        solver_t.gas_solver, config=dataclasses.replace(
            solver_t.gas_solver.config, chemistry="none")))
    mj, thj, trj, _, _, _, _, _ = _chem(MECH)
    n, Lx = 64, 1.4
    mesh_j = StructuredMesh.box([Lx, Lx / n, Lx / n], [n, 1, 1])
    e = (empty(), empty())
    b_s = ((zero_gradient(), zero_gradient()), e, e)
    b_un = ((symmetry(negate=True), zero_gradient()), e, e)
    gas_j = JHSSolver(mesh=mesh_j, thermo=thj, kinetics=make_kinetics(mj),
                      bcs_rho=b_s, bcs_U=(b_un, b_s, b_s), bcs_p=b_s,
                      bcs_Y=b_s, config=JHSConfig(
                          flux="HLLC", rk_order=2, limiter="vanLeer",
                          chemistry="none", T_threshold=500.0))
    inj_t = solver_t.cloud.injector
    inj_j = jcloud.ManualInjector(
        positions=np.asarray(inj_t.positions), soi=inj_t.soi, d0=inj_t.d0,
        n_particle=inj_t.n_particle, T_inject=inj_t.T_inject,
        rho_liquid=inj_t.rho_liquid)
    cloud_j = jcloud.SprayCloud(mesh=mesh_j, liquid=jliq.water(),
                                injector=inj_j, max_parcels=400,
                                evaporation="Spalding", breakup="none",
                                wall_interaction=())
    sol_j = JHSSpray(gas_solver=gas_j, cloud=cloud_j, transport=trj,
                     vapor_index=mj.species_index("H2O"))
    g = s_t.gas
    s_j = sol_j.initial_state(*(jnp.asarray(x.numpy()) for x in (
        solver_t.gas_solver.primitives(g)[2], g.T,
        g.rhoY / g.rho)))
    for k in HS_FIELDS:
        assert _rel(getattr(s_j.gas, k), getattr(g, k)) <= 1e-12, k
    replay = _replayed(monkeypatch)
    dt = 0.3 * mesh_j.dx / 3500.0
    step = jax.jit(lambda s: sol_j.step(s, dt))
    for i in range(3):
        replay.queue, _ = _jax_draws(cloud_j, s_j.cloud.key, jnp.float64, {})
        s_j, d_j = step(s_j)
        s_t, d_t = solver_t.step(s_t, dt)
        for k in HS_FIELDS:
            assert _rel(getattr(s_j.gas, k), getattr(s_t.gas, k)) <= 1e-8, \
                (i, k)
        _check_cloud(s_j.cloud, s_t.cloud, f"step {i}")
    assert float(d_t["cloud_n_active"]) == 400.0
    assert float(s_t.cloud.m_injected) > 0.0


def _example_flow_profile():
    """FLOW_PROFILE of examples/aachen_bomb_2d.py (the case's
    flowRateProfile), loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "aachen_bomb_2d", os.path.join(HERE, "..", "examples",
                                       "aachen_bomb_2d.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FLOW_PROFILE


def _jax_aachen(n_xz, n_y, dtype):
    """JAX's twin of cases.aachen_bomb_3d: examples/aachen_bomb_3d.py's
    chamber with water in the 9-species air, at n_xz x n_y x n_xz."""
    mech = load_mechanism(MECH)
    th, tr = make_thermo(mech, dtype), make_transport(mech, dtype)
    mesh = StructuredMesh.box([0.02, 0.1, 0.02], [n_xz, n_y, n_xz],
                              origin=(-0.01, 0.0, -0.01))
    b_s = ((zero_gradient(), zero_gradient()),) * 3
    b_u = ((fixed_value(0.0), fixed_value(0.0)),) * 3
    comb = Laminar(th, make_kinetics(mech, dtype), ode_opts=RosenbrockOptions(
        rtol=1e-4, atol=1e-8, max_steps=20000, grow=10.0))
    gas = LowMachSolver(
        mesh=mesh, thermo=th, transport=tr, combustion=comb,
        bcs_U=(b_u,) * 3, bcs_p=b_s, bcs_h=b_s, bcs_Y=b_s, bcs_rho=b_s,
        config=LowMachConfig(chemistry=True,
                             inert_index=int(mech.species_index("N2"))),
        turbulence=KEpsilon())
    liq = jliq.water()
    inj = jcloud.ConeInjector(
        position=(0.0, 0.0995, 0.0), direction=(0.0, -1.0, 0.0),
        cone_angle_deg=20.0, t_start=0.0, t_end=1.25e-3, T_inject=320.0,
        mdot_profile=_example_flow_profile(), mass_total=6e-6,
        size_dist="RosinRammler", rr_d=1.5e-4, rr_n=3.0, rr_min=1e-6,
        rr_max=1.5e-4, u_from_flow=True, Cd=0.9, d_outer=1.9e-4,
        rho_liquid=float(liq.rho(320.0)), parcels_per_step=50)
    rebound = tuple((ax, side, "rebound") for ax in (0, 1, 2)
                    for side in (0, 1))
    cloud = jcloud.SprayCloud(mesh=mesh, liquid=liq, injector=inj,
                              max_parcels=32768, evaporation="Spalding",
                              breakup="ReitzDiwakar",
                              wall_interaction=rebound)
    solver = JSpray(gas_solver=gas, cloud=cloud,
                    fuel_index=mech.species_index("H2O"))
    Y = np.zeros((mech.n_species,) + mesh.shape)
    Y[mech.species_index("O2")] = 0.23
    Y[mech.species_index("N2")] = 0.77
    P = jnp.full(mesh.shape, 5e6, dtype)
    T = jnp.full(mesh.shape, 800.0, dtype)
    s = solver.initial_state(P, T, jnp.asarray(Y, dtype))
    return solver, s._replace(gas=gas.initial_state(
        P, T, jnp.asarray(Y, dtype), k0=1.0, eps0=90.0))


def test_aachen_float32_species_solve_hits_its_cap_in_both(monkeypatch):
    """cases.aachen_bomb_3d at 11 x 20 x 11 in float32, one step against
    its JAX twin run with 64-bit types off, JAX's draws replayed: the same
    species and momentum Krylov counts. Both species solves stop at the
    step's 100-iteration cap (max_iter_u), so the cap that the card run of
    the 41 x 100 x 41 chamber shows is JAX's too, not the port's. The
    port's flow-rate table is the example's."""
    assert AACHEN_FLOW_PROFILE == tuple(_example_flow_profile())
    replay = _replayed(monkeypatch)
    solver_t, s_t = aachen_bomb_3d(MECH, n_xz=11, n_y=20,
                                   dtype=torch.float32, device="cpu")
    with jax.enable_x64(False):
        solver_j, s_j = _jax_aachen(11, 20, jnp.float32)
        replay.queue, _ = _jax_draws(solver_j.cloud, s_j.cloud.key,
                                     jnp.float32, {})
        s_j, d_j = jax.jit(lambda s: solver_j.step(s, AACHEN_DT))(s_j)
        assert s_j.gas.T.dtype == jnp.float32
    s_t, d_t = solver_t.step(s_t, AACHEN_DT)
    assert not replay.queue
    counts = {k: (int(d_j[k]), int(d_t[k])) for k in ("iters_U", "iters_Y")}
    print("float32 Krylov counts (JAX, port):", counts)
    for k, (a, b) in counts.items():
        assert a == b, (k, a, b)
    assert counts["iters_Y"][0] == solver_j.gas_solver.config.max_iter_u
    assert bool(torch.isfinite(s_t.gas.T).all())
    assert float(d_t["cloud_n_active"]) == float(d_j["cloud_n_active"]) > 0


def test_aachen_bomb_sprays_water_only():
    """The chamber's liquid is water: the reference's n-heptane needs
    C7_oneStep, which the repository lacks."""
    with pytest.raises(ValueError, match="C7_oneStep"):
        aachen_bomb_3d(MECH, n_xz=3, n_y=4, liquid="n_heptane",
                       device="cpu")
