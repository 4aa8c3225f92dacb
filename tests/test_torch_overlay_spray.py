"""The port's overlay spray (lagrangian/overlay.py) and SprayFLSolver
(solvers/spray.py) against the JAX package, float64 on the CPU.

make_overlay's overlay box and cell map equal JAX's exactly (both run the
same numpy and scipy cKDTree on the host): on a graded box and on a 2D slab
(a flat axis given a thickness). An overlay with the mesh's own resolution
and bounds is the mesh: the cloud and its reduced sources match the direct
structured SprayCloud (1e-12 and 1e-10, as the JAX package's test). The
overlay->mesh reduction keeps the source integrals whatever the overlay's
resolution (1e-9). A SprayFLSolver step (the face-list gas with water into
the 9-species test mechanism, the cloud on an identity overlay) against
JAX's jitted one, JAX's draws replayed into the port: gas fields 1e-8
(velocity and fluxes 1e-6), parcels 1e-8.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflame_tpu.chemistry as jc
import deepflame_tpu.mesh as jmesh
from deepflame_tpu.combustion import NoCombustion as JNoComb
from deepflame_tpu.lagrangian import cloud as jcloud
from deepflame_tpu.lagrangian.liquids import water as j_water
from deepflame_tpu.lagrangian.overlay import (OverlaySprayCloud as JOverlay,
                                              make_overlay as j_make_overlay)
from deepflame_tpu.mesh.facelist import from_structured as j_from_structured
from deepflame_tpu.solvers.low_mach import LowMachConfig as JConfig
from deepflame_tpu.solvers.low_mach_fl import LowMachSolverFL as JGas
from deepflame_tpu.solvers.spray import SprayFLSolver as JSprayFL

import deepflame_torch.chemistry as tc
import deepflame_torch.mesh as tmesh
from deepflame_torch.combustion import NoCombustion
from deepflame_torch.convert import spray_fl_state_from_numpy
from deepflame_torch.lagrangian import cloud as tcloud
from deepflame_torch.lagrangian.liquids import water
from deepflame_torch.lagrangian.overlay import OverlaySprayCloud, make_overlay
from deepflame_torch.mesh.facelist import from_structured
from deepflame_torch.solvers import LowMachConfig, LowMachSolverFL
from deepflame_torch.solvers.spray import SprayFLSolver
from test_torch_lagrangian import Replay, _jax_draws, _rel
from test_torch_low_mach import RTOL_FLOW

DATA = os.path.join(os.path.dirname(__file__), "data")
MECH = os.path.join(DATA, "h2_air_9sp.json")
SHAPE = (6, 12, 4)
ORIGIN = (-0.01, -0.05, -0.01)
EXT = (0.02, 0.05, 0.02)
INJ = dict(position=(0.0, -0.002, 0.0), direction=(0, -1, 0), u_mag=30.0,
           mdot=5e-4, t_end=1e-3, d_mean=4e-5, parcels_per_step=8)
BOUNDS = (np.asarray(ORIGIN), np.asarray(ORIGIN) + np.asarray(EXT))


def _mesh():
    return tmesh.StructuredMesh.box(EXT, SHAPE, origin=ORIGIN, device="cpu")


def _centers_volumes(mesh):
    ctr = np.stack([c.numpy().ravel() for c in mesh.cell_centers()], axis=1)
    return ctr, np.full(ctr.shape[0], mesh.volume)


def _cloud_kw(liquid):
    return dict(liquid=liquid, injector=tcloud.ConeInjector(**INJ),
                max_parcels=512, evaporation="Spalding")


@pytest.mark.parametrize("case", ["graded", "slab"])
def test_make_overlay_equals_jax(case):
    rng = np.random.default_rng(2)
    if case == "graded":
        xe = np.cumsum(rng.uniform(0.5, 1.5, 9)) * 1e-3
        ye = np.cumsum(rng.uniform(0.5, 1.5, 7)) * 1e-3
        ze = np.array([0.0, 1e-3, 2.5e-3])
        C = np.meshgrid(0.5 * (xe[1:] + xe[:-1]), 0.5 * (ye[1:] + ye[:-1]),
                        0.5 * (ze[1:] + ze[:-1]), indexing="ij")
        res = (12, 9, 3)
    else:
        C = np.meshgrid((np.arange(10) + 0.5) * 1e-3,
                        (np.arange(6) + 0.5) * 2e-3, [0.05e-3],
                        indexing="ij")
        res = (16, 8, 1)
    ctr = np.stack([c.ravel() for c in C], axis=1)
    vol = rng.uniform(1.0, 2.0, ctr.shape[0]) * 1e-9
    oj, mj = j_make_overlay(ctr, vol, res)
    ot, mt = make_overlay(ctr, vol, res, device="cpu")
    np.testing.assert_array_equal(mj, mt)
    for k in ("nx", "ny", "nz", "dx", "dy", "dz", "x0", "y0", "z0"):
        assert getattr(oj, k) == getattr(ot, k), k


def _gas(mesh, T_split=True):
    X, Y, _ = (c.numpy() for c in mesh.cell_centers())
    sh = mesh.shape
    T = 700.0 + 200.0 * (Y > -0.02) if T_split else np.full(sh, 900.0)
    return dict(rho=np.full(sh, 6.0), U=np.zeros((3,) + sh), T=T,
                mu=np.full(sh, 2.5e-5), p=np.full(sh, 2e6),
                Yv=np.zeros(sh))


def _flat(g):
    return {k: torch.as_tensor(v.reshape(3, -1) if k == "U"
                               else v.reshape(-1)) for k, v in g.items()}


def test_identity_overlay_matches_direct():
    mesh = _mesh()
    kw = _cloud_kw(water())
    direct = tcloud.SprayCloud(mesh=mesh, **kw)
    ctr, vol = _centers_volumes(mesh)
    over = OverlaySprayCloud.build(ctr, vol, kw, resolution=SHAPE,
                                   bounds=BOUNDS, device="cpu")
    np.testing.assert_array_equal(over.cell_map.numpy().ravel(),
                                  np.arange(ctr.shape[0]))
    g = _gas(mesh)
    g_t = {k: torch.as_tensor(v) for k, v in g.items()}
    g_fl = _flat(g)
    c_d = direct.init(torch.Generator().manual_seed(7))
    c_o = over.init(torch.Generator().manual_seed(7))
    dt = 1e-5
    for i in range(6):
        t = torch.as_tensor(i * dt, dtype=torch.float64)
        c_d, s_d = direct.evolve(c_d, g_t, dt, t)
        c_o, s_o = over.evolve(c_o, g_fl, dt, t)
    assert int(c_o.active.sum()) > 0
    for k in ("d", "pos"):
        assert _rel(getattr(c_d, k).numpy(), getattr(c_o, k)) <= 1e-12, k
    for k in ("Srho", "Sh", "SY"):
        assert _rel(getattr(s_d, k).reshape(-1).numpy(),
                    getattr(s_o, k)) <= 1e-10, k
    assert _rel(s_d.SU.reshape(3, -1).numpy(), s_o.SU) <= 1e-10


def test_source_integrals_resolution_independent():
    mesh = _mesh()
    kw = _cloud_kw(water())
    ctr, vol = _centers_volumes(mesh)
    g_fl = _flat(_gas(mesh, T_split=False))
    totals = []
    for res in (SHAPE, tuple(2 * s for s in SHAPE)):
        over = OverlaySprayCloud.build(ctr, vol, kw, resolution=res,
                                       bounds=BOUNDS, device="cpu")
        c = over.init(torch.Generator().manual_seed(3))
        tm = te = 0.0
        for i in range(6):
            c, src = over.evolve(c, g_fl, 1e-5, torch.as_tensor(
                i * 1e-5, dtype=torch.float64))
            tm += float((src.Srho * over.volumes).sum())
            te += float((src.Sh * over.volumes).sum())
        totals.append((tm, te))
    (m0, e0), (m1, e1) = totals
    assert m0 > 0.0 and e0 < 0.0
    assert abs(m1 - m0) <= 1e-9 * abs(m0) and abs(e1 - e0) <= 1e-9 * abs(e0)


def test_spray_fl_step_matches_jax(monkeypatch):
    """SprayFLSolver: water into the 9-species gas at 2 MPa and 900 K on a
    6 x 12 x 4 zeroGradient box, the cloud on the identity overlay, 3 steps
    of 1e-5 s; the port replays JAX's draws."""
    mesh_t = _mesh()
    mesh_j = jmesh.StructuredMesh.box(EXT, SHAPE, origin=ORIGIN)
    zj, zt = jmesh.zero_gradient(), tmesh.zero_gradient()
    bj, bt = ((zj, zj),) * 3, ((zt, zt),) * 3
    mj = jc.load_mechanism(MECH)
    mt = tc.load_mechanism(MECH, device="cpu")
    thj, trj, kj = jc.make_thermo(mj), jc.make_transport(mj), \
        jc.make_kinetics(mj)
    tht, trt, kt = tc.make_thermo(mt), tc.make_transport(mt), \
        tc.make_kinetics(mt)
    fj = lambda: j_from_structured(mesh_j, bj)
    ft = lambda: from_structured(mesh_t, bt, device="cpu")
    gas_j = JGas(m_p=fj(), m_h=fj(), m_Y=fj(), m_rho=fj(),
                 m_U=(fj(), fj(), fj()), thermo=thj, transport=trj,
                 combustion=JNoComb(thj, kj),
                 config=JConfig(chemistry=False, use_pallas="never"))
    gas_t = LowMachSolverFL(m_p=ft(), m_h=ft(), m_Y=ft(), m_rho=ft(),
                            m_U=(ft(), ft(), ft()), thermo=tht,
                            transport=trt, combustion=NoCombustion(tht, kt),
                            config=LowMachConfig(chemistry=False))
    ctr, vol = _centers_volumes(mesh_t)
    kw_j = dict(liquid=j_water(), injector=jcloud.ConeInjector(**INJ),
                max_parcels=512, evaporation="Spalding")
    over_j = JOverlay.build(ctr, vol, kw_j, resolution=SHAPE, bounds=BOUNDS)
    over_t = OverlaySprayCloud.build(ctr, vol, _cloud_kw(water()),
                                     resolution=SHAPE, bounds=BOUNDS,
                                     device="cpu")
    iH2O = mj.species_index("H2O")
    sol_j = JSprayFL(gas_solver=gas_j, cloud=over_j, fuel_index=iH2O)
    sol_t = SprayFLSolver(gas_solver=gas_t, cloud=over_t, fuel_index=iH2O)
    n = mesh_j.n_cells
    Y = np.zeros((n, mj.n_species))
    Y[:, mj.species_index("O2")] = 0.23
    Y[:, mj.species_index("N2")] = 0.77
    s_j = sol_j.initial_state(jnp.full(n, 2e6), jnp.full(n, 900.0),
                              jnp.asarray(Y), key=jax.random.PRNGKey(11))
    g = s_j.gas
    d = {k: np.asarray(getattr(g, k)) for k in
         ("rho", "U", "p", "ha", "Y", "T", "dpdt", "time", "phi")}
    d["phi_b"] = [np.asarray(x) for x in g.phi_b]
    s_t = spray_fl_state_from_numpy(d, over_t.init(
        torch.Generator().manual_seed(0)), device="cpu")
    replay = Replay()
    monkeypatch.setattr(tcloud, "draw", replay)
    step = jax.jit(lambda s: sol_j.step(s, 1e-5))
    for i in range(3):
        replay.queue, _ = _jax_draws(over_j.cloud, s_j.cloud.key,
                                     jnp.float64, {})
        s_j, d_j = step(s_j)
        s_t, d_t = sol_t.step(s_t, 1e-5)
        assert not replay.queue
        for k in ("p", "T", "rho", "ha", "Y"):
            assert _rel(getattr(s_j.gas, k), getattr(s_t.gas, k)) <= 1e-8, k
        assert _rel(s_j.gas.U, s_t.gas.U) <= RTOL_FLOW
        for k in ("pos", "vel", "d", "T"):
            assert _rel(getattr(s_j.cloud, k), getattr(s_t.cloud, k)) <= 1e-8
        assert float(d_j["cloud_n_active"]) == float(d_t["cloud_n_active"])
    assert float(s_t.gas.Y[:, iH2O].max()) > 0.0
