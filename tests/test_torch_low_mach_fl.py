"""The port's face-list low-Mach step (solvers/low_mach_fl.py) against the
JAX package's, float64 on the CPU, on blockMesh and general meshes.

Both packages start from one state (the JAX state carried over with
deepflame_torch.convert.fl_state_from_numpy) and take the same steps.
Tolerances as in tests/test_torch_low_mach.py: each field's largest
deviation over its largest magnitude <= 1e-8, velocity and face fluxes
(interior and per patch) <= 1e-6 (a pressure deviation reaches them through
rAU grad(dp)); Krylov counts equal, the pressure count within a stated slack.

Cases: the 3D LES jet flame (`jet_flame_3d_les_fl`, Laminar stiff chemistry,
Sigma, four species BC groups, the pressure matvec through the ELL SpMV) at
n = 8, two steps; an inert graded blockMesh duct, three steps; a sheared
(non-orthogonal, skewed) mesh with species groups and one non-orthogonal
corrector. Plus a repair of the port that the face-list step needs:
CombustionModel.correct's `turb` argument (the other, LowMachConfig's
solve_energy, is a case of tests/test_torch_low_mach_options.py).
"""
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflame_tpu.chemistry as jc
import deepflame_tpu.mesh as jmesh
from deepflame_tpu.combustion import Laminar as JLaminar
from deepflame_tpu.combustion import NoCombustion as JNoCombustion
from deepflame_tpu.mesh import blockmesh as jbm
from deepflame_tpu.mesh import geometry as jgeo
from deepflame_tpu.solvers.low_mach import LowMachConfig as JConfig
from deepflame_tpu.solvers.low_mach_fl import LowMachSolverFL as JSolverFL
from deepflame_tpu.solvers.low_mach_fl import make_step_fl
from deepflame_tpu.turbulence import sigma_model as j_sigma

import deepflame_torch.chemistry as tc
import deepflame_torch.combustion as tcomb
import deepflame_torch.mesh as tmesh
from deepflame_torch.cases import (jet_blockmesh_dict, jet_flame_3d_les_fl,
                                   jet_initial_fields, jet_inlet_profiles)
from deepflame_torch.convert import fl_state_from_numpy
from deepflame_torch.mesh import blockmesh as tbm
from deepflame_torch.mesh import geometry as tgeo
from deepflame_torch.ops import kernels as K
from deepflame_torch.solvers import LowMachConfig, LowMachSolverFL
from test_torch_facelist_mesh import sheared_box_raw
from test_torch_low_mach import RTOL_FLOW, _rel, check_chem_dt

DATA = os.path.join(os.path.dirname(__file__), "data")
MECH = os.path.join(DATA, "h2_air_9sp.json")
AIR = os.path.join(DATA, "air.yaml")
FIELDS = ("p", "T", "U", "Y", "rho", "ha")
JET_DT = 5e-7


def to_port(s):
    d = {k: np.asarray(getattr(s, k)) for k in
         ("rho", "U", "p", "ha", "Y", "T", "dpdt", "time", "phi")}
    d["phi_b"] = tuple(np.asarray(f) for f in s.phi_b)
    d["chem_dt"] = s.chem_dt if isinstance(s.chem_dt, tuple) \
        else np.asarray(s.chem_dt)
    return fl_state_from_numpy(d, device="cpu")


def assert_states_close(sj, st, dt, chem_dt_rtol=None):
    for k in FIELDS:
        tol = RTOL_FLOW if k == "U" else 1e-8
        assert _rel(getattr(sj, k), getattr(st, k)) <= tol, k
    ddp = np.abs(np.asarray(sj.dpdt) - st.dpdt.numpy()).max()
    assert ddp * dt <= 1e-10 * np.abs(np.asarray(sj.p)).max()
    # boundary fluxes against the largest flux of the step
    scale = np.abs(np.asarray(sj.phi)).max()
    assert _rel(sj.phi, st.phi) <= RTOL_FLOW
    for a, b in zip(sj.phi_b, st.phi_b):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= RTOL_FLOW * scale
    if not isinstance(sj.chem_dt, tuple):
        check_chem_dt(sj.chem_dt, st.chem_dt, chem_dt_rtol)


def run_both_fl(solver_j, state_j, solver_t, dt, n_steps, iters_p_slack=0,
                chem_dt_rtol=None):
    """Step both packages from the JAX state, asserting parity after each
    step (chem_dt as test_torch_low_mach.check_chem_dt); returns the final
    states."""
    state_t = to_port(state_j)
    step = make_step_fl(solver_j)
    for _ in range(n_steps):
        state_j, dj = step(state_j, dt)
        state_t, dt_ = solver_t.step(state_t, dt)
        for k in ("iters_U", "iters_Y", "iters_h", "iters_p"):
            assert (k in dj) == (k in dt_), k
            if k in dj:
                slack = iters_p_slack if k == "iters_p" else 0
                assert abs(int(dj[k]) - int(dt_[k])) <= slack, \
                    (k, dj[k], dt_[k])
        assert_states_close(state_j, state_t, dt, chem_dt_rtol)
    assert torch.isfinite(state_t.T).all()
    return state_j, state_t


# ----------------------------------------------------------- the jet flame

def jax_jet(n, dtype=jnp.float64):
    """The JAX package's face-list solver on the same jet case as
    deepflame_torch.cases.jet_flame_3d_les_fl (same blockMeshDict, inlet
    profiles and initial fields)."""
    mech = jc.load_mechanism(MECH)
    th, tr, kin = (jc.make_thermo(mech, dtype), jc.make_transport(mech, dtype),
                   jc.make_kinetics(mech, dtype))
    ns = mech.n_species
    si = mech.species_index
    iH2, iO2, iN2 = si("H2"), si("O2"), si("N2")
    gm = jbm.build_blockmesh(jbm.parse_blockmesh_dict(jet_blockmesh_dict(n)))
    inlet = gm.patches[gm.patch_names.index("inlet")]
    prof = jet_inlet_profiles(inlet.f_ctr[:, 1:], ns, si)
    T_in, Y_in = jnp.asarray(prof["T"], dtype), jnp.asarray(prof["Y"], dtype)
    h_in = th.h_mass(T_in, Y_in)
    rho_in = th.rho(jnp.asarray(101325.0, dtype), T_in, Y_in)
    zg = jmesh.zero_gradient()
    walls = {k: zg for k in ("outlet", "ylo", "yhi", "zlo", "zhi")}
    mk = lambda bc, **kw: gm.with_bcs({**walls, "inlet": bc, **kw}, dtype)
    fv = jmesh.fixed_value
    groups = [(iH2,), (iO2,), (iN2,),
              tuple(i for i in range(ns) if i not in (iH2, iO2, iN2))]
    m_Y_groups = tuple((mk(fv(prof["Y"][:, g[0]])), g) for g in groups)
    m_p = mk(zg, outlet=fv(101325.0))
    comb = JLaminar(th, kin, ode_opts=jc.integrator.RosenbrockOptions(
        rtol=1e-4, atol=1e-8, max_steps=2000, grow=10.0),
        n_bins=128 if n >= 48 else 32)
    solver = JSolverFL(
        m_p=m_p, m_h=mk(fv(h_in)), m_Y=m_Y_groups[-1][0],
        m_rho=mk(fv(rho_in)), m_U=(mk(fv(prof["u"])), mk(fv(0.0)),
                                   mk(fv(0.0))),
        thermo=th, transport=tr, combustion=comb,
        config=JConfig(chemistry=True, inert_index=iN2),
        m_Y_groups=m_Y_groups, p_ell=m_p.ell_connectivity(), les=j_sigma())
    init = jet_initial_fields(gm.centers, ns, si)
    state = solver.initial_state(*(jnp.asarray(init[k], dtype)
                                   for k in ("p", "T", "Y", "U")))
    return solver, state


@pytest.fixture(scope="module")
def jet_pair():
    solver_j, state_j = jax_jet(8)
    solver_t, state_t = jet_flame_3d_les_fl(MECH, n=8, dtype=torch.float64,
                                            device="cpu")
    return solver_j, state_j, solver_t, state_t


def test_jet_initial_state_equals_jax(jet_pair):
    _, sj, _, st = jet_pair
    for k in FIELDS:
        assert _rel(getattr(sj, k), getattr(st, k)) <= 1e-14, k
    assert _rel(sj.phi, st.phi) <= 1e-14
    for a, b in zip(sj.phi_b, st.phi_b):
        assert _rel(a, b) <= 1e-14
    assert _rel(sj.chem_dt, st.chem_dt) == 0.0


def test_jet_two_steps_match_jax(jet_pair):
    """Two 0.5 us steps of the 16 x 8 x 8 jet: the pilot kernel ignites,
    the species groups, the Sigma model and the ELL pressure matvec (its
    plain version on the CPU) all take part."""
    solver_j, state_j, solver_t, _ = jet_pair
    K.reset_launches()
    _, st = run_both_fl(solver_j, state_j, solver_t, JET_DT, 2)
    assert all(v == 0 for v in K.launches.values())
    assert float(st.T.max()) > 1800.0
    assert float((st.Y.sum(1) - 1.0).abs().max()) < 1e-12
    # inlet and outlet mass fluxes have opposite signs
    m = solver_t.mesh
    flux = {p.name: float((fb * p.mag_sf).sum())
            for p, fb in zip(m.patches, st.phi_b)}
    assert flux["inlet"] < 0.0 < flux["outlet"]


def test_jet_is_the_structured_jet():
    """The port's face-list jet at n = 4 holds `_build_3d_jet`'s case: the
    blockMesh cells run in the structured C order and the inlet faces in
    the inlet plane's, so the initial fields, the inlet BC values (velocity,
    temperature through h, density, every species) and the mesh volumes
    equal the structured JAX case's (built on the test mechanism)."""
    from __graft_entry__ import _build_3d_jet
    orig = jc.load_mechanism
    jc.load_mechanism = lambda path, *a, **k: orig(MECH)
    try:
        sj, s0 = _build_3d_jet(n=4, dtype=jnp.float64)
    finally:
        jc.load_mechanism = orig
    solver_t, st = jet_flame_3d_les_fl(MECH, n=4, dtype=torch.float64,
                                       device="cpu")
    flat = lambda a: np.asarray(a).reshape(np.asarray(a).shape[0], -1)
    np.testing.assert_allclose(st.T.numpy(), np.asarray(s0.T).ravel(),
                               rtol=1e-14)
    np.testing.assert_allclose(st.U.numpy(), flat(s0.U).T, rtol=1e-13,
                               atol=1e-13)
    np.testing.assert_allclose(st.Y.numpy(), flat(s0.Y).T, rtol=1e-13,
                               atol=1e-15)
    np.testing.assert_allclose(st.rho.numpy(), np.asarray(s0.rho).ravel(),
                               rtol=1e-13)
    np.testing.assert_allclose(solver_t.mesh.volumes.numpy(),
                               sj.mesh.volume, rtol=1e-12)
    inlet = [i for i, p in enumerate(solver_t.mesh.patches)
             if p.name == "inlet"][0]
    ghost_b = lambda m: m.patches[inlet].b.numpy() / 2.0   # fixedValue b
    np.testing.assert_allclose(ghost_b(solver_t.m_U[0]),
                               np.asarray(sj.bcs_U[0][0][0].value).ravel())
    np.testing.assert_allclose(ghost_b(solver_t.m_h),
                               np.asarray(sj.bcs_h[0][0].value).ravel(),
                               rtol=1e-13)
    np.testing.assert_allclose(ghost_b(solver_t.m_rho),
                               np.asarray(sj.bcs_rho[0][0].value).ravel(),
                               rtol=1e-13)
    for m_g, idx in solver_t.m_Y_groups:
        for i in idx:
            np.testing.assert_allclose(ghost_b(m_g),
                                       np.asarray(sj.bcs_Y[i][0][0].value)
                                       .ravel(), atol=1e-15)
    assert solver_t.combustion.n_bins == sj.combustion.n_bins


# ------------------------------------------------------ inert general meshes

def _air(dtype=jnp.float64):
    mech = jc.load_mechanism(AIR)
    return (jc.make_thermo(mech, dtype), jc.make_transport(mech, dtype),
            jc.make_kinetics(mech, dtype))


def _air_t():
    mech = tc.load_mechanism(AIR, device="cpu")
    return tc.make_thermo(mech), tc.make_transport(mech), tc.make_kinetics(mech)


DUCT_DICT = """
vertices
(
    (0 0 0) (0.1 0 0) (0.1 0.025 0) (0 0.025 0)
    (0 0 0.01) (0.1 0 0.01) (0.1 0.025 0.01) (0 0.025 0.01)
);
blocks
(
    hex (0 1 2 3 4 5 6 7) (24 2 1) simpleGrading (6 1 1)
);
boundary
(
    inlet  { type patch; faces ((0 4 7 3)); }
    outlet { type patch; faces ((1 2 6 5)); }
    ylo    { type wall;  faces ((0 1 5 4)); }
    yhi    { type wall;  faces ((3 7 6 2)); }
    zlo    { type empty; faces ((0 3 2 1)); }
    zhi    { type empty; faces ((4 5 6 7)); }
);
"""


def _solvers(gj, gt, spec, cfg, Y_groups=None, mech=AIR):
    """(JAX, port) LowMachSolverFL on one GeneralMesh pair. spec(pkg, field)
    gives the BC dict of a field ("U0", "U1", "U2", "p", "h", "rho", or a
    species group index)."""
    sols = []
    for pkg, gm in ((jmesh, gj), (tmesh, gt)):
        port = pkg is tmesh
        if port:
            mech_ = tc.load_mechanism(mech, device="cpu")
            th, tr, kin = (tc.make_thermo(mech_), tc.make_transport(mech_),
                           tc.make_kinetics(mech_))
            mk = lambda f: gm.with_bcs(spec(pkg, f), torch.float64,
                                       device="cpu")
            S, Comb, Cfg = LowMachSolverFL, tcomb.NoCombustion, LowMachConfig
        else:
            mech_ = jc.load_mechanism(mech)
            th, tr, kin = (jc.make_thermo(mech_), jc.make_transport(mech_),
                           jc.make_kinetics(mech_))
            mk = lambda f: gm.with_bcs(spec(pkg, f))
            S, Comb, Cfg = JSolverFL, JNoCombustion, JConfig
        groups = None if Y_groups is None else tuple(
            (mk(ig), g) for ig, g in enumerate(Y_groups))
        sols.append(S(m_p=mk("p"), m_h=mk("h"),
                      m_Y=groups[-1][0] if groups else mk("h"),
                      m_rho=mk("rho"), m_U=(mk("U0"), mk("U1"), mk("U2")),
                      thermo=th, transport=tr, combustion=Comb(th, kin),
                      config=Cfg(**cfg), m_Y_groups=groups))
    return sols


def _duct_spec(u_in, h_in):
    def spec(pkg, f):
        zg = pkg.zero_gradient()
        out = {"inlet": zg, "outlet": zg, "ylo": zg, "yhi": zg}
        if f in ("U0", "U1", "U2"):
            out["inlet"] = pkg.fixed_value(u_in if f == "U0" else 0.0)
        elif f == "p":
            out["outlet"] = pkg.fixed_value(101325.0)
        elif f == "h":
            out["inlet"] = pkg.fixed_value(h_in)
        return out
    return spec


def test_graded_blockmesh_duct_matches_jax():
    """An inert 24 x 2 graded blockMesh duct (x grading 6, empty z) with a
    2 m/s inflow at 300 K into air warmed to up to 400 K, three steps: parity
    with equal Krylov counts. (With the uniform 300 K duct of
    tests/test_graded_mesh.py the pressure equation's right-hand side is
    round-off: its normalised initial residual came out 0.64 in JAX and 0.54
    in the port, and the CG counts 46 and 45, while p agreed to 3e-15.)"""
    gj = jbm.build_blockmesh(jbm.parse_blockmesh_dict(DUCT_DICT))
    gt = tbm.build_blockmesh(tbm.parse_blockmesh_dict(DUCT_DICT))
    th = _air()[0]
    h300 = float(th.h_mass(jnp.asarray([300.0]), jnp.ones((1, 1)))[0])
    sj, st = _solvers(gj, gt, _duct_spec(2.0, h300),
                      dict(chemistry=False, div_scheme="upwind"))
    n = gj.n_cells
    U = np.zeros((n, 3))
    U[:, 0] = 2.0
    T = 300.0 + 100.0 * np.sin(np.pi * gj.centers[:, 0] / 0.1)
    s0 = sj.initial_state(jnp.full(n, 101325.0), jnp.asarray(T),
                          jnp.ones((n, 1)), jnp.asarray(U))
    run_both_fl(sj, s0, st, 5e-5, 3)


def test_graded_blockmesh_duct_stays_uniform():
    """tests/test_graded_mesh.py's duct check on the port alone: a uniform
    2 m/s, 300 K inflow stays uniform over 10 steps (the grading makes no
    momentum) and inlet and outlet mass fluxes balance."""
    gt = tbm.build_blockmesh(tbm.parse_blockmesh_dict(DUCT_DICT))
    th, tr, kin = _air_t()
    spec = _duct_spec(2.0, 0.0)
    mk = lambda f: gt.with_bcs(spec(tmesh, f), torch.float64, device="cpu")
    solver = LowMachSolverFL(
        m_p=mk("p"), m_h=mk("rho"), m_Y=mk("rho"), m_rho=mk("rho"),
        m_U=(mk("U0"), mk("U1"), mk("U2")), thermo=th, transport=tr,
        combustion=tcomb.NoCombustion(th, kin),
        config=LowMachConfig(chemistry=False, div_scheme="upwind"))
    n = gt.n_cells
    U = np.zeros((n, 3))
    U[:, 0] = 2.0
    s = solver.initial_state(np.full(n, 101325.0), np.full(n, 300.0),
                             np.ones((n, 1)), U)
    for _ in range(10):
        s, _ = solver.step(s, 5e-5)
    assert (s.U[:, 0] - 2.0).abs().max() < 1e-3 * 2.0
    flux = {p.name: float((fb * p.mag_sf).sum())
            for p, fb in zip(solver.mesh.patches, s.phi_b)}
    np.testing.assert_allclose(-flux["inlet"], flux["outlet"], rtol=1e-6)


def test_sheared_mesh_nonortho_corrector_matches_jax():
    """The 6 x 6 sheared mesh (26.6 degrees non-orthogonal, tilted
    fixedValue walls) with the 9-species mixture in two BC groups, chemistry
    off and one non-orthogonal corrector: two steps of 1 ms."""
    raw = sheared_box_raw(6, 0.5)
    gj, gt = jgeo.build_general_mesh(*raw), tgeo.build_general_mesh(*raw)
    mech = tc.load_mechanism(MECH, device="cpu")
    ns, iO2 = mech.n_species, mech.species_index("O2")
    Y_air = np.zeros(ns)
    Y_air[iO2], Y_air[mech.species_index("N2")] = 0.233, 0.767

    def spec(pkg, f):
        zg = pkg.zero_gradient()
        out = {"x_lo": zg, "x_hi": zg, "y_lo": zg, "y_hi": zg}
        if f == "U0":
            out["x_lo"] = pkg.fixed_value(0.5)
        elif f in ("U1", "U2"):
            out["x_lo"] = pkg.fixed_value(0.0)
        elif f == "p":
            out["x_hi"] = pkg.fixed_value(101325.0)
        elif f == "h":
            out["y_hi"] = pkg.fixed_value(4.0e5)
        elif f == 0:                                   # the O2 group
            out["x_lo"] = pkg.fixed_value(0.3)
        return out

    groups = [(iO2,), tuple(i for i in range(ns) if i != iO2)]
    sj, st = _solvers(gj, gt, spec,
                      dict(chemistry=False, n_nonortho=1,
                           inert_index=mech.species_index("N2")),
                      Y_groups=groups, mech=MECH)
    assert st.mesh.k_no is not None
    n = gj.n_cells
    c = gj.centers
    T = 300.0 + 100.0 * np.sin(np.pi * c[:, 0]) * c[:, 1]
    U = np.stack([0.5 + 0.1 * c[:, 1], 0.05 * np.sin(np.pi * c[:, 0]),
                  np.zeros(n)], 1)
    Y = np.broadcast_to(Y_air, (n, ns)).copy()
    s0 = sj.initial_state(jnp.full(n, 101325.0), jnp.asarray(T),
                          jnp.asarray(Y), jnp.asarray(U))
    _, s = run_both_fl(sj, s0, st, 1e-3, 2)
    assert float(s.Y[:, iO2].max()) > 0.233   # the O2 inlet entered


def test_fl_solver_raises_on_later_slices():
    """What raised NotImplementedError here before the face-list RAS, AMG
    and spray slice (m_k, p_mg, sources) now runs: a k-epsilon solver with
    (k, eps) in the state, an AMG-preconditioned one, a step with spray
    sources; an unknown k-epsilon variant raises ValueError."""
    from deepflame_torch.ops.amg_fl import make_amg_fl
    gt = tbm.build_blockmesh(tbm.parse_blockmesh_dict(DUCT_DICT))
    m = gt.with_bcs({k: tmesh.zero_gradient() for k in gt.patch_names
                     if k not in ("zlo", "zhi")}, torch.float64, device="cpu")
    th, tr, kin = _air_t()
    kw = dict(m_p=m, m_h=m, m_Y=m, m_rho=m, m_U=(m, m, m), thermo=th,
              transport=tr, combustion=tcomb.NoCombustion(th, kin),
              config=LowMachConfig(chemistry=False))
    with pytest.raises(ValueError):
        LowMachSolverFL(**kw, m_k=m, m_eps=m, keps_variant="kOmega")
    n = m.n_cells
    init = (np.full(n, 1e5), np.full(n, 300.0), np.ones((n, 1)))
    for extra in (dict(m_k=m, m_eps=m), dict(p_mg=make_amg_fl(m))):
        solver = LowMachSolverFL(**kw, **extra)
        s, d = solver.step(solver.initial_state(*init), 1e-5)
        assert len(s.turb) == (2 if "m_k" in extra else 0)
        assert torch.isfinite(s.p).all() and int(d["iters_p"]) >= 0
    solver = LowMachSolverFL(**kw)
    z = torch.zeros(n, dtype=torch.float64)
    s, _ = solver.step(solver.initial_state(*init), 1e-5, sources=dict(
        Srho=z + 1e-3, SU=torch.zeros((3, n), dtype=torch.float64), Sh=z,
        SY=z, SY_index=None))
    assert float(s.rho.min()) > float(solver.initial_state(*init).rho.min())


# ------------------------------------------------------- repairs of the port

def test_make_step_fl_steps_like_the_solver():
    """make_step_fl(solver) is the solver's eager step(state, dt,
    sources=None); zero spray sources change nothing."""
    from deepflame_torch.solvers.low_mach_fl import make_step_fl
    gt = tbm.build_blockmesh(tbm.parse_blockmesh_dict(DUCT_DICT))
    m = gt.with_bcs({k: tmesh.zero_gradient() for k in gt.patch_names
                     if k not in ("zlo", "zhi")}, torch.float64, device="cpu")
    th, tr, kin = _air_t()
    solver = LowMachSolverFL(m_p=m, m_h=m, m_Y=m, m_rho=m, m_U=(m, m, m),
                             thermo=th, transport=tr,
                             combustion=tcomb.NoCombustion(th, kin),
                             config=LowMachConfig(chemistry=False))
    rng = np.random.default_rng(2)
    s = solver.initial_state(np.full(m.n_cells, 1e5),
                             300.0 + rng.uniform(0, 50.0, m.n_cells),
                             np.ones((m.n_cells, 1)))
    step = make_step_fl(solver)
    a, da = step(s, 1e-5)
    b, db = solver.step(s, 1e-5)
    for x, y in zip(a, b):
        if torch.is_tensor(x):
            assert torch.equal(x, y)
    assert int(da["iters_p"]) == int(db["iters_p"])
    # zero spray sources leave the step as it is
    z = torch.zeros(m.n_cells, dtype=torch.float64)
    c, _ = step(s, 1e-5, dict(Srho=z, SU=torch.zeros((3, m.n_cells),
                                                     dtype=torch.float64),
                              Sh=z, SY=z, SY_index=None))
    for x, y in zip(c, b):
        if torch.is_tensor(x):
            assert torch.equal(x, y)


def test_combustion_correct_takes_turb_like_jax():
    """correct(T, p, Y, dt, turb=None, dt_start=None) in every model, as in
    the JAX package: the face-list step passes the turbulence fields fifth,
    positionally; Laminar ignores them."""
    from deepflame_torch.combustion import DNNChemistry
    for cls in (tcomb.CombustionModel, tcomb.Laminar, tcomb.NoCombustion,
                DNNChemistry):
        assert list(inspect.signature(cls.correct).parameters) == \
            ["self", "T", "p", "Y", "dt", "turb", "dt_start"], cls
    mech = tc.load_mechanism(MECH, device="cpu")
    th, kin = tc.make_thermo(mech), tc.make_kinetics(mech)
    comb = tcomb.Laminar(th, kin)
    rng = np.random.default_rng(0)
    T = torch.as_tensor(rng.uniform(1200.0, 1500.0, 6))
    p = torch.full((6,), 101325.0, dtype=torch.float64)
    Y = torch.zeros((6, mech.n_species), dtype=torch.float64)
    for s_, y in (("H2", 0.0285), ("O2", 0.2264), ("N2", 0.7451)):
        Y[:, mech.species_index(s_)] = y
    dt0 = torch.full((6,), 1e-8, dtype=torch.float64)
    turb = dict(k=torch.ones(6), epsilon=torch.ones(6), nu=torch.ones(6))
    a = comb.correct(T, p, Y, 1e-6, turb, dt_start=dt0)
    b = comb.correct(T, p, Y, 1e-6, dt_start=dt0)
    assert torch.equal(a.RR, b.RR) and torch.equal(a.dt_next, b.dt_next)
