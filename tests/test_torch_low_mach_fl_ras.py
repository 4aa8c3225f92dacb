"""The port's face-list low-Mach step with what the last slices left out:
k-epsilon RAS (standard and RNG) with face-list wall functions, spray
sources, and the shift-plan pressure CG with the AMG preconditioner;
against the JAX package's jitted make_step_fl, float64 on the CPU.

Tolerances as tests/test_torch_low_mach_fl.py: each field's largest
deviation over its largest magnitude <= 1e-8 (k and eps included), velocity
and face fluxes <= 1e-6; Krylov counts equal. Wall-function arrays equal
JAX's exactly. A watch-list check: the structured and face-list backends
of the JAX package disagree at a fixedValue inlet with a transverse
profile (8e-8 of the velocity after 3 steps, 3e-7 after 5, 1e-10 with a
uniform inlet); the port reproduces each backend, so the disagreement.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflame_tpu.chemistry as jc
import deepflame_tpu.mesh as jmesh
from deepflame_tpu.mesh import blockmesh as jbm
from deepflame_tpu.mesh.facelist import from_structured as j_from_structured
from deepflame_tpu.ops.amg_fl import make_amg_fl as j_make_amg
from deepflame_tpu.solvers.low_mach import LowMachSolver as JStructured
from deepflame_tpu.solvers.low_mach_fl import make_step_fl
from deepflame_tpu.solvers.low_mach_fl import rng_keps_kwargs as j_rng
from deepflame_tpu.turbulence.wall_functions_fl import (
    make_wall_functions_fl as j_make_wf)

import deepflame_torch.mesh as tmesh
from deepflame_torch.convert import fl_state_from_numpy
from deepflame_torch.mesh import blockmesh as tbm
from deepflame_torch.mesh.facelist import from_structured
from deepflame_torch.ops.amg_fl import make_amg_fl
from deepflame_torch.solvers import LowMachSolver
from deepflame_torch.solvers.low_mach_fl import rng_keps_kwargs
from deepflame_torch.turbulence.wall_functions_fl import \
    make_wall_functions_fl
from test_torch_low_mach import _rel
from test_torch_low_mach_fl import (DUCT_DICT, _duct_spec, _solvers,
                                    assert_states_close)

DATA = os.path.join(os.path.dirname(__file__), "data")
MECH = os.path.join(DATA, "h2_air_9sp.json")
WALLS = ("ylo", "yhi")


def to_port(s):
    d = {k: np.asarray(getattr(s, k)) for k in
         ("rho", "U", "p", "ha", "Y", "T", "dpdt", "time", "phi")}
    d["phi_b"] = tuple(np.asarray(f) for f in s.phi_b)
    d["turb"] = tuple(np.asarray(f) for f in s.turb)
    return fl_state_from_numpy(d, device="cpu")


def run_pair(sol_j, s_j, sol_t, dt, n, sources=None, slack=0):
    """n steps of both from the JAX state; fields, (k, eps) and Krylov
    counts (within `slack`) after each."""
    s_t = to_port(s_j)
    step = make_step_fl(sol_j)
    src_t = None if sources is None else {
        k: (v if k == "SY_index" else torch.as_tensor(v))
        for k, v in sources.items()}
    src_j = None if sources is None else {
        k: (v if k == "SY_index" else jnp.asarray(v))
        for k, v in sources.items()}
    for _ in range(n):
        s_j, dj = step(s_j, dt, src_j)
        s_t, dt_ = sol_t.step(s_t, dt, sources=src_t)
        for k in ("iters_U", "iters_Y", "iters_h", "iters_p"):
            assert (k in dj) == (k in dt_), k
            if k in dj:
                assert abs(int(dj[k]) - int(dt_[k])) <= slack, \
                    (k, dj[k], dt_[k])
        assert_states_close(s_j, s_t, dt)
        for a, b in zip(s_j.turb, s_t.turb):
            assert _rel(a, b) <= 1e-8
    assert len(s_t.turb) == len(s_j.turb)
    return s_j, s_t


@pytest.fixture(scope="module")
def duct():
    gj = jbm.build_blockmesh(jbm.parse_blockmesh_dict(DUCT_DICT))
    gt = tbm.build_blockmesh(tbm.parse_blockmesh_dict(DUCT_DICT))
    return gj, gt


def test_wall_functions_fl_equal_jax(duct):
    gj, gt = duct
    wj = j_make_wf(gj, WALLS)
    wt = make_wall_functions_fl(gt, WALLS, device="cpu")
    for k in ("mask", "y", "n_wall"):
        np.testing.assert_array_equal(np.asarray(getattr(wj, k)),
                                      getattr(wt, k).numpy(), err_msg=k)
    assert float(wt.mask.sum()) == 48.0 and wt.yplus_lam == wj.yplus_lam


@pytest.mark.parametrize("variant", ["standard", "RNG"])
def test_keps_with_wall_functions_matches_jax(duct, variant):
    """k-epsilon on the graded blockMesh duct (24 x 2, walls at y = 0 and
    0.025 m) with wall functions: a 10 m/s inflow into a sheared field,
    three steps. Krylov counts within 1: in the third RNG step the
    momentum residual sits at its tolerance, JAX stops after 2 trips and
    the port after 3 with the states 1e-13 apart."""
    gj, gt = duct
    th = jc.make_thermo(jc.load_mechanism(os.path.join(DATA, "air.yaml")))
    h300 = float(th.h_mass(jnp.asarray([300.0]), jnp.ones((1, 1)))[0])
    sj, st = _solvers(gj, gt, _duct_spec(10.0, h300),
                      dict(chemistry=False, div_scheme="upwind"))
    kw = (dict(rng_keps_kwargs(C1=1.52)) if variant == "RNG" else {})
    kw_j = (dict(j_rng(C1=1.52)) if variant == "RNG" else {})
    zg = lambda pkg, gm: {p: pkg.zero_gradient() for p in gm.patch_names
                          if p not in ("zlo", "zhi")}
    mk_j = gj.with_bcs(zg(jmesh, gj))
    mk_t = gt.with_bcs(zg(tmesh, gt), torch.float64, device="cpu")
    sj = dataclasses.replace(sj, m_k=mk_j, m_eps=mk_j,
                             wall_fns=j_make_wf(gj, WALLS), **kw_j)
    st = dataclasses.replace(st, m_k=mk_t, m_eps=mk_t,
                             wall_fns=make_wall_functions_fl(
                                 gt, WALLS, device="cpu"), **kw)
    n = gj.n_cells
    U = np.zeros((n, 3))
    U[:, 0] = 10.0 * np.sin(np.pi * gj.centers[:, 1] / 0.025)
    s0 = sj.initial_state(jnp.full(n, 101325.0), jnp.full(n, 300.0),
                          jnp.ones((n, 1)), jnp.asarray(U), k0=1.0,
                          eps0=100.0)
    _, s_t = run_pair(sj, s0, st, 2e-5, 3, slack=1)
    assert float(s_t.turb[0].min()) > 0.0


def test_spray_sources_step_matches_jax(duct):
    """A step of the 9-species gas on the duct with seeded spray sources
    (Srho, SU, Sh, and SY into H2O), two steps, against JAX's jitted
    make_step_fl with the same sources."""
    gj, gt = duct
    mech = jc.load_mechanism(MECH)
    th = jc.make_thermo(mech)
    ns = mech.n_species
    Y_air = np.zeros((1, ns))
    Y_air[0, mech.species_index("O2")] = 0.233
    Y_air[0, mech.species_index("N2")] = 0.767
    h300 = float(th.h_mass(jnp.asarray([300.0]), jnp.asarray(Y_air))[0])
    # the species in one BC group, zeroGradient all round
    sj, st = _solvers(gj, gt, _duct_spec(2.0, h300),
                      dict(chemistry=False, div_scheme="upwind"),
                      Y_groups=[tuple(range(ns))], mech=MECH)
    n = gj.n_cells
    rng = np.random.default_rng(5)
    U = np.zeros((n, 3))
    U[:, 0] = 2.0
    s0 = sj.initial_state(jnp.full(n, 101325.0), jnp.full(n, 300.0),
                          jnp.asarray(np.repeat(Y_air, n, 0)),
                          jnp.asarray(U))
    sources = dict(Srho=rng.uniform(0.0, 0.5, n),
                   SU=rng.normal(0.0, 5.0, (3, n)),
                   Sh=rng.normal(-1e6, 1e5, n), SY=rng.uniform(0.0, 0.5, n),
                   SY_index=mech.species_index("H2O"))
    _, s_t = run_pair(sj, s0, st, 2e-5, 2, sources)
    assert float(s_t.Y[:, mech.species_index("H2O")].max()) > 0.0


def _plan_pair(p_mg):
    """(JAX, port) face-list solvers of a 12 x 6 x 4 box through
    from_structured (shift plans): a 3 m/s inflow, outlet pressure, walls
    on y and z; with p_mg the AMG-preconditioned pressure CG."""
    shape, L = (12, 6, 4), (0.12, 0.03, 0.02)
    sols = []
    for pkg, port in ((jmesh, False), (tmesh, True)):
        zg, fv = pkg.zero_gradient(), pkg.fixed_value
        bz = ((zg, zg), (zg, zg), (zg, zg))
        bU = lambda v: ((fv(v), zg), (fv(0.0), fv(0.0)), (fv(0.0), fv(0.0)))
        bp = ((zg, fv(101325.0)), (zg, zg), (zg, zg))
        if port:
            import deepflame_torch.chemistry as tc
            from deepflame_torch.combustion import NoCombustion
            from deepflame_torch.solvers import (LowMachConfig,
                                                 LowMachSolverFL)
            mech = tc.load_mechanism(os.path.join(DATA, "air.yaml"),
                                     device="cpu")
            mesh = tmesh.StructuredMesh.box(L, shape, device="cpu")
            fl = lambda b: from_structured(mesh, b, device="cpu")
            amg = make_amg_fl
            th, tr, kin = (tc.make_thermo(mech), tc.make_transport(mech),
                           tc.make_kinetics(mech))
        else:
            from deepflame_tpu.combustion import NoCombustion
            from deepflame_tpu.solvers.low_mach import LowMachConfig
            from deepflame_tpu.solvers.low_mach_fl import LowMachSolverFL
            mech = jc.load_mechanism(os.path.join(DATA, "air.yaml"))
            mesh = jmesh.StructuredMesh.box(L, shape)
            fl = lambda b: j_from_structured(mesh, b)
            amg = j_make_amg
            th, tr, kin = (jc.make_thermo(mech), jc.make_transport(mech),
                           jc.make_kinetics(mech))
        m_p = fl(bp)
        sols.append(LowMachSolverFL(
            m_p=m_p, m_h=fl(bz), m_Y=fl(bz), m_rho=fl(bz),
            m_U=(fl(bU(3.0)), fl(bU(0.0)), fl(bU(0.0))), thermo=th,
            transport=tr, combustion=NoCombustion(th, kin),
            config=LowMachConfig(chemistry=False),
            p_mg=amg(m_p, min_coarse=8) if p_mg else None))
    return sols


@pytest.mark.parametrize("p_mg", [False, True])
def test_plan_mesh_step_matches_jax(p_mg):
    """The step on a shift-plan mesh (every solve on the lattice, the
    pressure CG with the V/V_mean scaling folded into the stencil), with
    Jacobi and with AMG pressure preconditioning: 2 steps against JAX."""
    sj, st = _plan_pair(p_mg)
    assert st.m_p.plan is not None
    n = 12 * 6 * 4
    rng = np.random.default_rng(1)
    U = np.zeros((n, 3))
    U[:, 0] = 3.0 + rng.uniform(-0.3, 0.3, n)
    T = 300.0 + rng.uniform(0.0, 60.0, n)
    s0 = sj.initial_state(jnp.full(n, 101325.0), jnp.asarray(T),
                          jnp.ones((n, 1)), jnp.asarray(U))
    run_pair(sj, s0, st, 2e-5, 2)


def _inlet_profile_deviation(pkg, port):
    """Largest deviation (over the largest value) of U, p and T between
    the structured and face-list backends of one package after 3 steps of
    the inert 16 x 4 duct of tests/test_facelist_solver.py with a
    transverse inlet profile u = 1.5..2.5 m/s."""
    n, L = 16, 0.1
    e = (pkg.empty(), pkg.empty())
    zg, fv = pkg.zero_gradient(), pkg.fixed_value
    prof = np.linspace(1.5, 2.5, 4)
    if port:
        import deepflame_torch.chemistry as C
        from deepflame_torch.combustion import NoCombustion
        from deepflame_torch.solvers import (LowMachConfig, LowMachSolverFL)
        mech = C.load_mechanism(os.path.join(DATA, "air.yaml"), device="cpu")
        mesh = pkg.StructuredMesh.box([L, L / 4, L / n], [n, 4, 1],
                                      device="cpu")
        arr = lambda a: torch.as_tensor(a)
        fl = lambda b: from_structured(mesh, b, device="cpu")
        S, extra = LowMachSolver, {}
    else:
        C = jc
        from deepflame_tpu.combustion import NoCombustion
        from deepflame_tpu.solvers.low_mach import LowMachConfig
        from deepflame_tpu.solvers.low_mach_fl import LowMachSolverFL
        mech = C.load_mechanism(os.path.join(DATA, "air.yaml"))
        mesh = pkg.StructuredMesh.box([L, L / 4, L / n], [n, 4, 1])
        arr = jnp.asarray
        fl = lambda b: j_from_structured(mesh, b)
        S, extra = JStructured, dict(use_pallas="never")
    th, tr, kin = C.make_thermo(mech), C.make_transport(mech), \
        C.make_kinetics(mech)
    # JAX's from_structured takes a per-face value in patch face order
    bU_s = ((fv(arr(prof.reshape(1, 4, 1))), zg), (zg, zg), e)
    bU_f = bU_s if port else ((fv(arr(prof)), zg), (zg, zg), e)
    bU0 = ((fv(0.0), zg), (zg, zg), e)
    bp = ((zg, fv(101325.0)), (zg, zg), e)
    bs = ((zg, zg), (zg, zg), e)
    cfg = LowMachConfig(chemistry=False, div_scheme="upwind", **extra)
    comb = NoCombustion(th, kin)
    ss = S(mesh=mesh, thermo=th, transport=tr, combustion=comb,
           bcs_U=(bU_s, bU0, bU0), bcs_p=bp, bcs_h=bs, bcs_Y=bs, bcs_rho=bs,
           config=cfg)
    sf = LowMachSolverFL(m_p=fl(bp), m_h=fl(bs), m_Y=fl(bs), m_rho=fl(bs),
                         m_U=(fl(bU_f), fl(bU0), fl(bU0)), thermo=th,
                         transport=tr, combustion=comb, config=cfg)
    X = np.asarray(mesh.cell_centers()[0])
    T0 = arr(300.0 + 10.0 * np.sin(60.0 * X))
    p0 = arr(np.full(mesh.shape, 101325.0))
    U0 = np.zeros((3,) + mesh.shape)
    U0[0] = 2.0
    s = ss.initial_state(p0, T0, arr(np.ones((1,) + mesh.shape)), arr(U0))
    f = sf.initial_state(arr(np.asarray(p0).reshape(-1)),
                         arr(np.asarray(T0).reshape(-1)),
                         arr(np.ones((n * 4, 1))),
                         arr(U0.reshape(3, -1).T.copy()))
    steps = [lambda st, sol=sol: sol.step(st, 1e-5)[0] for sol in (ss, sf)]
    if not port:
        import jax
        steps = [jax.jit(f_) for f_ in steps]
    for _ in range(3):
        s, f = steps[0](s), steps[1](f)
    flat = lambda x: (np.asarray(x).reshape(-1) if np.ndim(x) == 3
                      else np.asarray(x).reshape(3, -1).T)
    return {k: float(np.abs(flat(getattr(s, k)) - np.asarray(getattr(f, k)))
                     .max() / np.abs(flat(getattr(s, k))).max())
            for k in ("U", "p", "T")}


def test_inlet_profile_backends_differ_like_jax():
    """Watch list: with a transverse fixedValue inlet profile the JAX
    package's structured and face-list steps disagree well above round-off
    (the port's do the same, by the same amount: each port backend matches
    its JAX counterpart elsewhere in these tests)."""
    dev_j = _inlet_profile_deviation(jmesh, False)
    dev_t = _inlet_profile_deviation(tmesh, True)
    assert dev_j["U"] > 1e-8
    for k in dev_j:
        assert abs(dev_j[k] - dev_t[k]) <= 1e-3 * dev_j[k], (k, dev_j, dev_t)
