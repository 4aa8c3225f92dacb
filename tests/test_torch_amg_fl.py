"""The port's aggregation AMG (ops/amg_fl.py) against the JAX package's,
float64 on the CPU.

The host aggregation runs the same sweeps in the same order, so every
level's maps must equal JAX's exactly (a graded box of tests/test_amg_fl.py
and the sheared blockMesh mesh). One V-cycle of a pressure-like operator
agrees within 1e-10 of its largest value (the Galerkin sums may add in
another order); the AMG-preconditioned CG takes JAX's iteration count and
at most half the Jacobi count. On a full FGM face-list step, the default
pressure route, the ELL SpMV route (plan-less mesh) and the AMG route agree
within JAX's own bound for that test (rtol 1e-5, atol 1e-9).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflame_tpu.mesh as jmesh
from deepflame_tpu.mesh.facelist import graded_box as j_graded_box
from deepflame_tpu.ops import amg_fl as jamg
from deepflame_tpu.ops import fv_facelist as jfv
from deepflame_tpu.ops.linsolve import cg as j_cg

import deepflame_torch.mesh as tmesh
from deepflame_torch.ops import amg_fl as tamg
from deepflame_torch.ops import fv_facelist as tfv
from deepflame_torch.ops.linsolve import cg as t_cg
from test_amg_fl import geometric_edges
from test_torch_facelist_mesh import fl_pair

t = lambda a: torch.as_tensor(np.asarray(a))


def _graded(pkg, graded_box, **kw):
    ex = geometric_edges(1.0, 24, 20.0)
    ey = geometric_edges(0.5, 24, 0.05)
    ez = np.linspace(0.0, 0.1, 5)
    zg = pkg.zero_gradient()
    return graded_box(ex, ey, ez, ((zg, pkg.fixed_value(0.0)), (zg, zg),
                                (zg, zg)), **kw)


@pytest.fixture(scope="module")
def graded():
    return (_graded(jmesh, j_graded_box),
            _graded(tmesh, tmesh.facelist.graded_box, device="cpu"))


def _pressure_like(pk, m, a):
    """-laplacian(rho dt, p) + (psi/dt) p with the pressure corrector's
    scaling (tests/test_amg_fl.py's _pressure_like_eqn)."""
    rho, dt, p0 = 1.0, 1e-5, 1e5
    full = lambda n, v: a(np.full(n, v))
    return (pk.fvm_source_implicit_fl(m, full(m.n_cells, rho / p0 / dt))
            + pk.fvm_laplacian_fl(m, full(m.n_faces, rho * dt),
                                  [rho * dt for _ in m.patches], sign=-1.0))


def _assert_levels_equal(aj, at):
    assert aj.n_coarsest == at.n_coarsest
    assert len(aj.levels) == len(at.levels) > 1
    for lj, lt in zip(aj.levels, at.levels):
        assert (lj.n_fine, lj.n_coarse, lj.nf_coarse) == \
            (lt.n_fine, lt.n_coarse, lt.nf_coarse)
        for k in ("agg", "f2c", "flip", "internal", "internal_cell",
                  "c_own", "c_nei"):
            np.testing.assert_array_equal(np.asarray(getattr(lj, k)),
                                          getattr(lt, k).numpy(), err_msg=k)


@pytest.mark.parametrize("mesh", ["graded", "sheared"])
def test_aggregates_equal_jax(mesh, graded):
    fj, ft = graded if mesh == "graded" else fl_pair("sheared")
    # the sheared mesh's 36 cells coarsen only below the default 48
    kw = {} if mesh == "graded" else dict(min_coarse=4)
    _assert_levels_equal(jamg.make_amg_fl(fj, **kw),
                         tamg.make_amg_fl(ft, **kw))


def test_v_cycle_and_amg_cg_match_jax(graded):
    fj, ft = graded
    ej, et = _pressure_like(jfv, fj, jnp.asarray), _pressure_like(tfv, ft, t)
    aj, at = jamg.make_amg_fl(fj), tamg.make_amg_fl(ft)
    r = np.random.default_rng(0).standard_normal(fj.n_cells)
    zj = np.asarray(aj.preconditioner(ej, fj.volumes)(jnp.asarray(r)))
    zt = at.preconditioner(et, ft.volumes)(t(r)).numpy()
    assert np.abs(zj - zt).max() <= 1e-10 * np.abs(zj).max()
    # the AMG-CG of the volume-scaled system, against JAX and Jacobi
    Vj = fj.volumes / jnp.mean(fj.volumes)
    Vt = ft.volumes / ft.volumes.mean()
    bj, bt = jnp.asarray(r) * Vj, t(r) * Vt
    rj = j_cg(lambda x: ej.apply(x) * Vj, bj, jnp.zeros_like(bj),
              aj.preconditioner(ej, fj.volumes), tol=1e-9, max_iter=4000)
    rt = t_cg(lambda x: et.apply(x) * Vt, bt, torch.zeros_like(bt),
              at.preconditioner(et, ft.volumes), tol=1e-9, max_iter=4000,
              nd=1)
    d_inv = 1.0 / (et.diag() * Vt)
    rjac = t_cg(lambda x: et.apply(x) * Vt, bt, torch.zeros_like(bt),
                lambda v: d_inv * v, tol=1e-9, max_iter=4000, nd=1)
    assert int(rj.iterations) == int(rt.iterations)
    assert 2 * int(rt.iterations) <= int(rjac.iterations)
    scale = float(np.abs(np.asarray(rj.x)).max())
    assert np.abs(np.asarray(rj.x) - rt.x.numpy()).max() <= 1e-10 * scale
    assert (rjac.x - rt.x).abs().max() <= 1e-6 * scale


def test_solver_routes_ell_and_amg_match_default():
    """The FGM face-list step on a cyclic box (tests/test_amg_fl.py's
    case): the default route, the AMG-CG route and, on the same mesh
    without its plan, the Jacobi and ELL SpMV routes give one state within
    JAX's bound for this test."""
    import deepflame_torch.chemistry as tc
    from deepflame_torch.combustion.fgm import make_synthetic_table
    from deepflame_torch.solvers.fgm import FGMConfig
    from deepflame_torch.solvers.fgm_fl import FGMSolverFL
    mech = tc.load_mechanism("tests/data/air.yaml", device="cpu")
    tb = make_synthetic_table(dtype=torch.float64, device="cpu")
    n, L = 12, 1e-2
    mesh = tmesh.StructuredMesh.box([L, L, L / n], [n, n, 1], device="cpu")
    c = tmesh.cyclic()
    fl = tmesh.facelist.from_structured(mesh, ((c, c),) * 3, device="cpu")
    base = FGMSolverFL(
        m_p=fl, m_h=fl, m_Y=fl, m_rho=fl, m_U=(fl, fl, fl), m_c=fl,
        m_var=fl, thermo=tc.make_thermo(mech),
        transport=tc.make_transport(mech), combustion=None,
        config=FGMConfig(chemistry=False), table=tb)
    fn = dataclasses.replace(fl, plan=None)
    plain = dataclasses.replace(base, m_p=fn, m_h=fn, m_Y=fn, m_rho=fn,
                                m_U=(fn, fn, fn), m_c=fn, m_var=fn)
    routes = [base, dataclasses.replace(base, p_mg=tamg.make_amg_fl(fl)),
              plain, dataclasses.replace(plain, p_ell=fn.ell_connectivity())]
    X, Yg, _ = mesh.cell_centers()
    r2 = ((X - L / 2) ** 2 + (Yg - L / 2) ** 2).reshape(-1)
    s0 = base.fgm_initial_state(torch.full((n * n,), 101325.0),
                                torch.full((n * n,), 0.3),
                                torch.where(r2 < (L / 4) ** 2, 0.5, 0.0))
    out = []
    for sol in routes:
        s = s0
        for _ in range(3):
            s, _ = sol.step(s, 1e-5)
        out.append(s)
    for s in out[1:]:
        for name in ("T", "rho", "p", "Z", "c"):
            np.testing.assert_allclose(getattr(s, name).numpy(),
                                       getattr(out[0], name).numpy(),
                                       rtol=1e-5, atol=1e-9, err_msg=name)
