"""PyTorch port of FrontPatchAMR2D against the JAX package on the reacting
H2-air detonation channel (float64, CPU, the 9-species test mechanism),
with a spy on the chemistry drains: every fine substep drains the hot cells
of all row patches in one integrator call.

Tolerance: fields within 1e-8 of each field's largest value (the stiff
drain's round-off through its adaptive trips, as
tests/test_torch_high_speed.py holds the plain step); patch offsets equal.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepflame_tpu.chemistry import load_mechanism, make_kinetics, make_thermo
from deepflame_tpu.chemistry.integrator import RosenbrockOptions
from deepflame_tpu.mesh import (StructuredMesh, empty, symmetry,
                                zero_gradient)
from deepflame_tpu.mesh.patch_amr import FrontPatchAMR2D as JFront
from deepflame_tpu.solvers.high_speed import HighSpeedConfig, HighSpeedSolver

import deepflame_torch.chemistry as tc
import deepflame_torch.solvers.high_speed as ths
from deepflame_torch.cases import (_detonation_2d_fields, detonation_2d_h2_amr,
                                   detonation_dt)
from deepflame_torch.convert import row_patch_state_to_numpy

MECH = os.path.join(os.path.dirname(__file__), "data", "h2_air_9sp.json")


def _jax_tree(x):
    """A JAX state tree as nested dicts of numpy arrays."""
    if hasattr(x, "_asdict"):
        return {k: _jax_tree(v) for k, v in x._asdict().items()}
    return np.asarray(x)


def _assert_trees(j, t, tol, path=""):
    """Equal integer leaves (offsets), float leaves within tol of their
    largest value."""
    if isinstance(j, dict):
        assert set(j) == set(t), path
        for k in j:
            _assert_trees(j[k], t[k], tol, path + "." + k)
        return
    assert j.shape == t.shape, (path, j.shape, t.shape)
    if j.dtype.kind in "iu":
        np.testing.assert_array_equal(j, t, err_msg=path)
    else:
        rel = np.abs(j - t).max() / max(np.abs(j).max(), 1e-300)
        assert rel <= tol, (path, rel)


def _jax_detonation(st):
    """The JAX twin of the port's detonation channel solver."""
    mj = load_mechanism(MECH)
    e = (empty(), empty())
    zg = (zero_gradient(), zero_gradient())
    wall = (symmetry(negate=True), symmetry(negate=True))
    bs = (zg, zg, e)
    bU = (((symmetry(negate=True), zero_gradient()), zg, e), (zg, wall, e), bs)
    m, c = st.mesh, st.config
    return HighSpeedSolver(
        mesh=StructuredMesh(m.nx, m.ny, m.nz, m.dx, m.dy, m.dz),
        thermo=make_thermo(mj), kinetics=make_kinetics(mj), bcs_rho=bs,
        bcs_U=bU, bcs_p=bs, bcs_Y=bs, config=HighSpeedConfig(
            flux=c.flux, rk_order=c.rk_order, limiter=c.limiter,
            chemistry=c.chemistry, T_threshold=c.T_threshold,
            ode_opts=RosenbrockOptions(*c.ode_opts)))


def test_front_patch_reacting_one_drain_per_substep(monkeypatch):
    """The reacting channel (cases.detonation_2d_h2_amr at 32 x 8 on the
    test mechanism, 2 rows, pc 12, ratio 2, buffer_c 1, buffer_y 2,
    igniters over the whole height so that both rows burn): the initial
    state equals JAX's FrontPatchAMR2D.initial_state on the same fields, 2
    steps within 1e-8 with offsets equal. A spy counts the chemistry: each
    step drains the coarse cells once and each of its 2 fine substeps
    drains the hot cells of both rows in one rosenbrock_integrate call."""
    kw = dict(nx=32, ny=8, pc=12, n_rows=2, ratio=2, buffer_c=1, buffer_y=2)
    at, pt = detonation_2d_h2_amr(MECH, dtype=torch.float64, device="cpu",
                                  igniters=((0.0, 0.1),), **kw)
    sj = _jax_detonation(at.coarse)
    aj = JFront.build(sj, pc=12, n_rows=2, ratio=2, buffer_c=1, buffer_y=2)
    mt = tc.load_mechanism(MECH, device="cpu")
    p, T, Y = (x.numpy() for x in _detonation_2d_fields(
        mt, at.coarse.mesh, torch.float64, ((0.0, 0.1),)))
    pj = aj.initial_state(jnp.asarray(p), jnp.asarray(T), jnp.asarray(Y))
    _assert_trees(_jax_tree(pj), row_patch_state_to_numpy(pt), 1e-14)
    assert int((pt.fine.T[:, 2:-2] > 500.0).sum()) > 0   # the interior burns

    calls, splits = [], []
    real_integrate = ths.rosenbrock_integrate
    real_split = ths.HighSpeedSolver._chemistry_split

    def integrate(rhs, y0, *a, **k):
        calls.append(y0.shape[0])
        return real_integrate(rhs, y0, *a, **k)

    def split(self, s, dt, stats=None):
        hot = (s.T > self.config.T_threshold)
        splits.append((s.rho.dim(), tuple(
            hot.flatten(1).any(1).tolist()) if s.rho.dim() == 4 else None))
        return real_split(self, s, dt, stats)

    monkeypatch.setattr(ths, "rosenbrock_integrate", integrate)
    monkeypatch.setattr(ths.HighSpeedSolver, "_chemistry_split", split)
    dt = detonation_dt(at.coarse)
    step = jax.jit(lambda s: aj.step(s, dt))
    for n in range(2):
        pj, dj = step(pj)
        pt, dtd = at.step(pt, dt)
        _assert_trees(_jax_tree(pj), row_patch_state_to_numpy(pt), 1e-8)
        assert len(dtd["fine_chem_lanes"]) == 2
        assert all(n_ > 0 for n_ in dtd["fine_chem_lanes"])
    # per step: the coarse split (unbatched), then 2 fine substeps, each one
    # split of the 2-row batch with hot cells in both rows; one integrator
    # call per split
    assert splits == [(3, None), (4, (True, True)), (4, (True, True))] * 2
    assert len(calls) == 6
    assert float(pt.coarse.T.max()) > 1500.0
