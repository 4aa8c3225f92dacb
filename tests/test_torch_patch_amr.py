"""PyTorch port of the moving-patch AMR against the JAX package (float64,
CPU), on the one-species air gas: MovingPatchAMR with and without
refluxing, FrontPatchAMR2D on a curved front, and the watch-list fault of
FrontPatchAMR2D's shift that the port reproduces. The reacting channel is
in tests/test_torch_patch_amr_reacting.py.

Tolerances: patch offsets equal; fields within 1e-10 of each field's
largest value (no chemistry: the flux arithmetic in another order);
refluxed mass and energy conserved to 1e-12, as JAX's
test_reflux_conserves_mass_energy holds its own.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflame_tpu.chemistry import load_mechanism, make_kinetics, make_thermo
from deepflame_tpu.mesh import StructuredMesh
from deepflame_tpu.mesh.patch_amr import (FrontPatchAMR2D as JFront,
                                         MovingPatchAMR as JMoving)
from deepflame_tpu.solvers.high_speed import HighSpeedConfig, HighSpeedSolver

import deepflame_torch.chemistry as tc
import deepflame_torch.mesh as tmesh
import deepflame_torch.solvers.high_speed as ths
from deepflame_torch.convert import (patch_state_from_numpy,
                                     patch_state_to_numpy,
                                     row_patch_state_from_numpy,
                                     row_patch_state_to_numpy)
from deepflame_torch.mesh.patch_amr import (FrontPatchAMR2D as TFront,
                                            MovingPatchAMR as TMoving)

DATA = os.path.join(os.path.dirname(__file__), "data")
AIR = os.path.join(DATA, "air.yaml")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


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
        assert _rel(j, t) <= tol, (path, _rel(j, t))


def _air_solvers(cells, lengths):
    """A JAX and a port solver of the one-species air gas
    (tests/test_patch_amr.py's `_make`): zeroGradient on every axis of more
    than one cell, else empty; HLLC, RK2, vanLeer, no chemistry."""
    from deepflame_tpu import mesh as jm
    mj = load_mechanism(AIR)
    mt = tc.load_mechanism(AIR, device="cpu")

    def bcs(mod):
        zg = (mod.zero_gradient(), mod.zero_gradient())
        e = (mod.empty(), mod.empty())
        return tuple(zg if n > 1 else e for n in cells)

    cfg = dict(flux="HLLC", rk_order=2, limiter="vanLeer", chemistry="none")
    bj, bt = bcs(jm), bcs(tmesh)
    sj = HighSpeedSolver(mesh=StructuredMesh.box(lengths, cells),
                         thermo=make_thermo(mj), kinetics=make_kinetics(mj),
                         bcs_rho=bj, bcs_U=(bj,) * 3, bcs_p=bj, bcs_Y=bj,
                         config=HighSpeedConfig(**cfg))
    st = ths.HighSpeedSolver(
        mesh=tmesh.StructuredMesh.box(lengths, cells, device="cpu"),
        thermo=tc.make_thermo(mt), kinetics=tc.make_kinetics(mt), bcs_rho=bt,
        bcs_U=(bt,) * 3, bcs_p=bt, bcs_Y=bt,
        config=ths.HighSpeedConfig(**cfg))
    return sj, st


# ------------------------------------------------------------ MovingPatchAMR

N_C, PC, B = 64, 24, 3


def _pulse(sj):
    """tests/test_patch_amr.py's pressure pulse (4 atm over |x - 0.5| <
    0.05, 300 K) on the 64-cell tube."""
    X = np.asarray(sj.mesh.cell_centers()[0])
    p = np.where(np.abs(X - 0.5) < 0.05, 4.0 * 101325.0, 101325.0)
    return p, np.full(X.shape, 300.0), np.ones((1,) + X.shape)


@pytest.mark.parametrize("reflux", [False, True])
def test_moving_patch_matches_jax(reflux):
    """MovingPatchAMR (ratio 2, pc 24, buffer 3) on the 64-cell tube of
    tests/test_patch_amr.py with a pressure pulse, 10 steps: the initial
    states equal, every step's fields within 1e-10, offsets equal, and the
    window moves."""
    sj, st = _air_solvers([N_C, 1, 1], [1.0, 1.0 / N_C, 1.0 / N_C])
    aj = JMoving.build(sj, pc=PC, ratio=2, buffer_c=B, reflux=reflux)
    at = TMoving.build(st, pc=PC, ratio=2, buffer_c=B, reflux=reflux)
    p, T, Y = _pulse(sj)
    off = N_C // 2 - PC // 2
    pj = aj.initial_state(jnp.asarray(p), jnp.asarray(T), jnp.asarray(Y),
                          offset=off)
    _assert_trees(_jax_tree(pj), patch_state_to_numpy(
        at.initial_state(p, T, Y, offset=off)), 1e-14)
    pt = patch_state_from_numpy(_jax_tree(pj), device="cpu")
    step = jax.jit(lambda s: aj.step(s, 2e-6))
    offs = [off]
    for _ in range(10):
        pj, dj = step(pj)
        pt, dtd = at.step(pt, 2e-6)
        _assert_trees(_jax_tree(pj), patch_state_to_numpy(pt), 1e-10)
        assert int(dtd["patch_offset"]) == int(dj["patch_offset"])
        assert float(dtd["T_max"]) == pytest.approx(float(dj["T_max"]),
                                                    rel=1e-10)
        offs.append(int(pt.offset))
    assert len(set(offs)) > 1, offs


def test_moving_patch_reflux_conserves_mass_energy():
    """The port's refluxed coupling telescopes: total mass and energy over
    15 steps of tests/test_patch_amr.py::test_reflux_conserves_mass_energy
    change by round-off (1e-12), and the overwrite-only coupling drifts
    more than 10x that."""
    sj, st = _air_solvers([N_C, 1, 1], [1.0, 1.0 / N_C, 1.0 / N_C])
    p, T, Y = _pulse(sj)

    def run(reflux):
        amr = TMoving.build(st, pc=PC, ratio=2, buffer_c=B, reflux=reflux)
        ps = amr.initial_state(p, T, Y, offset=N_C // 2 - PC // 2)
        m0, e0 = float(ps.coarse.rho.sum()), float(ps.coarse.rhoE.sum())
        for _ in range(15):
            ps, _ = amr.step(ps, 2e-6)
        return (abs(float(ps.coarse.rho.sum()) - m0) / m0,
                abs(float(ps.coarse.rhoE.sum()) - e0) / e0)

    dm_r, de_r = run(True)
    dm_o, _ = run(False)
    assert dm_r < 1e-12, dm_r
    assert de_r < 1e-12, de_r
    assert dm_o > 10.0 * max(dm_r, 1e-15), (dm_o, dm_r)


# ----------------------------------------------------------- FrontPatchAMR2D

NY, ROWS = 12, 3


@pytest.fixture(scope="module")
def curved():
    """tests/test_patch_amr.py's curved front (64 x 12 coarse cells, 8 atm
    behind x = 0.30 + 0.04 sin(2 pi y / Ly)) with FrontPatchAMR2D (pc 24,
    3 rows, ratio 2, buffer_c 3, buffer_y 2) in both packages, and JAX's
    step jitted at dt 8e-6 (fine Courant number about 0.35; the offsets
    move within 10 steps)."""
    sj, st = _air_solvers([N_C, NY, 1], [1.0, 0.25, 1.0 / N_C])
    kw = dict(pc=PC, n_rows=ROWS, ratio=2, buffer_c=B, buffer_y=2)
    aj, at = JFront.build(sj, **kw), TFront.build(st, **kw)
    dt = 8e-6
    return aj, at, dt, jax.jit(lambda s: aj.step(s, dt))


def _front_ic(mesh, waves: bool):
    X, Yg, _ = (np.asarray(a) for a in mesh.cell_centers())
    xj = 0.30 + 0.04 * np.sin(2.0 * np.pi * Yg / 0.25)
    p = np.where(X < xj, 8.0 * 101325.0, 101325.0)
    if waves:
        p = p * (1.0 + 0.02 * np.sin(2.0 * np.pi * X / 0.125))
    return p, np.full(X.shape, 300.0), np.ones((1,) + X.shape)


def _row_pair(aj, at, waves):
    p, T, Y = _front_ic(aj.coarse.mesh, waves)
    pj = aj.initial_state(jnp.asarray(p), jnp.asarray(T), jnp.asarray(Y))
    _assert_trees(_jax_tree(pj), row_patch_state_to_numpy(
        at.initial_state(p, T, Y)), 1e-14)
    return pj, row_patch_state_from_numpy(_jax_tree(pj), device="cpu")


def test_front_patch_curved_front_matches_jax(curved):
    """FrontPatchAMR2D on the curved front, 10 steps: the initial row states
    equal (the port's batch axis against JAX's leading row axis through the
    converters), every step within 1e-10, the row offsets equal, moving
    and different across rows."""
    aj, at, dt, step = curved
    pj, pt = _row_pair(aj, at, waves=False)
    seen = []
    for _ in range(10):
        pj, dj = step(pj)
        pt, dtd = at.step(pt, dt)
        _assert_trees(_jax_tree(pj), row_patch_state_to_numpy(pt), 1e-10)
        np.testing.assert_array_equal(dtd["patch_offsets"].numpy(),
                                      np.asarray(dj["patch_offsets"]))
        seen.append(tuple(pt.offsets.tolist()))
    assert len(set(seen)) > 1, seen
    assert any(len(set(o)) > 1 for o in seen), seen
    assert tuple(pt.fine.rho.shape) == (ROWS, PC * 2, NY // ROWS + 4, 1)
    assert tuple(pt.fine.rhoU.shape) == (3, ROWS, PC * 2, NY // ROWS + 4, 1)


def test_front_patch_shift_leaks_buffer_like_jax(curved):
    """Watch list (deepflame_tpu/mesh/patch_amr.py:433): FrontPatchAMR2D's
    shift keeps every in-range roll source, where MovingPatchAMR's
    (:231-233) sends the cells whose source lies in the old buffer zones
    back to the coarse prolongation. So after a row moves, interior cells
    hold advanced buffer data that no restriction checked. With acoustic
    waves everywhere (buffer data no longer equals the prolongation) both
    packages show it: those cells differ from the prolongation of the new
    window, and the port equals JAX there (1e-10)."""
    aj, at, dt, step = curved
    pj, pt = _row_pair(aj, at, waves=True)
    b, r, nxf = B, 2, PC * 2
    leaks = 0
    for _ in range(10):
        offs0 = np.asarray(pj.offsets)
        pj, _ = step(pj)
        pt, _ = at.step(pt, dt)
        tree = _jax_tree(pj)
        _assert_trees(tree, row_patch_state_to_numpy(pt), 1e-10)
        shift = (np.asarray(pj.offsets) - offs0) * r
        fresh_j = np.asarray(aj.prolong_rows(pj.coarse, pj.offsets).rho)
        fresh_t = at.prolong_rows(pt.coarse, pt.offsets).rho.numpy()
        for j in np.nonzero(shift)[0]:
            i = np.arange(b * r, nxf - b * r)
            src = i + shift[j]
            cells = i[(src >= 0) & (src < nxf)
                      & ((src < b * r) | (src >= nxf - b * r))]
            dj_ = np.abs(tree["fine"]["rho"][j, cells] - fresh_j[j, cells])
            dt_ = np.abs(pt.fine.rho[j, cells].numpy() - fresh_t[j, cells])
            assert cells.size > 0
            leaks += int((dj_.max() > 1e-8 * fresh_j.max())
                         and (dt_.max() > 1e-8 * fresh_t.max()))
    assert leaks > 0


def test_detonation_1d_amr_builds_the_example():
    """cases.detonation_1d_amr as examples/detonation_1d_amr.py builds it
    at its 300 cells: one driver cell at 2000 K and 90 atm; levels 1 a
    MovingPatchAMR (ratio 4, pc 40, buffer 6) at the wall, levels 2 a
    NestedPatchAMR (ratio 2 a level, x only, the example's criteria, the
    child's margin buffer x ratio) whose child starts centred."""
    from deepflame_torch.cases import detonation_1d_amr
    from deepflame_torch.mesh.patch_amr import NestedPatchAMR as TNested
    mech = os.path.join(DATA, "h2_air_9sp.json")
    amr, ps = detonation_1d_amr(mech, levels=1, dtype=torch.float64,
                                device="cpu")
    assert isinstance(amr, TMoving)
    assert (amr.ratio, amr.pc, amr.buffer_c) == (4, 40, 6)
    assert amr.fine.mesh.shape == (160, 1, 1)
    assert amr.coarse.config.ode_opts.rtol == 1e-6
    hot = ps.coarse.T > 500.0
    assert int(hot.sum()) == 1 and bool(hot[0, 0, 0])
    assert float(ps.coarse.T.max()) == 2000.0 and int(ps.offset) == 0
    amr, ps = detonation_1d_amr(mech, levels=2, reflux=True,
                                dtype=torch.float32, device="cpu")
    assert isinstance(amr, TNested) and amr.child is not None
    assert amr.axes == (0,) and amr.reflux and amr.child.reflux
    assert amr.criteria.gradients == (("rho", 0.03),)
    assert amr.criteria.fields == (("p", 3e5, 1e9),)
    assert (amr.child.x_margin, int(ps.fine.offset)) == (12, 20)
    assert amr.coarse.config.ode_opts.rtol == 1e-4
    assert ps.fine.fine.rho.dtype == torch.float32
