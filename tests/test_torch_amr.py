"""PyTorch port of the AMR modules against the JAX package (float64, CPU):
mesh/amr.py (marking, re-gridding, the adaptation driver), the JAX-style
clamping of the patch windows' start indices, and NestedPatchAMR.

Tolerances: marks, decisions and patch offsets equal; refine/coarsen and
the meshes within 1e-14 (the same sums in another order); nested steps
within 1e-10 of each field's largest value (no chemistry: the flux
arithmetic in another order).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflame_tpu.chemistry import load_mechanism, make_kinetics, make_thermo
from deepflame_tpu.constants import GAS_CONSTANT
from deepflame_tpu.mesh import StructuredMesh
from deepflame_tpu.mesh import amr as jamr
from deepflame_tpu.mesh.patch_amr import NestedPatchAMR as JNested
from deepflame_tpu.solvers.high_speed import HighSpeedConfig, HighSpeedSolver

import deepflame_torch.chemistry as tc
import deepflame_torch.mesh as tmesh
from deepflame_torch.convert import patch_state_from_numpy, patch_state_to_numpy
from deepflame_torch.mesh import amr as tamr
from deepflame_torch.mesh.patch_amr import (NestedPatchAMR as TNested,
                                            dynamic_slice,
                                            dynamic_update_slice)
from deepflame_torch.solvers.high_speed import (HighSpeedConfig as TConfig,
                                                HighSpeedSolver as TSolver)

AIR = os.path.join(os.path.dirname(__file__), "data", "air.yaml")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _zg_bcs(mod):
    b = (mod.zero_gradient(), mod.zero_gradient())
    return (b, b, b)


def _fields(n=16, nz=1):
    """Seeded fields on an n x n x nz box: a tanh front in T, a vortex U,
    a mass fraction crossing (0.01, 0.99)."""
    rng = np.random.default_rng(11)
    mesh = StructuredMesh.box([1.0, 1.0, nz / n], [n, n, nz])
    X, Y, Z = (np.asarray(a) for a in mesh.cell_centers())
    T = 300.0 + 1700.0 * 0.5 * (1 + np.tanh((X - 0.5) / 0.05))
    T = T + rng.normal(0.0, 1.0, T.shape)
    U = np.stack([np.sin(2 * np.pi * Y) * 10.0, -np.sin(2 * np.pi * X) * 10.0,
                  0.1 * rng.normal(size=X.shape)])
    Yf = np.clip(0.5 + (Y - 0.5) * 3.0, 0.0, 1.0)
    return mesh, dict(T=T, U=U, Y=Yf)


CRITERIA = {
    "fields": dict(fields=(("T", 500.0, 1500.0),)),
    "gradients": dict(gradients=(("T", 100.0),)),
    "curls": dict(curls=(("U", 3.0),)),
    "interfaces": dict(interfaces=(("Y", 0.01, 0.99),)),
    "all": dict(fields=(("T", 1800.0, 1e9),), gradients=(("T", 300.0),),
                curls=(("U", 5.0),), interfaces=(("Y", 0.2, 0.3),)),
}


@pytest.mark.parametrize("kind", sorted(CRITERIA))
@pytest.mark.parametrize("n_buffer", [0, 2])
@pytest.mark.parametrize("nz", [1, 4])
def test_mark_cells_matches_jax(kind, n_buffer, nz):
    """Every criterion kind, alone and together, with and without buffer
    layers, in 2D and 3D: the marks are equal."""
    mesh_j, f = _fields(nz=nz)
    mesh_t = tmesh.StructuredMesh.box([1.0, 1.0, nz / 16], [16, 16, nz],
                                      device="cpu")
    kw = dict(CRITERIA[kind], n_buffer=n_buffer)
    from deepflame_tpu import mesh as jm
    mj = jamr.mark_cells(jamr.RefinementCriteria(**kw),
                         {k: jnp.asarray(v) for k, v in f.items()},
                         _zg_bcs(jm), mesh_j)
    mt = tamr.mark_cells(tamr.RefinementCriteria(**kw),
                         {k: torch.as_tensor(v) for k, v in f.items()},
                         _zg_bcs(tmesh), mesh_t)
    assert tuple(mt.shape) == mj.shape
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    assert 0.0 < float(mt.mean()) < 1.0, kind


def test_dilate_zeroes_wrapped_faces_like_jax():
    """A mark on each face of the box grows inward only (roll's wrapped
    faces are zeroed), as in JAX."""
    m = np.zeros((6, 5, 4))
    m[0, 2, 1] = m[5, 0, 3] = m[3, 4, 0] = 1.0
    for n in (1, 2, 3):
        np.testing.assert_array_equal(
            np.asarray(jamr._dilate(jnp.asarray(m), n)),
            tamr._dilate(torch.as_tensor(m), n).numpy())


def test_refine_coarsen_match_jax():
    """refine_field / coarsen_field with and without weights, over every
    axis set, and refine_mesh / coarsen_mesh: within 1e-14."""
    rng = np.random.default_rng(0)
    f = rng.random((8, 6, 4))
    rho = rng.random((8, 6, 4)) + 0.5
    for axes in ((0,), (0, 1), (0, 1, 2), (1, 2)):
        rj = np.asarray(jamr.refine_field(jnp.asarray(f), axes))
        rt = tamr.refine_field(torch.as_tensor(f), axes).numpy()
        assert rj.shape == rt.shape
        np.testing.assert_array_equal(rj, rt)
        for w in (None, rho):
            cj = np.asarray(jamr.coarsen_field(
                jnp.asarray(f), axes, None if w is None else jnp.asarray(w)))
            ct = tamr.coarsen_field(torch.as_tensor(f), axes, None if w is None
                                    else torch.as_tensor(w)).numpy()
            assert cj.shape == ct.shape
            np.testing.assert_allclose(ct, cj, rtol=1e-14, atol=0)
    # an odd axis is left alone
    g = rng.random((6, 5, 1))
    np.testing.assert_allclose(
        tamr.coarsen_field(torch.as_tensor(g)).numpy(),
        np.asarray(jamr.coarsen_field(jnp.asarray(g))), rtol=1e-14)
    mj = StructuredMesh.box([1.0, 0.5, 0.1], [8, 6, 1])
    mt = tmesh.StructuredMesh.box([1.0, 0.5, 0.1], [8, 6, 1], device="cpu")
    for fn in ("refine_mesh", "coarsen_mesh"):
        for axes in ((0,), (0, 1, 2)):
            a = getattr(jamr, fn)(mj, axes)
            b = getattr(tamr, fn)(mt, axes)
            assert (a.nx, a.ny, a.nz) == (b.nx, b.ny, b.nz), fn
            np.testing.assert_allclose(
                [b.dx, b.dy, b.dz, b.x0, b.y0, b.z0],
                [a.dx, a.dy, a.dz, a.x0, a.y0, a.z0], rtol=1e-14, atol=0)
            assert b.device == mt.device


def test_adaptive_resolution_decisions_match_jax():
    """The driver's sequence refine, refine, (max level) none, coarsen,
    coarsen, none, on a front and a flat field: the same decisions and
    levels."""
    from deepflame_tpu import mesh as jm
    n = 16
    crit = dict(gradients=(("T", 200.0),), n_buffer=1)
    dj = jamr.AdaptiveResolution(criteria=jamr.RefinementCriteria(**crit),
                                 refine_above=0.01, coarsen_below=0.001,
                                 max_level=2)
    dt_ = tamr.AdaptiveResolution(criteria=tamr.RefinementCriteria(**crit),
                                  refine_above=0.01, coarsen_below=0.001,
                                  max_level=2)
    mj = StructuredMesh.box([1.0, 1.0, 1.0 / n], [n, n, 1])
    mt = tmesh.StructuredMesh.box([1.0, 1.0, 1.0 / n], [n, n, 1],
                                  device="cpu")
    seq = []
    for kind in ("front", "front", "front", "flat", "flat", "flat"):
        X = np.asarray(mj.cell_centers()[0])
        T = (300.0 + 1700.0 * 0.5 * (1 + np.tanh((X - 0.5) / 0.05))
             if kind == "front" else np.full(mj.shape, 300.0))
        mj, aj = dj.maybe_adapt(mj, {"T": jnp.asarray(T)}, _zg_bcs(jm))
        mt, at = dt_.maybe_adapt(mt, {"T": torch.as_tensor(T)},
                                 _zg_bcs(tmesh))
        assert (aj, dj.level) == (at, dt_.level)
        assert mj.shape == mt.shape
        seq.append(at)
    assert seq == ["refine", "refine", None, "coarsen", "coarsen", None]


@pytest.mark.parametrize("start", [-7, -1, 0, 3, 6, 7, 9, 40])
def test_dynamic_slice_clamps_like_jax(start):
    """The patch windows' slice and update clamp their start into range as
    jax.lax.dynamic_slice and dynamic_update_slice do, for a Python int
    and a tensor start."""
    rng = np.random.default_rng(5)
    q = rng.random((2, 10, 3, 1))
    patch = rng.random((2, 4, 3, 1))
    sj = np.asarray(jax.lax.dynamic_slice(jnp.asarray(q), (0, start, 0, 0),
                                          (2, 4, 3, 1)))
    uj = np.asarray(jax.lax.dynamic_update_slice(
        jnp.asarray(q), jnp.asarray(patch), (0, start, 0, 0)))
    for s in (start, torch.tensor(start, dtype=torch.int32)):
        np.testing.assert_array_equal(
            dynamic_slice(torch.as_tensor(q), s, 4, -3).numpy(), sj)
        np.testing.assert_array_equal(
            dynamic_update_slice(torch.as_tensor(q), torch.as_tensor(patch),
                                 s, -3).numpy(), uj)


def test_clamp_lo_above_hi_like_jnp_clip():
    """The x_margin clips (deepflame_tpu/mesh/patch_amr.py:731, :775-777)
    can get lo > hi: jnp.clip then returns hi, and torch.clamp with
    min > max does the same."""
    x = np.arange(-3, 12, dtype=np.int32)
    for lo, hi in ((6, 2), (4, 4), (0, 9), (5, -1)):
        np.testing.assert_array_equal(
            torch.clamp(torch.as_tensor(x), lo, hi).numpy(),
            np.asarray(jnp.clip(jnp.asarray(x), lo, hi)))


# ------------------------------------------------------------------ nested

def _air_solvers(cells, lengths):
    """A JAX and a port solver of the one-species air gas, zeroGradient on
    every axis of more than one cell (else empty); HLLC, RK2, vanLeer, no
    chemistry."""
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
    st = TSolver(mesh=tmesh.StructuredMesh.box(lengths, cells, device="cpu"),
                 thermo=tc.make_thermo(mt), kinetics=tc.make_kinetics(mt),
                 bcs_rho=bt, bcs_U=(bt,) * 3, bcs_p=bt, bcs_Y=bt,
                 config=TConfig(**cfg))
    return mj, sj, st


def _sod(mech, mesh):
    X = np.asarray(mesh.cell_centers()[0])
    W = float(np.asarray(mech.molecular_weights)[0])
    T = np.where(X < 0.5, 1e5 * W / (1.0 * GAS_CONSTANT),
                 1e4 * W / (0.125 * GAS_CONSTANT))
    p = np.where(X < 0.5, 1e5, 1e4)
    return p, T, np.ones((1,) + X.shape)


def _jax_tree(x):
    """A JAX state tree as nested dicts of numpy arrays."""
    if hasattr(x, "_asdict"):
        return {k: _jax_tree(v) for k, v in x._asdict().items()}
    return np.asarray(x)


def _offsets(tree):
    out = []
    while isinstance(tree, dict) and "offset" in tree:
        out.append(int(tree["offset"]))
        tree = tree["fine"]
    return out


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


def _run_nested(cells, lengths, pcs, steps, offset, criteria=None, **kw):
    """JAX's and the port's NestedPatchAMR on the Sod tube, the port
    started from JAX's initial state; states compared after every step.
    Returns (JAX offsets per step, port state)."""
    mech, sj, st = _air_solvers(cells, lengths)
    crit_j = crit_t = None
    if criteria is not None:
        crit_j = jamr.RefinementCriteria(**criteria)
        crit_t = tamr.RefinementCriteria(**criteria)
    aj = JNested.build(sj, pcs, criteria=crit_j, **kw)
    at = TNested.build(st, pcs, criteria=crit_t, **kw)
    p, T, Y = _sod(mech, sj.mesh)
    pj = aj.initial_state(jnp.asarray(p), jnp.asarray(T), jnp.asarray(Y),
                          offset=offset)
    pt = patch_state_from_numpy(_jax_tree(pj), device="cpu")
    _assert_trees(_jax_tree(pj), patch_state_to_numpy(
        at.initial_state(p, T, Y, offset=offset)), 1e-14)
    dt = 0.2 * sj.mesh.dx / (np.sqrt(1.4e5) * 1.8)
    step = jax.jit(lambda s: aj.step(s, dt))
    offs = []
    for _ in range(steps):
        pj, dj = step(pj)
        pt, dtd = at.step(pt, dt)
        tree = _jax_tree(pj)
        _assert_trees(tree, patch_state_to_numpy(pt), 1e-10)
        assert int(dtd["patch_offset"]) == int(dj["patch_offset"])
        offs.append(_offsets(tree))
    return offs, pt


def test_nested_two_levels_criteria_reflux_matches_jax():
    """2 levels, x only, windows targeted by RefinementCriteria (|grad rho|
    dx and a pressure window), refluxing at both levels, on a 100-cell Sod
    tube: 8 steps within 1e-10, every level's offsets equal; the level-1
    window moves."""
    offs, pt = _run_nested(
        [100, 1, 1], [1.0, 1e-2, 1e-2], (32, 32), 8, 34, ratio=2, buffer_c=3,
        isotropic=False, reflux=True,
        criteria=dict(gradients=(("rho", 0.03),), fields=(("p", 3e4, 1e9),),
                      n_buffer=2))
    assert len({o[0] for o in offs}) > 1, offs
    assert torch.isfinite(pt.fine.fine.rhoE).all()


def test_nested_three_levels_x_only_matches_jax():
    """3 levels (16, 8, 8), x only, on a 64-cell Sod tube: 8 steps within
    1e-10, the three levels' offsets equal."""
    offs, pt = _run_nested([64, 1, 1], [1.0, 1e-2, 1e-2], (16, 8, 8), 8, 24,
                           ratio=2, isotropic=False)
    assert all(len(o) == 3 for o in offs)
    assert len({o[1] for o in offs}) > 1, offs


def test_nested_isotropic_3d_matches_jax():
    """One isotropic level (the hexRef8 cube split: x, y and z refined) on
    a 16 x 4 x 4 box with refluxing: 4 steps within 1e-10."""
    mech, sj, st = _air_solvers([16, 4, 4], [1.0, 0.25, 0.25])
    at = TNested.build(st, (8,), ratio=2, isotropic=True)
    assert at.axes == (0, 1, 2) and at.fine.mesh.shape == (16, 8, 8)
    _run_nested([16, 4, 4], [1.0, 0.25, 0.25], (8,), 4, 4, ratio=2,
                isotropic=True, reflux=True)


def test_nested_margin_clip_lo_above_hi_reproduced():
    """Watch list (deepflame_tpu/mesh/patch_amr.py:731): with pcs (8, 8)
    and buffer_c 3 the child's clip range is [6, 16 - 8 - 6 = 2], lo > hi,
    so the child window sits at 2, inside the parent's seeded buffer zone.
    The port reproduces it: offsets equal to JAX's and fields within
    1e-10."""
    offs, pt = _run_nested([32, 1, 1], [1.0, 1e-2, 1e-2], (8, 8), 3, 12,
                           ratio=2, buffer_c=3, isotropic=False)
    assert all(o[1] == 2 for o in offs), offs
    assert int(pt.fine.offset) < 3 * 2
