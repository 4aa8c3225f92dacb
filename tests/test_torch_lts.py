"""The port's local time stepping (ops/lts.py) against the JAX package's
(float64, CPU), structured and face-list: each rDeltaT field within 1e-12
of its largest value, from seeded fluxes, densities, velocities and sound
speeds, with and without the damping against an old field.

Two faults of the JAX module are reproduced, and this file pins them: on
the face-list mesh the acoustic boundary faces carry c alone, without |un|;
and the face-list acoustic rDeltaT of a uniform state is twice the
structured one on interior cells (the face-list sum over a cell's faces
counts each axis twice, the structured per-axis sum once, and both divide
by 2 maxCo).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflame_tpu.mesh as jm
from deepflame_tpu.mesh import blockmesh as jbm
from deepflame_tpu.ops import lts as JL

import deepflame_torch.mesh as tm
from deepflame_torch.cases import jet_blockmesh_dict
from deepflame_torch.mesh import blockmesh as tbm
from deepflame_torch.ops import lts as TL

SHAPE = (8, 6, 4)


def _rel(a, b):
    a = np.asarray(a)
    return np.abs(a - b.numpy()).max() / max(np.abs(a).max(), 1e-300)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _bcs(pkg):
    zg = (pkg.zero_gradient(), pkg.zero_gradient())
    return ((pkg.zero_gradient(), pkg.fixed_value(1e5)),
            (pkg.cyclic(), pkg.cyclic()), zg)


@pytest.fixture(scope="module")
def box():
    m = (jm.StructuredMesh.box((8e-3, 6e-3, 2e-3), SHAPE),
         tm.StructuredMesh.box((8e-3, 6e-3, 2e-3), SHAPE, device="cpu"))
    rng = np.random.default_rng(12)
    faces = [SHAPE[:a] + (SHAPE[a] + 1,) + SHAPE[a + 1:] for a in range(3)]
    return m, dict(phi=[rng.normal(0.0, 20.0, s) for s in faces],
                   rho=rng.uniform(0.3, 1.2, SHAPE),
                   U=rng.normal(0.0, 30.0, (3,) + SHAPE),
                   c=rng.uniform(300.0, 900.0, SHAPE),
                   old=rng.uniform(1e4, 3e5, SHAPE))


def test_structured_lts_matches_jax(box):
    (mj, mt), d = box
    bj, bt = _bcs(jm), _bcs(tm)
    for n in (0, 1, 3):
        assert _rel(JL.smooth_field(jnp.asarray(d["c"]), bj, mj, n),
                    TL.smooth_field(_t(d["c"]), bt, mt, n)) <= 1e-12
    for kw in ({}, dict(max_co=0.2, max_dt=1e-5, n_smooth=1),
               dict(damping=0.1)):
        old = d["old"] if kw.get("damping") else None
        a = JL.set_r_delta_t([jnp.asarray(x) for x in d["phi"]],
                             jnp.asarray(d["rho"]), bj, mj,
                             r_delta_t_old=None if old is None
                             else jnp.asarray(old), **kw)
        b = TL.set_r_delta_t([_t(x) for x in d["phi"]], _t(d["rho"]), bt, mt,
                             r_delta_t_old=None if old is None else _t(old),
                             **kw)
        assert _rel(a, b) <= 1e-12
    a = JL.set_r_delta_t_acoustic(jnp.asarray(d["U"]), jnp.asarray(d["c"]),
                                  bj, mj)
    b = TL.set_r_delta_t_acoustic(_t(d["U"]), _t(d["c"]), bt, mt)
    assert _rel(a, b) <= 1e-12
    # a one-cell axis is skipped (a 2D case)
    m2 = (jm.StructuredMesh.box((8e-3, 6e-3, 1e-3), SHAPE[:2] + (1,)),
          tm.StructuredMesh.box((8e-3, 6e-3, 1e-3), SHAPE[:2] + (1,),
                                device="cpu"))
    U2, c2 = d["U"][..., :1], d["c"][..., :1]
    assert _rel(JL.set_r_delta_t_acoustic(jnp.asarray(U2), jnp.asarray(c2),
                                          bj, m2[0]),
                TL.set_r_delta_t_acoustic(_t(U2), _t(c2), bt, m2[1])) <= 1e-12


@pytest.fixture(scope="module")
def fl():
    """The jet's blockMesh at n = 4 (8 x 4 x 4 cells, 2 x 2 interior in y
    and z) as a FaceListMesh in each package."""
    text = jet_blockmesh_dict(4)
    gj = jbm.build_blockmesh(jbm.parse_blockmesh_dict(text))
    gt = tbm.build_blockmesh(tbm.parse_blockmesh_dict(text))
    return (gj.with_bcs({n: jm.zero_gradient() for n in gj.patch_names}),
            gt.with_bcs({n: tm.zero_gradient() for n in gt.patch_names},
                        device="cpu"))


def test_facelist_lts_matches_jax(fl):
    mj, mt = fl
    rng = np.random.default_rng(13)
    n, nf = mt.n_cells, mt.n_faces
    phi = rng.normal(0.0, 20.0, nf)
    phi_b = [rng.normal(0.0, 20.0, p.owner.shape[0]) for p in mt.patches]
    rho, c = rng.uniform(0.3, 1.2, n), rng.uniform(300.0, 900.0, n)
    un, old = rng.normal(0.0, 30.0, nf), rng.uniform(1e4, 3e5, n)
    for k in (0, 3):
        assert _rel(JL.smooth_field_fl(jnp.asarray(c), mj, k),
                    TL.smooth_field_fl(_t(c), mt, k)) <= 1e-12
    for pb, o, kw in ((None, None, {}), (phi_b, old, dict(damping=0.3)),
                      (phi_b, None, dict(max_co=0.3, n_smooth=1))):
        a = JL.set_r_delta_t_fl(
            mj, jnp.asarray(phi), jnp.asarray(rho),
            None if pb is None else [jnp.asarray(x) for x in pb],
            r_delta_t_old=None if o is None else jnp.asarray(o), **kw)
        b = TL.set_r_delta_t_fl(
            mt, _t(phi), _t(rho), None if pb is None else [_t(x) for x in pb],
            r_delta_t_old=None if o is None else _t(o), **kw)
        assert _rel(a, b) <= 1e-12
    assert _rel(JL.set_r_delta_t_acoustic_fl(mj, jnp.asarray(un),
                                             jnp.asarray(c)),
                TL.set_r_delta_t_acoustic_fl(mt, _t(un), _t(c))) <= 1e-12


def test_reproduced_acoustic_faults(fl):
    """A uniform state, U = (40, 0, 0) m/s and c = 500 m/s, no smoothing:
    on interior cells the face-list rDeltaT is twice the structured one;
    on the cells at the x walls (whose wall faces see |un| = 40) the
    boundary faces add c alone, so the inlet cells sit below the interior
    by |un| A / (2 maxCo V) of those faces."""
    _, mt = fl
    n = 4
    ms = tm.StructuredMesh.box((0.06, 0.03, 0.03), (2 * n, n, n),
                               origin=(0.0, -0.015, -0.015), device="cpu")
    U = torch.zeros((3,) + ms.shape, dtype=torch.float64)
    U[0] = 40.0
    c = torch.full(ms.shape, 500.0, dtype=torch.float64)
    zg = (tm.zero_gradient(), tm.zero_gradient())
    r_s = TL.set_r_delta_t_acoustic(U, c, (zg, zg, zg), ms, n_smooth=0)
    un = 40.0 * mt.normal[:, 0].abs()
    r_f = TL.set_r_delta_t_acoustic_fl(mt, un, c.reshape(-1), n_smooth=0)
    X = mt.centers.numpy()
    inner = ((np.abs(X[:, 1]) < 0.0075) & (np.abs(X[:, 2]) < 0.0075)
             & (X[:, 0] > 0.0075) & (X[:, 0] < 0.0525))
    flat_s = r_s.reshape(-1).numpy()       # uniform on the structured box
    assert np.allclose(flat_s, flat_s[0], rtol=1e-12)
    assert inner.sum() == 24
    assert np.allclose(r_f.numpy()[inner], 2.0 * flat_s[0], rtol=1e-12)
    inlet = (X[:, 0] < 0.0075) & (np.abs(X[:, 1]) < 0.0075) \
        & (np.abs(X[:, 2]) < 0.0075)
    V, A = ms.volume, ms.dy * ms.dz
    np.testing.assert_allclose(r_f.numpy()[inlet],
                               2.0 * flat_s[0] - 40.0 * A / (2 * 0.5 * V),
                               rtol=1e-12)
