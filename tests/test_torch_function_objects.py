"""The port's function objects (runtime/function_objects.py) against the JAX
package's, on the structured and the face-list mesh (float64, CPU).

Every class and function of the module's two `__all__` lists. Both
packages' objects are called with the same seeded fields at two write
times; each file they write is read with np.loadtxt and compared to 1e-12 of
each column's largest value, indices (probe and line cells, histogram
counts, min/max locations) exactly. Fields include values exactly on inner
and outer histogram edges (numpy's rule: an inner edge belongs to the upper
bin, the last edge to the last bin) in float64 and float32, and k/10 on the
edges of 10 bins over [0, 1], where the scaled offset of 0.3 is
3.0000000000000004 and numpy's edge test moves it down to bin 2; a CoV;
min/max ties (the first cell in both); a probe point exactly on a face.
Functions returning fields are held to 1e-12 of the largest value.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflame_tpu.mesh as jm
from deepflame_tpu.mesh import blockmesh as jbm
from deepflame_tpu.runtime import function_objects as JF

import deepflame_torch.mesh as tm
from deepflame_torch.cases import jet_blockmesh_dict
from deepflame_torch.mesh import blockmesh as tbm
from deepflame_torch.runtime import function_objects as TF

SHAPE = (8, 6, 4)
LENGTHS = (8e-3, 6e-3, 4e-3)
ORIGIN = (0.0, -3e-3, 0.0)
TIMES = (1e-6, 2.5e-6)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(scope="module")
def meshes():
    return (jm.StructuredMesh.box(LENGTHS, SHAPE, ORIGIN),
            tm.StructuredMesh.box(LENGTHS, SHAPE, ORIGIN, device="cpu"))


def _fields(shape, seed):
    """Seeded numpy fields: T with a tied minimum, p, U (3, ...), H of the
    integers 0..10 (on the edges of 5 bins over [0, 10]) and T32, T in
    float32."""
    rng = np.random.default_rng(seed)
    T = rng.uniform(300.0, 2000.0, shape)
    T.reshape(-1)[[3, 17]] = 250.0          # a tie for the minimum
    H = (np.arange(T.size) % 11).astype(np.float64).reshape(shape)
    return dict(T=T, p=rng.uniform(1e5, 1.1e5, shape),
                U=rng.uniform(-5.0, 20.0, (3,) + shape), H=H, G=H / 10.0,
                T32=T.astype(np.float32), rho=rng.uniform(0.3, 1.2, shape))


def _drive(objs_j, objs_t, fields_np, tmp_path, faces=None):
    """Call each pair at both write times (the fields shifted between the
    calls), write, and hold every file the port writes against the JAX
    one. Returns the number of files compared."""
    for i, t in enumerate(TIMES):
        fj = {k: jnp.asarray(v + i) for k, v in fields_np.items()}
        ft = {k: _t(v + i) for k, v in fields_np.items()}
        for oj, ot in zip(objs_j, objs_t):
            oj(t, fj)
            ot(t, ft)
    n = 0
    for oj, ot in zip(objs_j, objs_t):
        if not hasattr(oj, "write"):
            continue
        pj, pt = oj.write(), ot.write()
        pj = pj if isinstance(pj, list) else [pj]
        pt = pt if isinstance(pt, list) else [pt]
        assert [os.path.basename(p) for p in pj] == \
            [os.path.basename(p) for p in pt] and pj
        for a, b in zip(pj, pt):
            A, B = np.loadtxt(a, ndmin=2), np.loadtxt(b, ndmin=2)
            assert A.shape == B.shape, a
            assert open(a).readline() == open(b).readline(), a  # header
            scale = np.maximum(np.abs(A).max(0), 1e-300)
            assert (np.abs(A - B).max(0) <= 1e-12 * scale).all(), a
            n += 1
    return n


def _pairs(tmp_path, make):
    """make(F module, mesh, out_dir prefix) for both packages."""
    return [make(JF, "jax", str(tmp_path / "jax")),
            make(TF, "port", str(tmp_path / "port"))]


def test_structured_objects_match_jax(meshes, tmp_path):
    mj, mt = meshes
    box = ((1e-3, 6e-3), (-2e-3, 2e-3), (0.0, 3e-3))
    on_face = (2.5e-3, 0.0, 2e-3)        # y = 0 is the face between j = 2, 3
    pts = [on_face, (0.0, -3e-3, 0.0), (7.9e-3, 2.9e-3, 3.9e-3),
           (1.0, 1.0, 1.0)]              # the last one clipped into the box

    def make(F, which, out):
        m = mj if which == "jax" else mt
        d = lambda s: os.path.join(out, s)
        return [
            F.FieldMinMax(m, ("T", "p", "T32"), d("mm")),
            F.Probes(m, pts, ("T", "p"), d("probes")),
            F.LineSample(m, 0, on_face, ("T", "p"), d("line_x")),
            F.LineSample(m, 1, (4e-3, 0.0, 1e-3), ("T",), d("line_y")),
            F.LineSample(m, 2, (9.0, 9.0, 0.0), ("p",), d("line_z")),
            F.Histogram("T", 50, out_dir=d("hist_T")),
            F.Histogram("H", 5, lo=0.0, hi=10.0, out_dir=d("hist_H")),
            F.Histogram("G", 10, lo=0.0, hi=1.0, out_dir=d("hist_G")),
            F.Histogram("T32", 7, out_dir=d("hist_T32")),
            F.Histogram("T", 4, lo=1000.0, hi=1000.0, out_dir=d("hist_1")),
            F.VolFieldValue(m, ("T", "p"), ("sum", "volIntegrate", "average",
                                            "volAverage", "min", "max", "CoV"),
                            out_dir=d("vol")),
            F.VolFieldValue(m, ("T",), ("volAverage", "CoV", "max"), box=box,
                            out_dir=d("vol_box")),
        ]
    objs = _pairs(tmp_path, make)
    assert objs[0][1].idx == objs[1][1].idx
    assert objs[1][1].idx[0] == (2, 3, 2) and objs[1][1].idx[3] == (7, 5, 3)
    assert _drive(*objs, _fields(SHAPE, 1), tmp_path) == 2 + 2 * 3 + 5 * 2 + 2
    # the tied minimum takes the first cell in both
    mm = np.loadtxt(objs[1][0].write(), ndmin=2)
    X = [c.numpy().reshape(-1) for c in mt.cell_centers()]
    assert mm[0, 2] == X[0][3] and mm[0, 3] == X[1][3]
    # values on the bin edges: 0 and 10 in the outer bins, 2, 4, 6, 8 in
    # the bin above
    h = np.loadtxt(os.path.join(str(tmp_path / "port"), "hist_H",
                                "H_1e-06.dat"))
    n = np.arange(np.prod(SHAPE)) % 11
    np.testing.assert_array_equal(h[:, 1], np.histogram(n, 5, (0, 10))[0])
    assert h[0, 1] == np.isin(n, (0, 1)).sum() and \
        h[-1, 1] == np.isin(n, (8, 9, 10)).sum()
    g = np.loadtxt(os.path.join(str(tmp_path / "port"), "hist_G",
                                "G_1e-06.dat"))
    np.testing.assert_array_equal(g[:, 1], np.histogram(n / 10.0, 10,
                                                        (0.0, 1.0))[0])
    assert g[2, 1] == 2 * np.isin(n, (2,)).sum()    # 0.2 and 0.3 in bin 2


def test_surface_delta_average_and_set_match_jax(meshes, tmp_path):
    """SurfaceFieldValue on face arrays, FieldValueDelta of two
    VolFieldValues, FieldAverage's running means (on the device in the
    port), DerivedFields with FieldCalculus specs into a FunctionObjectSet."""
    mj, mt = meshes
    rng = np.random.default_rng(2)
    fields = _fields(SHAPE, 3)
    fields["phi_x"] = rng.normal(size=(SHAPE[0] + 1,) + SHAPE[1:])
    fields["phi_z"] = rng.normal(size=SHAPE[:2] + (SHAPE[2] + 1,))
    zg = lambda pkg: ((pkg.zero_gradient(), pkg.zero_gradient()),) * 3

    def make(F, which, out):
        m, pkg = (mj, jm) if which == "jax" else (mt, tm)
        D = __import__(("deepflame_tpu" if which == "jax" else
                        "deepflame_torch") + ".runtime.derived",
                       fromlist=["DerivedFields"])
        C = F.FieldCalculus
        d = lambda s: os.path.join(out, s)
        b = zg(pkg)
        specs = {"magU": C.mag("U"), "magSqrU": C.mag_sqr("U"),
                 "Ux": C.component("U", 0), "Tp": C.add("T", "p"),
                 "pT": C.subtract("p", "T"), "T2": C.scale("T", 2.0),
                 "logT": C.log("T"), "dTdt": C.ddt("T", 1e-6),
                 "absT": C.mag("T"), "T2sq": C.mag_sqr("T"),
                 "gradT_y": lambda f, g=C.grad("T", b, m): g(f)[1],
                 "divU": C.div("U", (b, b, b), m)}
        names = tuple(specs)
        inner = F.FunctionObjectSet([
            F.VolFieldValue(m, names, ("max", "min", "average"),
                            out_dir=d("vol_derived")),
            F.SurfaceFieldValue(m, ("phi_x",), 0, SHAPE[0],
                                ("areaAverage", "areaIntegrate", "sum",
                                 "min", "max"), d("surf_x")),
            F.SurfaceFieldValue(m, ("phi_z",), 2, 1, ("sum",), d("surf_z")),
            F.FieldValueDelta(
                F.VolFieldValue(m, ("T",), ("max",), out_dir=d("a")),
                F.VolFieldValue(m, ("T",), ("min",), out_dir=d("b")),
                "subtract", d("delta")),
            F.FieldValueDelta(
                F.VolFieldValue(m, ("T",), ("max",), out_dir=d("c")),
                F.VolFieldValue(m, ("p",), ("volAverage",), out_dir=d("e")),
                "max", d("delta_max")),
            F.FieldAverage(("T", "U")),
        ])
        return [D.DerivedFields(specs, inner)]
    objs = _pairs(tmp_path, make)
    assert _drive(*objs, fields, tmp_path) == 5
    aj, at = objs[0][0].inner.objects[-1], objs[1][0].inner.objects[-1]
    for k in ("T", "U"):
        assert isinstance(at.mean[k], torch.Tensor)
        assert _rel(aj.mean[k], at.mean[k]) <= 1e-12
    assert at.n == aj.n == 2


def test_structured_functions_match_jax(meshes, tmp_path):
    """total_pressure, pressure_coefficient, write_cell_centres and
    _volumes, randomise (numpy's draws), surface_interpolate,
    NearWallFields, processor_field, ReadFields,
    field_coordinate_system_transform, StreamLine, region_size_distribution,
    blending_factor, age, interface_height and xi_reaction_rate."""
    mj, mt = meshes
    f = _fields(SHAPE, 5)
    T, p, U, rho = f["T"], f["p"], f["U"], f["rho"]
    ok = lambda a, b: _rel(a, b) <= 1e-12
    assert ok(JF.total_pressure(p, rho, U),
              TF.total_pressure(_t(p), _t(rho), _t(U)))
    for r in (None, 1.1):
        assert ok(JF.pressure_coefficient(p, rho, U, 1e5, 10.0, r),
                  TF.pressure_coefficient(_t(p), _t(rho), _t(U), 1e5, 10.0, r))
    for fn in ("write_cell_centres", "write_cell_volumes"):
        a = np.loadtxt(getattr(JF, fn)(mj, str(tmp_path / "jm")))
        b = np.loadtxt(getattr(TF, fn)(mt, str(tmp_path / "tm")))
        assert a.shape == b.shape and ok(a, b)
    a, b = JF.randomise(T, 5.0, seed=3), TF.randomise(_t(T), 5.0, seed=3)
    assert b.dtype == torch.float64 and ok(a, b)
    for x, y in zip(JF.surface_interpolate(T, mj),
                    TF.surface_interpolate(_t(T), mt)):
        assert ok(x, y)
    objs = [[JF.NearWallFields(("T", "p"), ax, side,
                               str(tmp_path / f"j{ax}{side}")),
             TF.NearWallFields(("T", "p"), ax, side,
                               str(tmp_path / f"t{ax}{side}"))]
            for ax, side in ((0, 0), (2, 1))]
    assert _drive([o[0] for o in objs], [o[1] for o in objs], f,
                  tmp_path) == 2
    for n_sh, ax in ((1, 0), (3, 1), (4, 2)):
        np.testing.assert_array_equal(JF.processor_field(mj, n_sh, ax),
                                      TF.processor_field(mt, n_sh, ax).numpy())
    npz = str(tmp_path / "snap.npz")
    np.savez(npz, T=T, p=p)
    got = {}
    TF.ReadFields(npz, ["T"], device="cpu")(0.0, got)
    assert list(got) == ["T"] and torch.equal(got["T"], _t(T))
    for e1, e3 in (((1, 0, 0), (0, 0, 1)), ((1, 1, 0), (0.2, 0, 1))):
        assert ok(JF.field_coordinate_system_transform(U, None, e1, e3),
                  TF.field_coordinate_system_transform(_t(U), None, e1, e3))
    # a streamline through a mostly streamwise field
    Us = U.copy()
    Us[0] = np.abs(Us[0]) + 1.0
    seeds = [(0.5e-3, 0.5e-3, 1e-3), (1e-3, 2e-3, 2e-3)]
    sl = [JF.StreamLine(mj, seeds, out_dir=str(tmp_path / "sj")),
          TF.StreamLine(mt, seeds, out_dir=str(tmp_path / "st"))]
    sl[0](0.0, {"U": Us})
    sl[1](0.0, {"U": _t(Us)})
    for a, b in zip(sl[0].write(), sl[1].write()):
        A, B = np.loadtxt(a, ndmin=2), np.loadtxt(b, ndmin=2)
        assert A.shape == B.shape and A.shape[0] > 2 and ok(A, B)
    for thr, above in ((1200.0, True), (800.0, False), (1e9, True)):
        a = JF.region_size_distribution(T, thr, mj.volume, above)
        b = TF.region_size_distribution(_t(T), thr, mt.volume, above)
        assert a.shape == b.shape and (a.size == 0 or ok(a, b))
    for ax in range(3):
        assert ok(JF.blending_factor(T, mj, ax),
                  TF.blending_factor(_t(T), mt, ax))
    # age of fluid under a positive x flux with weak cross flow
    rng = np.random.default_rng(7)
    phi = [np.abs(rng.normal(1.0, 0.1, (SHAPE[0] + 1,) + SHAPE[1:])),
           0.05 * rng.normal(size=(SHAPE[0], SHAPE[1] + 1, SHAPE[2])),
           0.05 * rng.normal(size=SHAPE[:2] + (SHAPE[2] + 1,))]
    for r in (None, rho):
        a = JF.age(phi, mj, rho=r)
        b = TF.age([_t(x) for x in phi], mt, rho=None if r is None else _t(r))
        assert ok(a, b) and float(b.max()) > 0.0
    assert ok(JF.age(phi, mj, n_sweeps=3), TF.age([_t(x) for x in phi], mt,
                                                  n_sweeps=3))
    alpha = np.clip(f["H"] / 10.0, 0.0, 1.0)
    locs = [(1e-3, -2e-3), (0.0, 0.0), (9.0, 9.0)]
    for ax in (2, 0):
        assert ok(JF.interface_height(alpha, mj, locs, ax),
                  TF.interface_height(_t(alpha), mt, locs, ax))
    b_field = np.clip((T - 300.0) / 1700.0, 0.0, 1.0)
    for bcs in (None,):
        a = JF.xi_reaction_rate(b_field, f["H"], 0.4, rho, mj, bcs)
        b = TF.xi_reaction_rate(_t(b_field), _t(f["H"]), 0.4, _t(rho), mt, bcs)
        assert ok(a[0], b[0]) and ok(a[1], b[1])


# ------------------------------------------------------ face-list backend

@pytest.fixture(scope="module")
def fl_meshes():
    """The jet's blockMesh at n = 2 (4 x 2 x 2 cells) as a FaceListMesh in
    each package (zeroGradient everywhere)."""
    text = jet_blockmesh_dict(2)
    gj = jbm.build_blockmesh(jbm.parse_blockmesh_dict(text))
    gt = tbm.build_blockmesh(tbm.parse_blockmesh_dict(text))
    mj = gj.with_bcs({n: jm.zero_gradient() for n in gj.patch_names})
    mt = gt.with_bcs({n: tm.zero_gradient() for n in gt.patch_names},
                     device="cpu")
    return mj, mt


def test_facelist_objects_match_jax(fl_meshes, tmp_path):
    """FieldMinMax, Probes, LineSample (the nearest-cell fallback too),
    VolFieldValue over a box, PatchFieldValue (with a weight field) and
    Histogram on flat fields of the face-list mesh."""
    mj, mt = fl_meshes
    n = mt.n_cells
    rng = np.random.default_rng(11)
    fields = dict(T=rng.uniform(300.0, 2000.0, n), p=rng.uniform(1e5, 2e5, n),
                  w=rng.uniform(0.5, 2.0, n))
    c = mt.centers.numpy()
    pts = [tuple(c[5]), (0.031, 0.0, 0.0), (-1.0, 0.5, 0.5)]

    def make(F, which, out):
        m = mj if which == "jax" else mt
        d = lambda s: os.path.join(out, s)
        return [
            F.FieldMinMax(m, ("T", "p"), d("mm")),
            F.Probes(m, pts, ("T",), d("probes")),
            F.LineSample(m, 0, (0.0, -0.0075, -0.0075), ("T", "p"),
                         d("line")),
            F.LineSample(m, 1, (0.02, 0.0, 0.0), ("T",), d("line_tol"),
                         tol=1e-9),
            F.VolFieldValue(m, ("T",), ("volIntegrate", "volAverage", "CoV"),
                            box=((0.0, 0.03), (-1.0, 1.0), (-1.0, 1.0)),
                            out_dir=d("vol")),
            F.PatchFieldValue(m, "outlet", ("T", "p"),
                              ("areaAverage", "areaIntegrate", "sum", "min",
                               "max"), weight_field="w", out_dir=d("patch")),
            F.PatchFieldValue(m, "inlet", ("T",), ("areaIntegrate",),
                              out_dir=d("patch_in")),
            F.Histogram("T", 8, out_dir=d("hist")),
        ]
    objs = _pairs(tmp_path, make)
    assert objs[0][1].idx == objs[1][1].idx
    np.testing.assert_array_equal(objs[0][2].sel, objs[1][2].sel)
    assert objs[1][3].sel.size == 1          # no centre within 1e-9: nearest
    assert _drive(*objs, fields, tmp_path) == 1 + 1 + 2 * 2 + 1 + 1 + 1 + 2
    assert TF._is_facelist(mt) and not TF._is_facelist(
        tm.StructuredMesh.box(LENGTHS, SHAPE, device="cpu"))


def test_transfers_counted_one_per_call(meshes, tmp_path):
    """Each object's call brings its row to the host in one transfer."""
    _, mt = meshes
    f = {k: _t(v) for k, v in _fields(SHAPE, 8).items()}
    objs = [TF.FieldMinMax(mt, ("T", "p", "T32"), str(tmp_path / "a")),
            TF.Probes(mt, [(1e-3, 0.0, 1e-3)], ("T", "p"),
                      str(tmp_path / "b")),
            TF.LineSample(mt, 0, (0.0, 0.0, 0.0), ("T", "p"),
                          str(tmp_path / "c")),
            TF.VolFieldValue(mt, ("T", "p"), ("volAverage", "CoV"),
                             out_dir=str(tmp_path / "d")),
            TF.Histogram("T", 50, out_dir=str(tmp_path / "e")),
            TF.FieldAverage(("T",))]
    TF.reset_transfers()
    TF.FunctionObjectSet(objs)(1e-6, f)
    assert TF.transfers["count"] == 5
    assert TF.transfers["bytes"] == 8 * (3 * 8 + 2 + 2 * SHAPE[0] + 4
                                         + 50 + 51)
