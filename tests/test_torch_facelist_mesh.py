"""The port's general-mesh ingestion (mesh/geometry, blockmesh, polymesh,
facelist) against the JAX package's: every array equal, exactly.

Both packages run the same numpy on the host, in the same order, so the
GeneralMesh arrays, each field's boundary coefficients, the non-orthogonal
and skew vectors and the ELL incidence must agree bit for bit. Meshes: the
box, graded and cyclic blockMeshDicts of tests/test_blockmesh.py, the jet's
blockMeshDict at n = 4 with a multi-section grading, a uniformly sheared
hex mesh (tests/test_nonortho.py's helper) and an all-cyclic 4^3 box.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

import deepflame_tpu.mesh as jmesh
from deepflame_tpu.mesh import blockmesh as jbm
from deepflame_tpu.mesh import geometry as jgeo
from deepflame_tpu.mesh import polymesh as jpm

import deepflame_torch.mesh as tmesh
from deepflame_torch.cases import jet_blockmesh_dict
from deepflame_torch.mesh import blockmesh as tbm
from deepflame_torch.mesh import geometry as tgeo
from deepflame_torch.mesh import polymesh as tpm
from test_blockmesh import BOX_DICT, CYCLIC_DICT, GRADED_DICT

GEOM_ARRAYS = ("owner", "neighbour", "mag_sf", "delta", "weights", "normal",
               "volumes", "centers", "f_ctr", "non_ortho_deg")
PATCH_GEOM = ("owner", "mag_sf", "normal", "f_ctr", "delta")

CYCLIC_BOX4_DICT = """
vertices
(
    (0 0 0) (1 0 0) (1 1 0) (0 1 0)
    (0 0 1) (1 0 1) (1 1 1) (0 1 1)
);
blocks
(
    hex (0 1 2 3 4 5 6 7) (4 4 4) simpleGrading (1 1 1)
);
boundary
(
    xlo { type cyclic; neighbourPatch xhi; faces ((0 4 7 3)); }
    xhi { type cyclic; neighbourPatch xlo; faces ((1 2 6 5)); }
    ylo { type cyclic; neighbourPatch yhi; faces ((0 1 5 4)); }
    yhi { type cyclic; neighbourPatch ylo; faces ((3 7 6 2)); }
    zlo { type cyclic; neighbourPatch zhi; faces ((0 3 2 1)); }
    zhi { type cyclic; neighbourPatch zlo; faces ((4 5 6 7)); }
);
"""

# (length fraction, cell fraction, ratio) sections along x
JET_GRADING = (((0.3, 0.5, 2.0), (0.7, 0.5, 0.5)), 1, 0.5)


def sheared_box_raw(n, alpha, lz=0.1, beta=0.0):
    """(points, faces, owner, neighbour, patch_defs) of the n x n x 1 hex
    mesh of the unit square sheared x -> x + alpha*y + beta*y^2
    (tests/test_nonortho.py's sheared_box, which has beta = 0: constant
    non-orthogonality atan(alpha), tilted x walls). beta != 0 bends the
    shear, so the faces are skewed as well."""
    xs = np.linspace(0.0, 1.0, n + 1)
    ys = np.linspace(0.0, 1.0, n + 1)
    zs = np.array([0.0, lz])
    pid = lambda i, j, k: (i * (n + 1) + j) * 2 + k
    cid = lambda i, j: i * n + j
    pts = np.zeros(((n + 1) * (n + 1) * 2, 3))
    for i in range(n + 1):
        for j in range(n + 1):
            for k in range(2):
                pts[pid(i, j, k)] = [xs[i] + alpha * ys[j] + beta * ys[j] ** 2,
                                      ys[j], zs[k]]
    faces, owner, neighbour = [], [], []
    for i in range(n - 1):
        for j in range(n):
            faces.append([pid(i + 1, j, 0), pid(i + 1, j + 1, 0),
                          pid(i + 1, j + 1, 1), pid(i + 1, j, 1)])
            owner.append(cid(i, j))
            neighbour.append(cid(i + 1, j))
    for i in range(n):
        for j in range(n - 1):
            faces.append([pid(i, j + 1, 0), pid(i, j + 1, 1),
                          pid(i + 1, j + 1, 1), pid(i + 1, j + 1, 0)])
            owner.append(cid(i, j))
            neighbour.append(cid(i, j + 1))
    patch_defs = []

    def add_patch(name, ftype, quads, owners):
        patch_defs.append((name, ftype, len(faces), len(quads)))
        faces.extend(quads)
        owner.extend(owners)

    add_patch("x_lo", "patch", [[pid(0, j, 0), pid(0, j, 1), pid(0, j + 1, 1),
                                 pid(0, j + 1, 0)] for j in range(n)],
              [cid(0, j) for j in range(n)])
    add_patch("x_hi", "patch", [[pid(n, j, 0), pid(n, j + 1, 0),
                                 pid(n, j + 1, 1), pid(n, j, 1)]
                                for j in range(n)],
              [cid(n - 1, j) for j in range(n)])
    add_patch("y_lo", "patch", [[pid(i, 0, 0), pid(i + 1, 0, 0),
                                 pid(i + 1, 0, 1), pid(i, 0, 1)]
                                for i in range(n)],
              [cid(i, 0) for i in range(n)])
    add_patch("y_hi", "patch", [[pid(i, n, 0), pid(i, n, 1),
                                 pid(i + 1, n, 1), pid(i + 1, n, 0)]
                                for i in range(n)],
              [cid(i, n - 1) for i in range(n)])
    zlo, zhi, ozs = [], [], []
    for i in range(n):
        for j in range(n):
            zlo.append([pid(i, j, 0), pid(i, j + 1, 0), pid(i + 1, j + 1, 0),
                        pid(i + 1, j, 0)])
            zhi.append([pid(i, j, 1), pid(i + 1, j, 1), pid(i + 1, j + 1, 1),
                        pid(i, j + 1, 1)])
            ozs.append(cid(i, j))
    add_patch("z_lo", "empty", zlo, ozs)
    add_patch("z_hi", "empty", zhi, ozs)
    return pts, faces, np.asarray(owner), np.asarray(neighbour), patch_defs


def spec_of(pkg, gm, desc):
    """A BC spec of package `pkg` (deepflame_tpu.mesh or deepflame_torch.mesh)
    from {patch: (kind, value)}; a callable value gets the patch's face
    centres (a per-face profile). Unnamed patches are zeroGradient."""
    out = {}
    for p in gm.patches:
        kind, value = desc.get(p.name, ("zeroGradient", 0.0))
        if callable(value):
            value = value(p.f_ctr)
        out[p.name] = pkg.BC(kind, value)
    return out


# each case: (builder of (jax GeneralMesh, port GeneralMesh), BC description)
BOX_DESC = {"xlo": ("fixedValue", 1.3), "yhi": ("fixedGradient", 0.7)}
CASES = {
    "box": (BOX_DICT, BOX_DESC),
    "graded": (GRADED_DICT, BOX_DESC),
    "cyclic": (CYCLIC_DICT, {"ylo": ("fixedValue", 0.3)}),
    "jet_multigrading": (jet_blockmesh_dict(4, JET_GRADING),
                         {"inlet": ("fixedValue",
                                    lambda c: 50.0 * np.exp(-c[:, 1] ** 2
                                                            / 1e-5)),
                          "outlet": ("fixedValue", 101325.0)}),
    "cyclic_box4": (CYCLIC_BOX4_DICT, {}),
    "sheared": (None, {"x_lo": ("fixedValue", 1.0),
                       "y_hi": ("fixedValue", 0.5)}),
    "skewed": (None, {"x_lo": ("fixedValue", 1.0),
                      "y_hi": ("fixedValue", 0.5)}),
}


def build_pair(case):
    """(JAX GeneralMesh, port GeneralMesh) of a case."""
    text = CASES[case][0]
    if text is None:
        raw = sheared_box_raw(6, 0.5, beta=0.4 if case == "skewed" else 0.0)
        return jgeo.build_general_mesh(*raw), tgeo.build_general_mesh(*raw)
    return (jbm.build_blockmesh(jbm.parse_blockmesh_dict(text)),
            tbm.build_blockmesh(tbm.parse_blockmesh_dict(text)))


def fl_pair(case, component=None):
    """(JAX FaceListMesh, port FaceListMesh on the CPU) with the case's BCs."""
    gj, gt = build_pair(case)
    desc = CASES[case][1]
    return (gj.with_bcs(spec_of(jmesh, gj, desc), component=component),
            gt.with_bcs(spec_of(tmesh, gt, desc), torch.float64,
                        component=component, device="cpu"))


def assert_general_equal(gj, gt):
    assert gj.n_cells == gt.n_cells and gj.patch_names == gt.patch_names
    for k in GEOM_ARRAYS:
        np.testing.assert_array_equal(getattr(gj, k), getattr(gt, k), err_msg=k)
    for pj, pt in zip(gj.patches, gt.patches):
        assert pj.ftype == pt.ftype
        for k in PATCH_GEOM:
            np.testing.assert_array_equal(getattr(pj, k), getattr(pt, k),
                                          err_msg=f"{pj.name}.{k}")


def _eq(a, b, what):
    assert (a is None) == (b is None), what
    if a is not None:
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=what)


def assert_facelist_equal(fj, ft):
    assert fj.n_cells == ft.n_cells and fj.n_faces == ft.n_faces
    for k in ("owner", "neighbour", "mag_sf", "delta", "weights", "normal",
              "volumes", "centers", "k_no", "skew", "ell_face", "ell_sign"):
        _eq(getattr(fj, k), getattr(ft, k), k)
    for pj, pt in zip(fj.patches, ft.patches):
        assert (pj.name, pj.kind) == (pt.name, pt.kind)
        for k in ("owner", "mag_sf", "delta", "a", "b", "normal", "k_no"):
            _eq(getattr(pj, k), getattr(pt, k), f"{pj.name}.{k}")
        if pt.owner.shape[0]:
            assert pt.n_axis == int(np.argmax(np.abs(np.asarray(pj.normal)[0])))
    for a, b, what in zip(fj.ell_connectivity(), ft.ell_connectivity(),
                          ("face_ids", "side", "nbr")):
        _eq(a, b, what)


@pytest.mark.parametrize("case", list(CASES))
def test_general_mesh_equals_jax(case):
    assert_general_equal(*build_pair(case))


@pytest.mark.parametrize("case", list(CASES))
def test_facelist_mesh_equals_jax(case):
    fj, ft = fl_pair(case)
    assert_facelist_equal(fj, ft)
    assert ft.device.type == "cpu" and ft.mag_sf.dtype == torch.float64


def test_vector_bcs_equal_jax():
    """with_vector_bcs on the sheared mesh, a symmetry patch reflected per
    component and a per-component tuple elsewhere."""
    gj, gt = build_pair("sheared")
    for pkg, gm in ((jmesh, gj), (tmesh, gt)):
        spec = {"x_lo": (pkg.BC("fixedValue", 2.0), pkg.BC("fixedValue", 0.0),
                         pkg.BC("fixedValue", 0.0)),
                "x_hi": pkg.BC("zeroGradient"), "y_lo": pkg.BC("symmetry"),
                "y_hi": pkg.BC("zeroGradient")}
        if pkg is jmesh:
            mj = gm.with_vector_bcs(spec)
        else:
            mt = gm.with_vector_bcs(spec, torch.float64, device="cpu")
    for fj, ft in zip(mj, mt):
        assert_facelist_equal(fj, ft)


def test_cyclic_nonortho_fault_reproduced():
    """GeneralMesh.with_bcs builds k_no and skew from the unshifted centres
    across cyclic faces (the JAX package's behaviour, kept in the port): on
    an all-cyclic 4^3 box 48 of 192 faces carry |k_no| up to 0.25."""
    fj, ft = fl_pair("cyclic_box4")
    assert ft.n_faces == 192
    rows = (ft.k_no.abs().amax(1) > 1e-12).sum()
    assert int(rows) == 48
    assert abs(float(ft.k_no.abs().max()) - 0.25) < 1e-12
    assert ft.skew is not None and fj.skew is not None


def test_blockmesh_files_and_cell_order():
    """read_blockmesh from a file and openfoam_cell_order equal JAX's; the
    wrong width for ell_arrays raises."""
    d = jbm.parse_blockmesh_dict(GRADED_DICT)
    np.testing.assert_array_equal(jbm.openfoam_cell_order(d),
                                  tbm.openfoam_cell_order(
                                      tbm.parse_blockmesh_dict(GRADED_DICT)))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "blockMeshDict")
        with open(path, "w") as f:
            f.write(GRADED_DICT)
        assert_general_equal(jbm.read_blockmesh(path), tbm.read_blockmesh(path))
    gt = tbm.build_blockmesh(tbm.parse_blockmesh_dict(BOX_DICT))
    with pytest.raises(ValueError):
        from deepflame_torch.mesh.facelist import ell_arrays
        ell_arrays(gt.owner, gt.neighbour, gt.n_cells, width=3)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_polymesh_round_trip_across_packages(writer):
    """One package writes the jet's polyMesh, the other reads it; both read
    meshes equal the blockMesh build."""
    text = jet_blockmesh_dict(4, JET_GRADING)
    raw = (tbm.build_blockmesh_raw(tbm.parse_blockmesh_dict(text))
           if writer == "port" else
           jbm.build_blockmesh_raw(jbm.parse_blockmesh_dict(text)))
    with tempfile.TemporaryDirectory() as tmp:
        (tpm if writer == "port" else jpm).write_polymesh(tmp, *raw)
        gj, gt = jpm.read_polymesh(tmp), tpm.read_polymesh(tmp)
    assert_general_equal(gj, gt)
    ref = tbm.build_blockmesh(tbm.parse_blockmesh_dict(text))
    np.testing.assert_allclose(gt.volumes, ref.volumes, rtol=1e-12)
    np.testing.assert_allclose(gt.centers, ref.centers, atol=1e-15)
