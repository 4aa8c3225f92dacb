"""The port's shift-plan meshes (mesh.facelist.from_structured, graded_box,
ShiftPlan) and the plan routes of ops/fv_facelist.py and ops/linsolve.py
against the JAX package, float64 on the CPU.

Meshes: a periodic box, a duct (fixed and zeroGradient walls), a 2D slab
with an empty axis, a box with an n = 1 cyclic axis, and graded boxes.
Arrays and the ShiftPlan must equal the JAX package's exactly (both build
them in host numpy, face for face). Plan gathers are exact; plan scatters,
interpolation, gradients and fluxes within 1e-12 of the largest magnitude
(only the order of the scatter sums may differ); the plan matvec equals the
same mesh's plan-less matvec and JAX's within 1e-12; a plan-mesh BiCGStab
and CG take JAX's iteration counts and agree within 1e-10.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflame_tpu.mesh as jmesh
from deepflame_tpu.mesh import facelist as jfl
from deepflame_tpu.ops import fv_facelist as jfv
from deepflame_tpu.ops.linsolve import solve_fvmatrix as j_solve

import deepflame_torch.mesh as tmesh
from deepflame_torch.mesh import facelist as tfl
from deepflame_torch.ops import fv_facelist as tfv
from deepflame_torch.ops.linsolve import solve_fvmatrix as t_solve
from test_torch_fv_facelist import close

t = lambda a: torch.as_tensor(np.asarray(a))


def _bcs(pkg, kinds):
    """FieldBCs from per-axis kind pairs of one package."""
    mk = dict(c=lambda: pkg.cyclic(), e=lambda: pkg.empty(),
              z=lambda: pkg.zero_gradient(),
              f=lambda: pkg.fixed_value(1.5), g=lambda: pkg.fixed_gradient(2.0),
              s=lambda: pkg.symmetry())
    return tuple((mk[lo](), mk[hi]()) for lo, hi in kinds)


# (cells, lengths, per-axis BC kinds)
BOXES = {
    "periodic": ((4, 3, 5), (1.0, 0.6, 0.5), ("cc", "cc", "cc")),
    "duct": ((5, 4, 3), (0.5, 0.2, 0.3), ("fz", "fg", "sz")),
    "2d_empty": ((6, 4, 1), (0.6, 0.4, 0.1), ("fz", "zz", "ee")),
    "n1_cyclic": ((4, 3, 1), (0.4, 0.3, 0.1), ("fz", "cc", "cc")),
}
GRADED = {
    "graded_duct": (np.array([0.0, 0.1, 0.25, 0.45, 0.7]),
                    np.array([0.0, 0.2, 0.3, 0.35]),
                    np.array([0.0, 0.1, 0.3]), ("fz", "zf", "zz")),
    "graded_cyclic": (np.array([0.0, 0.1, 0.25, 0.35, 0.45]),
                      np.array([0.0, 0.2, 0.3, 0.35, 0.55]),
                      np.array([0.0, 0.1]), ("cc", "fz", "ee")),
}


def pair(case):
    """(JAX mesh, port mesh) of one case."""
    if case in BOXES:
        cells, L, kinds = BOXES[case]
        mj = jmesh.StructuredMesh.box(L, cells)
        mt = tmesh.StructuredMesh.box(L, cells, device="cpu")
        return (jfl.from_structured(mj, _bcs(jmesh, kinds)),
                tfl.from_structured(mt, _bcs(tmesh, kinds), device="cpu"))
    xe, ye, ze, kinds = GRADED[case]
    return (jfl.graded_box(xe, ye, ze, _bcs(jmesh, kinds)),
            tfl.graded_box(xe, ye, ze, _bcs(tmesh, kinds), device="cpu"))


CASES = list(BOXES) + list(GRADED)


@pytest.fixture(scope="module", params=CASES)
def meshes(request):
    return pair(request.param)


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=what)


def test_plan_mesh_arrays_equal_jax(meshes):
    fj, ft = meshes
    assert fj.n_cells == ft.n_cells and fj.n_faces == ft.n_faces
    assert ft.plan is not None
    assert (fj.plan.shape, fj.plan.families) == (ft.plan.shape,
                                                 ft.plan.families)
    for k in ("owner", "neighbour", "mag_sf", "delta", "weights", "normal",
              "volumes", "centers", "ell_face", "ell_sign"):
        _eq(getattr(fj, k), getattr(ft, k), k)
    assert ft.k_no is None and ft.skew is None and fj.k_no is None
    assert len(fj.patches) == len(ft.patches)
    for pj, pt in zip(fj.patches, ft.patches):
        assert (pj.name, pj.kind, pj.n_axis) == (pt.name, pt.kind, pt.n_axis)
        for k in ("owner", "mag_sf", "delta", "a", "b", "normal"):
            _eq(getattr(pj, k), getattr(pt, k), f"{pj.name}.{k}")


def test_structured_face_maps_equal_jax():
    for case in BOXES:
        cells, L, kinds = BOXES[case]
        aj, fj_ = jfl.structured_face_maps(jmesh.StructuredMesh.box(L, cells),
                                           _bcs(jmesh, kinds))
        at, ft_ = tfl.structured_face_maps(
            tmesh.StructuredMesh.box(L, cells, device="cpu"),
            _bcs(tmesh, kinds))
        np.testing.assert_array_equal(fj_, ft_)
        for a, b in zip(aj, at):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


def test_per_face_bc_values_on_a_patch_slab():
    """A BC value given as a tensor over the patch slab (the structured
    jet's inlet profiles) lands face by face in the patch's C order."""
    mt = tmesh.StructuredMesh.box((0.4, 0.3, 0.2), (4, 3, 2), device="cpu")
    prof = torch.arange(6, dtype=torch.float64).reshape(1, 3, 2)
    bcs = ((tmesh.fixed_value(prof), tmesh.zero_gradient()),
           (tmesh.zero_gradient(),) * 2, (tmesh.zero_gradient(),) * 2)
    ft = tfl.from_structured(mt, bcs, device="cpu")
    lo = ft.patches[0]
    assert lo.name == "ax0_lo"
    np.testing.assert_array_equal(lo.b.numpy(), 2.0 * np.arange(6))
    np.testing.assert_array_equal(lo.owner.numpy(), np.arange(6))


def _fields(fj, seed=0, k=3):
    rng = np.random.default_rng(seed)
    n, nf = fj.n_cells, fj.n_faces
    return dict(x=rng.normal(size=n) + 2.0, X=rng.normal(size=(n, k)),
                U=rng.normal(size=(n, 3)), fo=rng.normal(size=nf),
                fn=rng.normal(size=nf), FK=rng.normal(size=(nf, k)),
                phi=rng.normal(size=nf),
                phi_b=[rng.normal(size=p.owner.shape[0]) for p in fj.patches],
                gam=rng.uniform(0.5, 2.0, nf),
                gam_b=[rng.uniform(0.5, 2.0, p.owner.shape[0])
                       for p in fj.patches],
                rho=rng.uniform(0.5, 1.5, n))


def test_plan_gathers_scatters_and_operators(meshes):
    """Plan gathers equal JAX's exactly; scatters, interpolation, Gauss
    gradients (single, batched, per-column BCs), face-normal flux, face
    gradient and divergence within 1e-12 of JAX and of the same mesh
    without its plan."""
    fj, ft = meshes
    f = _fields(fj)
    fn = dataclasses.replace(ft, plan=None)
    for x in (f["x"], f["X"]):
        _eq(fj.gather_own(jnp.asarray(x)), ft.gather_own(t(x)), "gather_own")
        _eq(fj.gather_nei(jnp.asarray(x)), ft.gather_nei(t(x)), "gather_nei")
    checks = [
        ("scatter_faces", lambda pk, m, a: m.scatter_faces(a(f["fo"]))),
        ("scatter_faces_k", lambda pk, m, a: m.scatter_faces(a(f["FK"]))),
        ("scatter_both", lambda pk, m, a: m.scatter_both(a(f["fo"]),
                                                         a(f["fn"]))),
        ("interp", lambda pk, m, a: pk.interpolate_fl(m, a(f["x"]))),
        ("interp_k", lambda pk, m, a: pk.interpolate_fl(m, a(f["X"]))),
        ("grad", lambda pk, m, a: pk.grad_fl(m, a(f["x"]))),
        ("grad_k", lambda pk, m, a: pk.grad_fl(m, a(f["X"]))),
        ("grad_multi", lambda pk, m, a: pk.grad_multi_fl([m, m, m],
                                                         a(f["U"]))),
        ("flux_normal", lambda pk, m, a: pk.flux_normal_fl(m, a(f["U"]))),
        ("face_grad", lambda pk, m, a: pk.face_grad_fl(m, a(f["x"]))),
        ("div", lambda pk, m, a: pk.div_flux_fl(m, a(f["phi"]),
                                                list(map(a, f["phi_b"])))),
        ("sngrad", lambda pk, m, a: pk.sngrad_fl(m, a(f["x"]))),
    ]
    for what, fn_ in checks:
        ref = fn_(jfv, fj, jnp.asarray)
        close(ref, fn_(tfv, ft, t), what=what)
        close(ref, fn_(tfv, fn, t), what=what + " (no plan)")


def _matrix(pk, m, f, a, X=None):
    x = a(f["x"]) if X is None else a(X)
    return (pk.fvm_ddt_fl(m, a(f["rho"]), a(f["rho"]), x, 2e-4)
            + pk.fvm_div_fl(m, a(f["phi"]), list(map(a, f["phi_b"])),
                            "limitedLinear", x_now=x)
            + pk.fvm_laplacian_fl(m, a(f["gam"]), list(map(a, f["gam_b"])),
                                  sign=-1.0))


def test_plan_matvec_equals_plain_and_jax(meshes):
    """FvMatrixFL.apply on a plan mesh (the lattice stencil) equals the
    plan-less apply and JAX's plan apply; the batched (leading-lane) apply
    equals the lane-by-lane JAX apply; plan_stencil(scale) folds the row
    scaling into every coefficient."""
    fj, ft = meshes
    f = _fields(fj)
    ej, et = _matrix(jfv, fj, f, jnp.asarray), _matrix(tfv, ft, f, t)
    en = dataclasses.replace(et, mesh=dataclasses.replace(ft, plan=None))
    close(ej.apply(jnp.asarray(f["U"][:, 0])), et.apply(t(f["U"][:, 0])))
    close(en.apply(t(f["U"][:, 0])), et.apply(t(f["U"][:, 0])))
    close(ej.H(jnp.asarray(f["x"])), et.H(t(f["x"])), what="H")
    # a batch of three lanes with their own fields
    Xs = f["U"].T + 2.0
    eb = _matrix(tfv, ft, f, t, X=Xs)
    out = eb.apply(t(Xs))
    for i in range(3):
        close(_matrix(jfv, fj, f, jnp.asarray, X=Xs[i]).apply(
            jnp.asarray(Xs[i])), out[i], what=f"lane {i}")
    s = np.random.default_rng(3).uniform(0.5, 2.0, fj.n_cells)
    diag_lat, terms = et.plan_stencil(scale=t(s))
    X = t(f["x"]).reshape(ft.plan.shape)
    close(s * np.asarray(ej.apply(jnp.asarray(f["x"]))),
          tfv.apply_stencil_lattice(X, diag_lat, terms).reshape(-1))


def test_n1_cyclic_axis_reads_the_cell_itself():
    """On an n = 1 cyclic axis both wrap neighbours are the cell: the
    lattice matvec adds (U + L) x there, as JAX's roll form does."""
    fj, ft = pair("n1_cyclic")
    f = _fields(fj)
    et = _matrix(tfv, ft, f, t)
    diag_lat, terms = et.plan_stencil()
    U, L = next((U, L) for ax, U, L in terms if ax == 2)
    assert float(U.abs().max()) > 0.0
    X = t(f["x"]).reshape(ft.plan.shape)
    only_z = tfv.apply_stencil_lattice(X, torch.zeros_like(diag_lat),
                                       tuple(tm for tm in terms
                                             if tm[0] == 2))
    close((U + L) * X, only_z, rtol=1e-15)


@pytest.mark.parametrize("case", ["duct", "2d_empty", "graded_cyclic"])
def test_plan_solve_matches_jax_iterations(case):
    """BiCGStab and CG on a plan mesh: JAX's iteration counts, solutions
    within 1e-10; the batched solve gives each lane its own count."""
    fj, ft = pair(case)
    f = _fields(fj)
    ej, et = _matrix(jfv, fj, f, jnp.asarray), _matrix(tfv, ft, f, t)
    rj = j_solve(ej, jnp.asarray(f["x"]), tol=1e-10, max_iter=200)
    rt = t_solve(et, t(f["x"]), tol=1e-10, max_iter=200)
    assert int(rj.iterations) == int(rt.iterations) > 0
    close(rj.x, rt.x, rtol=1e-10)
    lj = (jfv.fvm_source_implicit_fl(fj, jnp.asarray(f["rho"]) / 1e-3)
          + jfv.fvm_laplacian_fl(fj, jnp.asarray(f["gam"]),
                                 list(map(jnp.asarray, f["gam_b"])),
                                 sign=-1.0)).with_source(jnp.asarray(f["x"]))
    lt = (tfv.fvm_source_implicit_fl(ft, t(f["rho"]) / 1e-3)
          + tfv.fvm_laplacian_fl(ft, t(f["gam"]), list(map(t, f["gam_b"])),
                                 sign=-1.0)).with_source(t(f["x"]))
    rj = j_solve(lj, jnp.zeros(fj.n_cells), symmetric=True, tol=1e-12,
                 max_iter=200)
    rt = t_solve(lt, torch.zeros(ft.n_cells, dtype=torch.float64),
                 symmetric=True, tol=1e-12, max_iter=200)
    assert int(rj.iterations) == int(rt.iterations) > 0
    close(rj.x, rt.x, rtol=1e-10)
    Xs = f["U"].T + 2.0
    eb = _matrix(tfv, ft, f, t, X=Xs)
    rb = t_solve(eb, t(Xs), tol=1e-10, max_iter=200)
    for i in range(3):
        ri = j_solve(_matrix(jfv, fj, f, jnp.asarray, X=Xs[i]),
                     jnp.asarray(Xs[i]), tol=1e-10, max_iter=200)
        assert int(ri.iterations) == int(rb.iterations[i])
        close(ri.x, rb.x[i], rtol=1e-10)
