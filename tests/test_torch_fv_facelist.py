"""The port's face-list FV operators (ops/fv_facelist.py) and the ELL SpMV
plain version against the JAX package, float64 on the CPU.

Meshes: the graded blockMesh box, and the sheared and bent-shear (skewed)
hex meshes of tests/test_torch_facelist_mesh.py (non-orthogonal, with tilted
fixedValue walls), each with mixed BCs. Tolerance: 1e-12 of the largest
magnitude of each result; both packages evaluate the same expressions, and
only the order of the ELL row sums and of the patch segment sums may differ.
The batched matrix builders (leading species axis) are held lane by lane
against the JAX builders on each lane's own fields.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflame_tpu.ops import fv_facelist as jfv
from deepflame_tpu.ops.linsolve import solve_fvmatrix as j_solve
from deepflame_tpu.ops.pallas_kernels import ell_matvec as j_ell_matvec

from deepflame_torch.ops import fv_facelist as tfv
from deepflame_torch.ops import kernels as K
from deepflame_torch.ops.linsolve import solve_fvmatrix as t_solve
from test_torch_facelist_mesh import fl_pair

MESHES = ["graded", "sheared", "skewed"]
RTOL = 1e-12
t = lambda a: torch.as_tensor(np.asarray(a))


def close(a, b, rtol=RTOL, what=""):
    """|a - b| <= rtol max|a|, a from JAX, b from the port."""
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(np.abs(a).max(initial=0.0), 1e-300)
    assert np.abs(a - b).max(initial=0.0) <= rtol * scale, \
        (what, np.abs(a - b).max() / scale)


def fields(fj, seed=0, k=3):
    """Seeded cell fields: x (n,), X (n, k), U (n, 3), and face fields."""
    rng = np.random.default_rng(seed)
    n, nf = fj.n_cells, fj.n_faces
    return dict(x=rng.normal(size=n) + 2.0, X=rng.normal(size=(n, k)),
                U=rng.normal(size=(n, 3)),
                gam=rng.uniform(0.5, 2.0, nf),
                gam_b=[rng.uniform(0.5, 2.0, p.owner.shape[0])
                       for p in fj.patches],
                phi=rng.normal(size=nf),
                phi_b=[rng.normal(size=p.owner.shape[0]) for p in fj.patches],
                rho=rng.uniform(0.5, 1.5, n))


@pytest.fixture(scope="module", params=MESHES)
def pair(request):
    fj, ft = fl_pair(request.param)
    return fj, ft, fields(fj)


def test_explicit_operators_match_jax(pair):
    fj, ft, f = pair
    x, X, U = f["x"], f["X"], f["U"]
    for name, a, b in (
            ("interpolate", jfv.interpolate_fl(fj, x),
             tfv.interpolate_fl(ft, t(x))),
            ("interpolate batched", jfv.interpolate_fl(fj, X),
             tfv.interpolate_fl(ft, t(X))),
            ("flux_normal", jfv.flux_normal_fl(fj, U),
             tfv.flux_normal_fl(ft, t(U))),
            ("sngrad", jfv.sngrad_fl(fj, X), tfv.sngrad_fl(ft, t(X))),
            ("grad", jfv.grad_fl(fj, x), tfv.grad_fl(ft, t(x))),
            ("grad batched", jfv.grad_fl(fj, X), tfv.grad_fl(ft, t(X))),
            ("grad_multi", jfv.grad_multi_fl([fj] * 3, U),
             tfv.grad_multi_fl([ft] * 3, t(U))),
            ("div_flux", jfv.div_flux_fl(fj, f["phi"], f["phi_b"]),
             tfv.div_flux_fl(ft, t(f["phi"]), list(map(t, f["phi_b"])))),
            ("laplacian_explicit",
             jfv.laplacian_explicit_fl(fj, f["gam"], x, f["gam_b"]),
             tfv.laplacian_explicit_fl(ft, t(f["gam"]), t(x),
                                       list(map(t, f["gam_b"])))),
            ("face_grad", jfv.face_grad_fl(fj, x), tfv.face_grad_fl(ft, t(x))),
            ("nonortho_corr",
             jfv.laplacian_nonortho_corr_fl(fj, f["gam"], x,
                                            gamma_b=f["gam_b"]),
             tfv.laplacian_nonortho_corr_fl(ft, t(f["gam"]), t(x),
                                            gamma_b=list(map(t, f["gam_b"])))),
            ("interpolate_skew", jfv.interpolate_skew_fl(fj, x),
             tfv.interpolate_skew_fl(ft, t(x)))):
        close(a, b, what=name)
    for pj, pt in zip(fj.patches, ft.patches):
        close(jfv._boundary_face_value(pj, X),
              tfv._boundary_face_value(pt, t(X)), what=pj.name)
        close(jfv._boundary_sngrad(pj, X), tfv._boundary_sngrad(pt, t(X)),
              what=pj.name)
    for patches in (None, "per-component"):
        pu_j = None if patches is None else [fj.patches] * 3
        pu_t = None if patches is None else [ft.patches] * 3
        phi_j, phib_j = jfv.flux_of_fl(fj, U, pu_j)
        phi_t, phib_t = tfv.flux_of_fl(ft, t(U), pu_t)
        close(phi_j, phi_t)
        for a, b in zip(phib_j, phib_t):
            close(a, b, what="flux_of_fl boundary")


def _matrix_equal(ej, et, x, what):
    for k in ("diag_c", "lower", "upper", "source"):
        close(getattr(ej, k), getattr(et, k), what=f"{what}.{k}")
    close(ej.apply(x), et.apply(t(x)), what=f"{what}.apply")
    close(ej.H(x), et.H(t(x)), what=f"{what}.H")


@pytest.mark.parametrize("scheme", ["upwind", "linear", "limitedLinear",
                                    "vanLeer"])
def test_fvm_div_matches_jax(pair, scheme):
    fj, ft, f = pair
    ej = jfv.fvm_div_fl(fj, f["phi"], f["phi_b"], scheme, x_now=f["x"])
    et = tfv.fvm_div_fl(ft, t(f["phi"]), list(map(t, f["phi_b"])), scheme,
                        x_now=t(f["x"]))
    _matrix_equal(ej, et, f["x"], scheme)


def test_matrix_terms_match_jax(pair):
    """ddt, laplacian (plain and corrected), implicit source, their sum with
    an added source; rhs, diag, apply, H and the ELL form."""
    fj, ft, f = pair
    x, rho, dt = f["x"], f["rho"], 1e-3
    gb_t = list(map(t, f["gam_b"]))
    ej = (jfv.fvm_ddt_fl(fj, rho, 0.9 * rho, x, dt)
          + jfv.fvm_laplacian_corrected_fl(fj, f["gam"], f["gam_b"], x,
                                           sign=-1.0)
          + jfv.fvm_source_implicit_fl(fj, rho)).with_source(x)
    et = (tfv.fvm_ddt_fl(ft, t(rho), t(0.9 * rho), t(x), dt)
          + tfv.fvm_laplacian_corrected_fl(ft, t(f["gam"]), gb_t, t(x),
                                           sign=-1.0)
          + tfv.fvm_source_implicit_fl(ft, t(rho))).with_source(t(x))
    _matrix_equal(ej, et, x, "sum")
    close(ej.rhs(), et.rhs())
    close(ej.diag(), et.diag())
    lj = jfv.fvm_laplacian_fl(fj, f["gam"], [0.3] * len(fj.patches), sign=-1.0)
    lt = tfv.fvm_laplacian_fl(ft, t(f["gam"]), [0.3] * len(ft.patches),
                              sign=-1.0)
    _matrix_equal(lj, lt, x, "laplacian")
    # ELL form: coefficients, the plain matvec, JAX's apply and its Pallas
    # kernel in interpret mode
    nbr_j, coef_j = lj.ell()
    nbr_t, coef_t = lt.ell(conn=ft.ell_connectivity())
    np.testing.assert_array_equal(np.asarray(nbr_j), nbr_t.numpy())
    close(coef_j, coef_t)
    ref = lj.apply(x)
    before = dict(K.launches)
    close(ref, lt.apply_ell(t(x), nbr_t, coef_t), what="apply_ell")
    close(ref, K.ell_matvec_plain(t(x), lt.diag_c, nbr_t, coef_t))
    close(j_ell_matvec(jnp.asarray(x), lj.diag_c, nbr_j, coef_j, block=64,
                       interpret=True),
          K.ell_matvec(t(x), lt.diag_c, nbr_t, coef_t), what="pallas")
    assert K.launches == before       # CPU tensors take the plain version


def test_tvd_limiters_match_jax():
    r = np.linspace(-3.0, 5.0, 81)
    for scheme in ("limitedLinear", "vanLeer", "minmod", "MUSCL", "superBee",
                   "QUICK", "vanAlbada", "OSPRE"):
        close(jfv._tvd_limiter(scheme, jnp.asarray(r), 0.7),
              tfv._tvd_limiter(scheme, t(r), 0.7), rtol=1e-15, what=scheme)
    with pytest.raises(ValueError):
        tfv._tvd_limiter("nope", t(r))


def test_batched_matrix_and_solve_match_jax_lanes(pair):
    """A batch of S fields with leading-axis coefficients (the species
    solve's layout) equals the JAX matrices built lane by lane; the batched
    BiCGStab gives each lane JAX's solution and iteration count."""
    fj, ft, f = pair
    S, dt = 3, 2e-4
    rng = np.random.default_rng(4)
    Xs = rng.uniform(0.1, 1.0, (S, fj.n_cells))
    gams = rng.uniform(0.5, 2.0, (S, fj.n_faces))
    gbs = [rng.uniform(0.5, 2.0, (S, p.owner.shape[0])) for p in fj.patches]
    et = (tfv.fvm_ddt_fl(ft, t(f["rho"]), t(f["rho"]), t(Xs), dt)
          + tfv.fvm_div_fl(ft, t(f["phi"]), list(map(t, f["phi_b"])),
                           "limitedLinear", x_now=t(Xs))
          + tfv.fvm_laplacian_corrected_fl(ft, t(gams), list(map(t, gbs)),
                                           t(Xs), sign=-1.0))
    rt = t_solve(et, t(Xs), tol=1e-10, max_iter=100)
    for i in range(S):
        ej = (jfv.fvm_ddt_fl(fj, f["rho"], f["rho"], Xs[i], dt)
              + jfv.fvm_div_fl(fj, f["phi"], f["phi_b"], "limitedLinear",
                               x_now=Xs[i])
              + jfv.fvm_laplacian_corrected_fl(fj, gams[i],
                                               [g[i] for g in gbs], Xs[i],
                                               sign=-1.0))
        for k in ("diag_c", "source"):
            close(np.broadcast_to(getattr(ej, k), (fj.n_cells,)),
                  torch.broadcast_to(getattr(et, k), (S, fj.n_cells))[i],
                  what=k)
        close(ej.apply(Xs[i]), et.apply(t(Xs))[i])
        rj = j_solve(ej, jnp.asarray(Xs[i]), tol=1e-10, max_iter=100)
        assert int(rj.iterations) == int(rt.iterations[i])
        close(rj.x, rt.x[i], rtol=1e-10)
