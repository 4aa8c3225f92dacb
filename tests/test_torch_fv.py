"""PyTorch port of the FV operators, Krylov solvers, energy BCs and LES
models against the JAX package (float64, CPU), including non-periodic
boundary conditions the flagship case does not use."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import deepflame_tpu.mesh as jm
import deepflame_tpu.ops.fv as jfv
from deepflame_tpu.chemistry import load_mechanism, make_thermo
from deepflame_tpu.mesh.energy_bcs import resolve_energy_bcs
from deepflame_tpu.ops.linsolve import solve_fvmatrix
from deepflame_tpu.turbulence.les import LESModel

import deepflame_torch.mesh as tm
import deepflame_torch.ops.fv as tfv
from deepflame_torch.chemistry import load_mechanism as t_load, make_thermo as t_thermo
from deepflame_torch.mesh.energy_bcs import resolve_energy_bcs as t_resolve
from deepflame_torch.ops.linsolve import solve_fvmatrix as t_solve
from deepflame_torch.turbulence.les import LESModel as TLESModel

SHAPE = (8, 6, 5)
LENGTHS = (1.0, 0.6, 0.4)
t = lambda a: torch.as_tensor(np.asarray(a))


def _bcs(pkg):
    """x: fixedValue / zeroGradient, y: cyclic, z: fixedGradient / fixedValue."""
    return ((pkg.fixed_value(0.3), pkg.zero_gradient()),
            (pkg.cyclic(), pkg.cyclic()),
            (pkg.fixed_gradient(-2.0), pkg.fixed_value(1.2)))


def _meshes():
    return (jm.StructuredMesh.box(LENGTHS, SHAPE),
            tm.StructuredMesh.box(LENGTHS, SHAPE, device="cpu"))


def _close(a, b, rtol=1e-12):
    a = np.asarray(a)
    np.testing.assert_allclose(b.numpy(), a, rtol=0,
                               atol=rtol * max(np.abs(a).max(), 1e-300))


@pytest.mark.parametrize("scheme", ["upwind", "linear", "limitedLinear",
                                    "limitedLinear01", "vanLeer"])
def test_fvmatrix_stencil_rhs_and_solve_match_jax(scheme):
    """ddt + div(scheme) + laplacian with mixed BCs: folded stencil, right-hand
    side (boundary part included), matvec, and the BiCGStab solve with its
    iteration count. Batched over 2 fields on the port side."""
    rng = np.random.default_rng(0)
    mj, mt = _meshes()
    bj, bt = _bcs(jm), _bcs(tm)
    rho = rng.uniform(0.5, 1.5, SHAPE)
    phi = tuple(rng.normal(size=s) for s in ((9, 6, 5), (8, 7, 5), (8, 6, 6)))
    gam = tuple(rng.uniform(0.01, 0.1, s.shape) for s in phi)
    x_old, x_now = rng.uniform(0, 1, (2, 2) + SHAPE)
    dt = 1e-2

    def eqn_j(k):
        return (jfv.fvm_ddt(jnp.asarray(rho), x_old[k], dt, mj, bj)
                + jfv.fvm_div(phi, jnp.asarray(x_now[k]), mj, bj, scheme)
                + jfv.fvm_laplacian(gam, mj, bj, sign=-1.0))

    eq_t = (tfv.fvm_ddt(t(rho), t(x_old), dt, mt, bt)
            + tfv.fvm_div(tuple(map(t, phi)), t(x_now), mt, bt, scheme)
            + tfv.fvm_laplacian(tuple(map(t, gam)), mt, bt, sign=-1.0))
    D, lo, hi = eq_t.stencil()
    for k in range(2):
        ej = eqn_j(k)
        Dj, loj, hij = ej.stencil()
        _close(Dj, D[k])
        for ax in range(3):
            _close(loj[ax], lo[ax][k])
            _close(hij[ax], hi[ax][k])
        _close(ej.rhs(), eq_t.rhs()[k])
        _close(ej.apply(jnp.asarray(x_now[k])), eq_t.apply(t(x_now))[k])
    res_t = t_solve(eq_t, t(x_now), tol=1e-10, max_iter=200)
    for k in range(2):
        res_j = solve_fvmatrix(eqn_j(k), jnp.asarray(x_now[k]), tol=1e-10,
                               max_iter=200)
        assert int(res_j.iterations) == int(res_t.iterations[k])
        _close(res_j.x, res_t.x[k], rtol=1e-10)


def test_explicit_operators_match_jax():
    rng = np.random.default_rng(1)
    mj, mt = _meshes()
    bj, bt = _bcs(jm), _bcs(tm)
    f = rng.normal(size=SHAPE)
    phi = tuple(rng.normal(size=s) for s in ((9, 6, 5), (8, 7, 5), (8, 6, 6)))
    _close(jfv.grad(jnp.asarray(f), bj, mj), tfv.grad(t(f), bt, mt))
    _close(jfv.div_flux(phi, mj), tfv.div_flux(tuple(map(t, phi)), mt))
    _close(jfv.div_explicit(phi, jnp.asarray(f), bj, mj, "limitedLinear"),
           tfv.div_explicit(tuple(map(t, phi)), t(f), bt, mt, "limitedLinear"))
    Pj, Pt = jm.pad_field(jnp.asarray(f), bj, mj), tm.pad_field(t(f), bt, mt)
    _close(Pj, Pt)
    for ax in range(3):
        _close(jfv.interpolate_cubic(Pj, ax, bj),
               tfv.interpolate_cubic(Pt, ax, bt))
    lim_j = jfv.multivariate_limiter([Pj, Pj * 0.5], phi, mj, [bj, bj],
                                     bounded01=(True, False))
    lim_t = tfv.multivariate_limiter([Pt, Pt * 0.5], tuple(map(t, phi)), mt,
                                     [bt, bt], bounded01=(True, False))
    for a, b in zip(lim_j, lim_t):
        _close(a, b)


def test_energy_bcs_match_jax():
    """fixedEnergy, gradientEnergy and mixedEnergy resolved onto ha."""
    import os
    path = os.path.join(os.path.dirname(__file__), "data", "h2_air_9sp.json")
    thj = make_thermo(load_mechanism(path))
    tht = t_thermo(t_load(path, device="cpu"))
    mj, mt = _meshes()
    rng = np.random.default_rng(2)
    T = rng.uniform(300.0, 1500.0, SHAPE)
    Y = rng.dirichlet(np.ones(9), SHAPE).transpose(3, 0, 1, 2)
    cyc = lambda pkg: (pkg.cyclic(), pkg.cyclic())
    hj = ((jm.fixed_energy(900.0), jm.gradient_energy(50.0)), cyc(jm),
          (jm.mixed_energy(700.0, -20.0, 0.3), jm.zero_gradient()))
    ht = ((tm.fixed_energy(900.0), tm.gradient_energy(50.0)), cyc(tm),
          (tm.mixed_energy(700.0, -20.0, 0.3), tm.zero_gradient()))
    ha = rng.normal(size=SHAPE) * 1e5
    Pj = jm.pad_field(jnp.asarray(ha), resolve_energy_bcs(hj, T, Y, thj, mj),
                      mj)
    Pt = tm.pad_field(t(ha), t_resolve(ht, t(T), t(Y), tht, mt), mt)
    _close(Pj, Pt)


def test_eig3_sym_matches_numpy():
    """The analytic symmetric 3x3 eigenvalues of the Sigma model against
    numpy.linalg.eigvalsh, descending, on random symmetric PSD fields."""
    from deepflame_torch.turbulence.les import _eig3_sym
    rng = np.random.default_rng(4)
    g = rng.normal(size=(64, 3, 3))
    A = np.einsum("nki,nkj->nij", g, g)
    ref = np.linalg.eigvalsh(A)[:, ::-1]
    out = torch.stack(_eig3_sym(t(np.moveaxis(A, 0, -1)))).numpy().T
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("kind", ["Smagorinsky", "WALE", "Sigma",
                                  "dynamicSmagorinsky"])
def test_les_mu_t_matches_jax(kind):
    rng = np.random.default_rng(3)
    mj, mt = _meshes()
    b = ((jm.cyclic(), jm.cyclic()),) * 3
    bt = ((tm.cyclic(), tm.cyclic()),) * 3
    U = rng.normal(size=(3,) + SHAPE)
    rho = rng.uniform(0.5, 1.5, SHAPE)
    mu_j = LESModel(kind=kind).mu_t(jnp.asarray(rho), jnp.asarray(U),
                                    (b, b, b), mj)
    mu_t = TLESModel(kind=kind).mu_t(t(rho), t(U), (bt, bt, bt), mt)
    _close(mu_j, mu_t, rtol=1e-11)


def test_dynamic_smagorinsky_non_periodic_matches_jax():
    """The dynamic model's test filter pads every field with velocity
    component 0's BCs (fixedValue, zeroGradient, cyclic, fixedGradient
    sides), as the JAX package's does; and it refuses face-list meshes."""
    rng = np.random.default_rng(5)
    mj, mt = _meshes()
    U = rng.normal(size=(3,) + SHAPE)
    rho = rng.uniform(0.5, 1.5, SHAPE)
    bj, bt = _bcs(jm), _bcs(tm)
    mu_j = LESModel(kind="dynamicSmagorinsky").mu_t(
        jnp.asarray(rho), jnp.asarray(U), (bj, bj, bj), mj)
    model = TLESModel(kind="dynamicSmagorinsky")
    mu_t = model.mu_t(t(rho), t(U), (bt, bt, bt), mt)
    _close(mu_j, mu_t, rtol=1e-11)
    assert float(mu_t.max()) > 0.0
    with pytest.raises(ValueError, match="structured"):
        model.mu_t_fl(None, None, None, None)


def _stacked_bcs(pkg, k):
    """Lane k's BCs: the kinds and values differ between lanes on x and z."""
    zg = pkg.zero_gradient()
    x = ((pkg.fixed_value(0.3), zg), (zg, pkg.fixed_gradient(1.5)))[k]
    z = ((pkg.fixed_gradient(-2.0), pkg.fixed_value(1.2)),
         (pkg.symmetry(True), pkg.fixed_value(-0.4)))[k]
    return (x, (pkg.cyclic(), pkg.cyclic()), z)


@pytest.mark.parametrize("case", ["stencil", "stacked-bcs", "probes"])
def test_fvmatrix_diag_H_residual_match_jax(case):
    """diag, H and residual of ddt + div(upwind) - laplacian, and the
    difference of two FvMatrix, per lane against the JAX package's. The port
    reads diag from the folded stencil ("stencil"), with per-lane ghost
    coefficients where the two lanes' BCs are stacked ("stacked-bcs"), or
    from JAX's coloring probes where the Laplacian's gamma is a scalar and
    so has no stencil ("probes")."""
    rng = np.random.default_rng(6)
    mj, mt = _meshes()
    rho = rng.uniform(0.5, 1.5, SHAPE)
    phi = tuple(rng.normal(size=s) for s in ((9, 6, 5), (8, 7, 5), (8, 6, 6)))
    gam = (tuple(rng.uniform(0.01, 0.1, p.shape) for p in phi)
           if case != "probes" else 0.05)
    x_old, x_now = rng.uniform(0, 1, (2, 2) + SHAPE)
    dt = 1e-2
    arr_t = (lambda g: tuple(map(t, g))) if case != "probes" else (lambda g: g)

    def build(pkg, fv, bcs, x_o, x_n, arr, g):
        m = mj if pkg is jm else mt
        eqn = (fv.fvm_ddt(arr(rho), x_o, dt, m, bcs)
               + fv.fvm_div(tuple(map(arr, phi)), x_n, m, bcs, "upwind"))
        if case == "probes":
            # JAX's __sub__ takes only terms that have a stencil
            return eqn + fv.fvm_laplacian(g, m, bcs, sign=-1.0)
        return eqn - fv.fvm_laplacian(g, m, bcs)

    if case == "stacked-bcs":
        bcs_t = tm.structured.stack_bcs([_stacked_bcs(tm, k) for k in (0, 1)],
                                        mt, torch.float64)
        assert bcs_t[0][0].kind == "affine"
    else:
        bcs_t = _bcs(tm)
    eq_t = build(tm, tfv, bcs_t, t(x_old), t(x_now), t, arr_t(gam))
    if case == "probes":
        assert eq_t.stencil() is None
    x = rng.normal(size=(2,) + SHAPE)
    d_t, H_t, r_t = eq_t.diag(), eq_t.H(t(x)), eq_t.residual(t(x))
    for k in range(2):
        bj = _stacked_bcs(jm, k) if case == "stacked-bcs" else _bcs(jm)
        ej = build(jm, jfv, bj, x_old[k], jnp.asarray(x_now[k]), jnp.asarray,
                   gam)
        _close(ej.diag(), d_t[k])
        _close(ej.H(jnp.asarray(x[k])), H_t[k], rtol=1e-11)
        _close(ej.residual(jnp.asarray(x[k])), r_t[k], rtol=1e-11)
        _close(ej.rhs(), eq_t.rhs()[k])


def test_explicit_helpers_match_jax():
    """flux_of, laplacian_explicit (per-axis face gamma and a scalar) and
    snGrad_boundary on mixed BCs."""
    rng = np.random.default_rng(7)
    mj, mt = _meshes()
    bj, bt = _bcs(jm), _bcs(tm)
    f = rng.normal(size=SHAPE)
    rho_u = rng.normal(size=(3,) + SHAPE)
    gam = tuple(rng.uniform(0.01, 0.1, s) for s in
                ((9, 6, 5), (8, 7, 5), (8, 6, 6)))
    for a, b in zip(jfv.flux_of(jnp.asarray(rho_u), (bj, bj, bj), mj),
                    tfv.flux_of(t(rho_u), (bt, bt, bt), mt)):
        _close(a, b)
    for gj, gt in ((gam, tuple(map(t, gam))), (0.07, 0.07)):
        _close(jfv.laplacian_explicit(gj, jnp.asarray(f), bj, mj),
               tfv.laplacian_explicit(gt, t(f), bt, mt))
    sj = jfv.snGrad_boundary(jnp.asarray(f), bj, mj)
    st = tfv.snGrad_boundary(t(f), bt, mt)
    assert sorted(sj) == sorted(st)
    for key in sj:
        _close(sj[key], st[key])
