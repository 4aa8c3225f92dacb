"""The BC form of the Helmholtz kernel (ops.kernels.helmholtz7_apply_bc):
the ghosts computed from the pressure BCs' ghost rule in place of a padded
copy. Its plain version (what CPU tensors take) against the JAX package's
Pallas kernel in interpret mode on JAX's own padded field; against the
padded form on every multigrid level; and the pressure CG and the V-cycle,
which must not pad their iterate where every ghost factor is a number.
The card's tests of the kernel itself are in tests/test_torch_kernels.py
(marked gpu)."""
import dataclasses

import numpy as np
import pytest
import torch

import deepflame_torch.mesh as tm
import deepflame_torch.ops.multigrid as mg
import deepflame_torch.solvers.low_mach as low_mach
from deepflame_torch.cases import jet_flame_3d_les
from deepflame_torch.mesh.structured import BC
from deepflame_torch.ops import kernels as K

MECH = "tests/data/h2_air_9sp.json"
t = lambda a: torch.as_tensor(np.asarray(a))


def _bc_sets(pkg):
    """name: (cells, lengths, FieldBCs in package `pkg`)."""
    zg, cyc = pkg.zero_gradient(), pkg.cyclic()
    return {
        "cyclic": ((8, 6, 4), (1.0, 0.5, 0.25), ((cyc, cyc),) * 3),
        # the jets' pressure (cases.jet_flame_3d_les)
        "jet": ((12, 6, 6), (0.06, 0.03, 0.03),
                ((zg, pkg.fixed_value(101325.0)), (zg, zg), (zg, zg))),
        "empty_z": ((10, 8, 1), (0.12, 0.06, 0.0075),
                    ((zg, pkg.fixed_value(1.0)), (zg, zg),
                     (pkg.empty(), pkg.empty()))),
        "walls": ((8, 6, 5), (1.0, 0.8, 0.6),
                  ((pkg.symmetry(), pkg.fixed_gradient(3.0)),
                   (pkg.symmetry(negate=True), zg),
                   (pkg.fixed_value(2.0), pkg.symmetry(negate=True)))),
        # an axis of two cells, which multigrid halves to one
        "two_cells": ((8, 2, 6), (1.0, 0.25, 0.75),
                      ((zg, zg), (pkg.fixed_value(1.0), pkg.fixed_value(0.5)),
                       (cyc, cyc))),
    }


@pytest.mark.parametrize("case", list(_bc_sets(tm)))
def test_bc_form_plain_matches_jax(case):
    """The BC form's plain version on x against helmholtz_apply (Pallas,
    interpret mode) on JAX's pad_field(x, homogeneous=True), float64,
    1e-12 relative (test_torch_kernels' tolerance for the padded form)."""
    import jax.numpy as jnp
    import deepflame_tpu.mesh as jm
    from deepflame_tpu.ops.pallas_kernels import helmholtz_apply
    shape, lengths, bcs_j = _bc_sets(jm)[case]
    bcs_t = _bc_sets(tm)[case][2]
    rng = np.random.default_rng(7)
    nx, ny, nz = shape
    gamma = (rng.uniform(0.5, 2.0, (nx + 1, ny, nz)),
             rng.uniform(0.5, 2.0, (nx, ny + 1, nz)),
             rng.uniform(0.5, 2.0, (nx, ny, nz + 1)))
    d, x = rng.uniform(0.1, 1.0, shape), rng.normal(size=shape)
    mj = jm.StructuredMesh.box(lengths, shape)
    mt = tm.StructuredMesh.box(lengths, shape, device="cpu")
    ref = np.asarray(helmholtz_apply(
        jm.pad_field(jnp.asarray(x), bcs_j, mj, homogeneous=True),
        tuple(map(jnp.asarray, gamma)), jnp.asarray(d), mj.spacing,
        interpret=True))
    rule = K.ghost_rule(bcs_t, mt)
    assert rule is not None
    before = dict(K.launches)
    out = K.helmholtz7_apply_bc(t(x), tuple(map(t, gamma)), t(d), mt.spacing,
                                rule)
    assert K.launches == before          # CPU tensors take the plain version
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


def test_ghost_rule_factors():
    """The rule holds pad_field's homogeneous factors: -1 for fixedValue,
    inletOutlet and symmetryNegate, +1 for the zero-gradient kinds and
    fixedGradient; None for a per-face affine factor; processor raises, and
    so does a cyclic side paired with another kind."""
    m = tm.StructuredMesh.box((1.0, 1.0, 1.0), (4, 4, 4), device="cpu")
    zg = tm.zero_gradient()
    rule = K.ghost_rule(((tm.fixed_value(3.0), BC("inletOutlet", 1.0)),
                         (tm.symmetry(negate=True), tm.fixed_gradient(2.0)),
                         (tm.empty(), BC("extrapolated"))), m)
    assert rule == K.GhostRule((False, False, False),
                               ((-1.0, -1.0), (-1.0, 1.0), (1.0, 1.0)))
    assert K.ghost_rule(((tm.cyclic(), tm.cyclic()), (zg, zg),
                         (BC("affine", (0.5, 1.0)), zg)), m) == K.GhostRule(
        (True, False, False), ((1.0, 1.0), (1.0, 1.0), (0.5, 1.0)))
    per_face = BC("affine", (torch.full((1, 4, 4), -1.0), 0.0))
    assert K.ghost_rule(((per_face, zg), (zg, zg), (zg, zg)), m) is None
    with pytest.raises(NotImplementedError):
        K.ghost_rule(((BC("processor"), zg), (zg, zg), (zg, zg)), m)
    with pytest.raises(ValueError):
        K.ghost_rule(((tm.cyclic(), zg), (zg, zg), (zg, zg)), m)


def test_bc_form_matches_padded_form_on_mg_levels():
    """On every level of mg_levels of a 16 x 8 x 8 jet mesh (the jet's
    pressure BCs), the BC form equals the padded form to round-off."""
    shape, lengths, bcs = _bc_sets(tm)["jet"]
    shape = (16, 8, 8)
    mesh = tm.StructuredMesh.box(lengths, shape, device="cpu")
    rng = np.random.default_rng(3)
    nx, ny, nz = shape
    gamma = tuple(t(rng.uniform(0.5, 2.0, s)) for s in
                  ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)))
    levels = mg.mg_levels(mesh, t(rng.uniform(1.0, 3.0, shape)), gamma)
    assert [lv[0].shape for lv in levels] == [(16, 8, 8), (8, 4, 4),
                                              (4, 2, 2)]
    for m, g, d, _ in levels:
        x = t(rng.normal(size=m.shape))
        out = K.helmholtz7_apply_bc(x, g, d, m.spacing, K.ghost_rule(bcs, m))
        ref = K.helmholtz7_apply(tm.pad_field(x, bcs, m, homogeneous=True),
                                 g, d, m.spacing)
        torch.testing.assert_close(out, ref, rtol=0,
                                   atol=1e-14 * float(ref.abs().max()))


@pytest.mark.parametrize("p_precond", ["jacobi", "mg"])
def test_pressure_matvecs_do_not_pad(monkeypatch, p_precond):
    """One step of the 8 x 4 x 4 jet (its pressure BCs: zeroGradient and
    fixedValue, every ghost factor a number): the pressure CG's matvec,
    and with multigrid every level's, run the BC form, and nothing pads an
    iterate (pad_field with homogeneous=True is never called)."""
    padded, shapes = [], []
    for module in (K, low_mach):
        def pad_counted(f, bcs, mesh, homogeneous=False, bc_only=False,
                        _pad=module.pad_field):
            if homogeneous:
                padded.append(tuple(f.shape))
            return _pad(f, bcs, mesh, homogeneous, bc_only)
        monkeypatch.setattr(module, "pad_field", pad_counted)
    bc_form = K.helmholtz7_apply_bc

    def bc_counted(x, *a):
        shapes.append(tuple(x.shape))
        return bc_form(x, *a)
    monkeypatch.setattr(K, "helmholtz7_apply_bc", bc_counted)
    solver, state = jet_flame_3d_les(MECH, n=4, dtype=torch.float64,
                                     device="cpu")
    solver = dataclasses.replace(solver, config=dataclasses.replace(
        solver.config, p_precond=p_precond))
    new, diag = solver.step(state, 5e-7)
    assert bool(torch.isfinite(new.p).all())
    assert int(diag["iters_p"]) > 0
    assert padded == []
    levels = {(8, 4, 4)} | ({(4, 2, 2)} if p_precond == "mg" else set())
    assert set(shapes) == levels
