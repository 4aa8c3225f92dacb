"""The port's geometric multigrid preconditioner (ops/multigrid.py) against
the JAX package's (float64, CPU): one V-cycle on a seeded residual, and the
iteration counts of multigrid-preconditioned CG on tests/test_multigrid.py's
two cases. The port's level matvec is the Helmholtz kernel's plain version
here, the JAX package's the padded FvMatrix terms: the same operator up to
round-off."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflame_tpu.mesh as jm
from deepflame_tpu.ops.fv import fvm_laplacian as j_lap
from deepflame_tpu.ops.fv import fvm_source_implicit as j_sp
from deepflame_tpu.ops.linsolve import cg as j_cg
from deepflame_tpu.ops.multigrid import make_mg_preconditioner as j_mg

import deepflame_torch.mesh as tm
from deepflame_torch.ops import kernels as K
from deepflame_torch.ops.fv import fvm_laplacian, fvm_source_implicit
from deepflame_torch.ops.linsolve import cg
from deepflame_torch.ops.multigrid import make_mg_preconditioner, mg_levels

t = lambda a: torch.as_tensor(np.asarray(a))


def _bcs(pkg):
    """x: fixedValue / zeroGradient, y: zeroGradient / fixedValue, z:
    zeroGradient."""
    zg = pkg.zero_gradient()
    return ((pkg.fixed_value(1.0), zg), (zg, pkg.fixed_value(-0.5)), (zg, zg))


def _operands(shape, seed):
    rng = np.random.default_rng(seed)
    n = shape
    gamma = tuple(rng.uniform(0.5, 2.0, s) for s in
                  ((n[0] + 1, n[1], n[2]), (n[0], n[1] + 1, n[2]),
                   (n[0], n[1], n[2] + 1)))
    return gamma, rng.uniform(1.0, 3.0, n), rng.normal(size=n)


def test_v_cycle_matches_jax():
    """One V-cycle on a seeded residual at 16 x 8 x 8 (levels 16 x 8 x 8,
    8 x 4 x 4, 4 x 2 x 2) with fixedValue and zeroGradient sides and
    variable coefficients."""
    shape, lengths = (16, 8, 8), (0.06, 0.03, 0.03)
    gamma, d, r = _operands(shape, 0)
    mj = jm.StructuredMesh.box(lengths, shape)
    mt = tm.StructuredMesh.box(lengths, shape, device="cpu")
    zj = j_mg(mj, _bcs(jm), jnp.asarray(d), tuple(map(jnp.asarray, gamma)),
              jnp.float64)(jnp.asarray(r))
    K.reset_launches()
    zt = make_mg_preconditioner(mt, _bcs(tm), t(d), tuple(map(t, gamma)),
                                torch.float64)(t(r))
    assert all(v == 0 for v in K.launches.values())
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(zj)).max())
    assert [lv[0].shape for lv in mg_levels(mt, t(d), tuple(map(t, gamma)))] \
        == [(16, 8, 8), (8, 4, 4), (4, 2, 2)]
    assert all(lv[0].device == mt.device for lv in mg_levels(
        mt, t(d), tuple(map(t, gamma))))


def _poisson(pkg, n, cyc):
    if cyc:
        b = ((pkg.cyclic(), pkg.cyclic()), (pkg.cyclic(), pkg.cyclic()),
             (pkg.empty(), pkg.empty()))
    else:
        b = ((pkg.fixed_value(0.0), pkg.fixed_value(0.0)),
             (pkg.zero_gradient(), pkg.zero_gradient()),
             (pkg.empty(), pkg.empty()))
    return b


@pytest.mark.parametrize("case", ["poisson", "variable-cyclic"])
def test_mg_cg_iterations_match_jax(case):
    """tests/test_multigrid.py's cases: Poisson at 128 x 128 x 1 (fixedValue
    x, zeroGradient y, diag 1e-6) to rel_tol 1e-8, and a variable-
    coefficient cyclic operator at 64 x 64 x 1 to 1e-10; equal MG-CG
    iteration counts, the same solution."""
    cyc = case != "poisson"
    n = 64 if cyc else 128
    rng = np.random.default_rng(1 if cyc else 0)
    if cyc:
        gamma = (rng.uniform(0.5, 2.0, (n + 1, n, 1)),
                 rng.uniform(0.5, 2.0, (n, n + 1, 1)), np.ones((n, n, 2)))
        d = rng.uniform(0.5, 1.5, (n, n, 1))
    else:
        gamma = (np.ones((n + 1, n, 1)), np.ones((n, n + 1, 1)),
                 np.ones((n, n, 2)))
        d = np.full((n, n, 1), 1e-6)
    rhs = rng.normal(size=(n, n, 1))
    rel_tol = 1e-10 if cyc else 1e-8
    out = []
    for pkg, arr, lap, sp, mg, solve, f64 in (
            (jm, jnp.asarray, j_lap, j_sp, j_mg, j_cg, jnp.float64),
            (tm, t, fvm_laplacian, fvm_source_implicit,
             make_mg_preconditioner, cg, torch.float64)):
        kw = {} if pkg is jm else {"device": "cpu"}
        mesh = pkg.StructuredMesh.box([1.0, 1.0, 1.0 / n], [n, n, 1], **kw)
        b = _poisson(pkg, n, cyc)
        g = tuple(map(arr, gamma))
        eqn = (sp(arr(d), mesh, b, dtype=f64)
               + lap(g, mesh, b, dtype=f64, sign=-1.0))
        M = mg(mesh, b, arr(d), g, f64)
        out.append(solve(eqn.apply, arr(rhs), arr(np.zeros((n, n, 1))), M,
                         tol=0.0, rel_tol=rel_tol, max_iter=200))
    rj, rt = out
    assert int(rj.iterations) == int(rt.iterations) < 30
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-8 * np.abs(np.asarray(rj.x)).max())
