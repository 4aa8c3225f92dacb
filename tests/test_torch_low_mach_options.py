"""Solver options of the port's low-Mach step against the JAX package
(float64, CPU): convection treatments, PIMPLE outer correctors, unity Lewis
number with gravity, and the enthalpy frozen (solve_energy off). The 2D 9-species hot spot without chemistry, with a
Taylor-Green velocity field so that convection matters; one step of 1 us.
One step, because a second one tests the reference's own conditioning: the
JAX step alone, given p perturbed by 1e-14, takes 7 more pressure-CG
iterations in the second step with two outer correctors, and differs by
1.3e-5 of the velocity with gravity. Tolerances and their reasons: see
tests/test_torch_low_mach.py."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflame_torch.cases import reacting_hot_spot_2d
from test_torch_low_mach import run_both

MECH = os.path.join(os.path.dirname(__file__), "data", "h2_air_9sp.json")


@pytest.mark.parametrize("opts", [
    dict(mv_convection="group-min"),
    dict(mv_convection="upwind"),
    dict(n_outer=2),
    dict(unity_lewis=True, gravity=(0.0, -9.81, 0.0)),
    dict(solve_energy=False),
], ids=["group-min", "upwind", "n_outer2", "unity-lewis-gravity",
        "frozen-energy"])
def test_low_mach_options_match_jax(opts):
    from __graft_entry__ import _build
    import deepflame_tpu.chemistry as jc

    orig = jc.load_mechanism
    jc.load_mechanism = lambda path, *a, **k: orig(MECH)
    try:
        solver_j, s0 = _build(n=8, dtype=jnp.float64, chemistry=False)
    finally:
        jc.load_mechanism = orig
    solver_j = dataclasses.replace(
        solver_j, config=dataclasses.replace(solver_j.config, **opts))
    L = 2e-3
    X, Yg, _ = solver_j.mesh.cell_centers()
    k = 2 * np.pi / L
    U = jnp.stack([2.0 * jnp.sin(k * X) * jnp.cos(k * Yg),
                   -2.0 * jnp.cos(k * X) * jnp.sin(k * Yg), jnp.zeros_like(X)])
    state_j = solver_j.initial_state(s0.p, s0.T, s0.Y, U)

    solver_t, _ = reacting_hot_spot_2d(MECH, n=8, dtype=torch.float64,
                                       chemistry=False, device="cpu")
    solver_t = dataclasses.replace(
        solver_t, config=dataclasses.replace(solver_t.config, **opts))
    _, state_t = run_both(solver_j, state_j, solver_t, 1e-6, 1)
    if not solver_t.config.solve_energy:
        np.testing.assert_array_equal(state_t.ha.numpy(),
                                      np.asarray(state_j.ha))


def test_thermo_tran_nn_hook_matches_jax():
    """tests/test_low_mach.py's useThermoTranNN case: inert air, 8 x 8 x 1
    periodic, a hook that fixes mu and alpha. The port calls it, takes its
    values, and steps like the JAX package with the same hook."""
    import deepflame_tpu.chemistry as jc
    import deepflame_tpu.mesh as jm
    from deepflame_tpu.combustion import NoCombustion as JNoCombustion
    from deepflame_tpu.solvers.low_mach import LowMachConfig as JConfig
    from deepflame_tpu.solvers.low_mach import LowMachSolver as JSolver

    import deepflame_torch.chemistry as tc
    import deepflame_torch.mesh as tm
    from deepflame_torch.combustion import NoCombustion
    from deepflame_torch.solvers import LowMachConfig, LowMachSolver

    air = os.path.join(os.path.dirname(__file__), "data", "air.yaml")
    n = 8
    calls = []

    def hook(full):
        def nn(T, p, Yt):
            calls.append(1)
            return {"mu": full(T, 5e-5), "alpha": full(T, 7e-5)}
        return nn

    solvers = []
    for pkg, chem, S, Cfg, Comb, full, kw in (
            (jm, jc, JSolver, JConfig, JNoCombustion, jnp.full_like, {}),
            (tm, tc, LowMachSolver, LowMachConfig, NoCombustion,
             torch.full_like, {"device": "cpu"})):
        mech = chem.load_mechanism(air, **kw)
        th, tr, kin = (chem.make_thermo(mech), chem.make_transport(mech),
                       chem.make_kinetics(mech))
        b = ((pkg.cyclic(), pkg.cyclic()), (pkg.cyclic(), pkg.cyclic()),
             (pkg.empty(), pkg.empty()))
        solvers.append(S(
            mesh=pkg.StructuredMesh.box([0.01, 0.01, 0.01 / n], [n, n, 1],
                                        **kw),
            thermo=th, transport=tr, combustion=Comb(th, kin),
            bcs_U=(b, b, b), bcs_p=b, bcs_h=b, bcs_Y=b, bcs_rho=b,
            config=Cfg(chemistry=False), thermo_tran_nn=hook(full)))
    solver_j, solver_t = solvers
    sh = (n, n, 1)
    mu, alpha, _ = solver_t._mixture_update(
        torch.full(sh, 101325.0, dtype=torch.float64),
        torch.full(sh, 300.0, dtype=torch.float64),
        torch.ones((1,) + sh, dtype=torch.float64))
    assert calls
    assert float((mu - 5e-5).abs().max()) == 0.0
    assert float((alpha - 7e-5).abs().max()) == 0.0
    X, Yg, _ = solver_j.mesh.cell_centers()
    k = 2 * np.pi / 0.01
    U = jnp.stack([jnp.sin(k * X) * jnp.cos(k * Yg),
                   -jnp.cos(k * X) * jnp.sin(k * Yg), jnp.zeros_like(X)])
    T = 300.0 + 50.0 * jnp.sin(k * X)
    state_j = solver_j.initial_state(jnp.full(sh, 101325.0), T,
                                     jnp.ones((1,) + sh), U)
    run_both(solver_j, state_j, solver_t, 1e-5, 1)
