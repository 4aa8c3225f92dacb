"""The port's structured low-Mach step with per-field boundary conditions
against the JAX package (float64, CPU).

The 3D LES jet flame of `__graft_entry__._build_3d_jet` (bench.py's jet
line) on the structured box: one FieldBCs per species and velocity
components with different inlet values, which the JAX package solves one
after another and the port as one batch with its BCs stacked along the lane
axis. Built on the 9-species test mechanism (H2_Li is not in the
repository). Two 0.5 us steps at n = 8 (16 x 8 x 8) under both pressure
preconditioners, and a small duct whose BC kinds differ between the lanes.
Tolerances as in tests/test_torch_low_mach.py: each field within 1e-8 of its
largest value, velocity and face fluxes within 1e-6, equal Krylov counts.
The JAX package's sequential loops report no `iters_U` or `iters_Y`, so only
the counts it reports (`iters_h`, `iters_p`) are compared.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepflame_tpu.chemistry as jc
import deepflame_tpu.mesh as jm
from deepflame_tpu.combustion import NoCombustion as JNoCombustion
from deepflame_tpu.solvers.low_mach import LowMachConfig as JConfig
from deepflame_tpu.solvers.low_mach import LowMachSolver as JSolver

import deepflame_torch.chemistry as tc
import deepflame_torch.mesh as tm
from deepflame_torch.cases import jet_flame_3d_les
from deepflame_torch.combustion import NoCombustion
from deepflame_torch.mesh.structured import stack_bcs
from deepflame_torch.ops import kernels as K
from deepflame_torch.solvers import LowMachConfig, LowMachSolver
from test_torch_low_mach import FIELDS, _rel, run_both

MECH = os.path.join(os.path.dirname(__file__), "data", "h2_air_9sp.json")
JET_DT = 5e-7


def jax_jet(n):
    """`_build_3d_jet(n)` in float64 on the test mechanism."""
    from __graft_entry__ import _build_3d_jet
    orig = jc.load_mechanism
    jc.load_mechanism = lambda path, *a, **k: orig(MECH)
    try:
        return _build_3d_jet(n=n, dtype=jnp.float64)
    finally:
        jc.load_mechanism = orig


def with_precond(solver, p_precond):
    return dataclasses.replace(solver, config=dataclasses.replace(
        solver.config, p_precond=p_precond))


@pytest.fixture(scope="module")
def jet8():
    solver_j, state_j = jax_jet(8)
    solver_t, _ = jet_flame_3d_les(MECH, n=8, dtype=torch.float64,
                                   device="cpu")
    return solver_j, state_j, solver_t


def _bc_value(bc):
    return np.asarray(bc.value if not isinstance(bc.value, torch.Tensor)
                      else bc.value.numpy())


def test_jet_equals_build_3d_jet():
    """n = 4: mesh, initial fields and every BC value equal the JAX case's."""
    sj, s0 = jax_jet(4)
    st, s0t = jet_flame_3d_les(MECH, n=4, dtype=torch.float64, device="cpu")
    assert st.mesh.shape == sj.mesh.shape == (8, 4, 4)
    for a in ("dx", "dy", "dz", "x0", "y0", "z0"):
        assert getattr(st.mesh, a) == pytest.approx(getattr(sj.mesh, a),
                                                    rel=1e-15, abs=1e-18), a
    for k in FIELDS:
        assert _rel(getattr(s0, k), getattr(s0t, k)) <= 1e-14, k
    for ax in range(3):
        assert _rel(s0.phi[ax], s0t.phi[ax]) <= 1e-14
    pairs = [(sj.bcs_U[c], st.bcs_U[c]) for c in range(3)]
    pairs += [(sj.bcs_p, st.bcs_p), (sj.bcs_h, st.bcs_h),
              (sj.bcs_rho, st.bcs_rho)]
    pairs += list(zip(sj.bcs_Y, st.bcs_Y))
    assert isinstance(st.bcs_Y, list) and len(pairs) == 6 + 9
    for bj, bt in pairs:
        for ax in range(3):
            for side in (0, 1):
                a, b = bj[ax][side], bt[ax][side]
                assert a.kind == b.kind
                np.testing.assert_allclose(_bc_value(b), np.asarray(a.value),
                                           rtol=1e-14, atol=1e-300)
    assert st.combustion.n_bins == sj.combustion.n_bins == 32
    assert st.config.inert_index == sj.config.inert_index
    assert st.turbulence.kind == sj.turbulence.kind == "Sigma"


@pytest.mark.parametrize("p_precond", ["jacobi", "mg"])
def test_jet_two_steps_match_jax(jet8, p_precond):
    """Two steps of the 16 x 8 x 8 jet: the pilot kernel burns, the inlet
    drives the flow, the outlet pressure is fixed; no kernel launches on
    the CPU."""
    solver_j, state_j, solver_t = jet8
    solver_j = with_precond(solver_j, p_precond)
    solver_t = with_precond(solver_t, p_precond)
    K.reset_launches()
    _, st = run_both(solver_j, state_j, solver_t, JET_DT, 2)
    assert all(v == 0 for v in K.launches.values())
    assert float(st.T.max()) > 1800.0
    assert float((st.Y.sum(0) - 1.0).abs().max()) < 1e-12
    # outward mass fluxes: into the box at the inlet, out at the outlet
    phi_x = st.phi[0]
    assert -float(phi_x[0].sum()) < 0.0 < float(phi_x[-1].sum())


def test_jet_solves_are_one_batch(jet8):
    """The species and velocity lanes carry their own inlet values in one
    stacked FieldBCs; uniform faces keep the user's BC."""
    _, _, st = jet8
    by, bu = st.bcs_Y_lanes, st.bcs_U_lanes
    assert by[0][0].kind == "affine" and bu[0][0].kind == "affine"
    a, b = by[0][0].value
    assert tuple(a.shape) == (9, 1, 1, 1) and tuple(b.shape) == (9, 1, 8, 8)
    for i in range(9):
        np.testing.assert_array_equal(b[i].numpy(),
                                      2.0 * st.bcs_Y[i][0][0].value.numpy())
    assert by[0][1] is st.bcs_Y[0][0][1]
    assert by[1] == st.bcs_Y[0][1]


# ----------------------------------------------------- BC kinds per lane

def _duct(pkg, zero_grad_species):
    """A 12 x 4 x 4 duct, x streamwise: U_x 2 m/s at the inlet, symmetry
    planes in y and z (the normal component negated there), p fixed at the
    outlet, 300 K inflow; each species fixed at the inlet but
    `zero_grad_species`, zeroGradient there. No chemistry."""
    if pkg is tm:
        mech = tc.load_mechanism(MECH, device="cpu")
        th, tr, kin = (tc.make_thermo(mech), tc.make_transport(mech),
                       tc.make_kinetics(mech))
        mesh = tm.StructuredMesh.box([0.012, 0.004, 0.004], [12, 4, 4],
                                     device="cpu")
        S, Cfg, Comb = LowMachSolver, LowMachConfig, NoCombustion
        arr = lambda a: torch.as_tensor(a, dtype=torch.float64)
    else:
        mech = jc.load_mechanism(MECH)
        th, tr, kin = (jc.make_thermo(mech), jc.make_transport(mech),
                       jc.make_kinetics(mech))
        mesh = jm.StructuredMesh.box([0.012, 0.004, 0.004], [12, 4, 4])
        S, Cfg, Comb = JSolver, JConfig, JNoCombustion
        arr = jnp.asarray
    ns = mech.n_species
    zg, sym, neg = pkg.zero_gradient(), pkg.symmetry(), pkg.symmetry(True)
    fv = pkg.fixed_value
    side = lambda c, ax: (neg, neg) if c == ax else (sym, sym)
    bcs_U = tuple(((fv(2.0) if c == 0 else fv(0.0), zg), side(c, 1),
                   side(c, 2)) for c in range(3))
    Y_in = np.zeros(ns)
    for name, y in (("H2", 0.02), ("O2", 0.2264), ("N2", 0.7536)):
        Y_in[mech.species_index(name)] = y
    bcs_Y = [((zg if i == zero_grad_species else fv(float(Y_in[i])), zg),
              (sym, sym), (sym, sym)) for i in range(ns)]
    h_in = float(th.h_mass(arr(300.0), arr(Y_in)))
    solver = S(mesh=mesh, thermo=th, transport=tr, combustion=Comb(th, kin),
               bcs_U=bcs_U, bcs_p=((zg, fv(101325.0)), (sym, sym),
                                   (sym, sym)),
               bcs_h=((fv(h_in), zg), (sym, sym), (sym, sym)), bcs_Y=bcs_Y,
               bcs_rho=((zg, zg), (sym, sym), (sym, sym)),
               config=Cfg(chemistry=False,
                          inert_index=mech.species_index("N2")))
    return solver, mech


def test_duct_with_per_lane_bc_kinds_matches_jax():
    """One species zeroGradient at the inlet where the others are fixed; the
    normal velocity component symmetryNegate on the y and z planes where the
    others are zero-gradient symmetry, so the lanes' diagonals differ (rAU is
    lane 0's, as the JAX package's is component 0's). Three 20 us steps of a
    warm, swirling start against the JAX package's sequential loops."""
    solver_j, mech = _duct(jm, 4)
    solver_t, _ = _duct(tm, 4)
    rng = np.random.default_rng(7)
    sh = solver_j.mesh.shape
    ns = mech.n_species
    X, Yg, Z = (np.asarray(c) for c in solver_j.mesh.cell_centers())
    T = 300.0 + 300.0 * np.exp(-((X - 0.006) ** 2 + (Yg - 0.002) ** 2)
                               / 2e-6)
    Y = np.abs(rng.normal(0.02, 0.01, (ns,) + sh))
    Y[mech.species_index("N2")] = 0.0
    Y *= 0.25 / Y.sum(0)
    Y[mech.species_index("N2")] = 0.75
    U = np.stack([2.0 + 0.5 * np.sin(2e3 * np.pi * Yg / 4),
                  0.3 * np.cos(2e3 * np.pi * X / 12),
                  0.2 * np.sin(2e3 * np.pi * Z / 4)])
    state_j = solver_j.initial_state(jnp.full(sh, 101325.0), jnp.asarray(T),
                                     jnp.asarray(Y), jnp.asarray(U))
    a_ylo = solver_t.bcs_U_lanes[1][0].value[0]
    np.testing.assert_array_equal(a_ylo.ravel().numpy(), [1.0, -1.0, 1.0])
    _, st = run_both(solver_j, state_j, solver_t, 2e-5, 3)
    assert float((st.Y.sum(0) - 1.0).abs().max()) < 1e-12


def test_stacked_cyclic_must_agree():
    mesh = tm.StructuredMesh.box([1.0, 1.0, 1.0], [4, 4, 4], device="cpu")
    cyc, zg = (tm.cyclic(), tm.cyclic()), (tm.zero_gradient(),) * 2
    with pytest.raises(ValueError, match="cyclic"):
        stack_bcs([(cyc, zg, zg), (zg, zg, zg)], mesh,
                                torch.float64)
