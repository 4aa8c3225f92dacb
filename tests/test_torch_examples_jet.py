"""The examples' 2D RAS jet flame in the PyTorch port (cases.jet_flame_2d)
against the same case built with the JAX package's functions exactly as
examples/jet_flame_2d.py builds it, float64 on the CPU on the 9-species
test mechanism (the example loads H2_Li, which the repository lacks), with
each of its --model choices: k-epsilon RAS with EDC, PaSR or Laminar
chemistry on the structured low-Mach step, per-species inlet profiles and
a fixedValue outlet pressure. Tolerances as test_torch_examples_low_mach.py
states them (TOL of each field's largest value, the face flux over its
largest |phi| of all axes, iterations equal)."""

import jax.numpy as jnp
import numpy as np
import pytest

from deepflame_tpu.chemistry import (load_mechanism, make_kinetics,
                                     make_thermo, make_transport)
from deepflame_tpu.chemistry.integrator import RosenbrockOptions
from deepflame_tpu.combustion import EDC, Laminar, PaSR
from deepflame_tpu.mesh import (StructuredMesh, empty, fixed_value,
                                zero_gradient)
from deepflame_tpu.solvers.low_mach import LowMachConfig, LowMachSolver
from deepflame_tpu.turbulence.ras import KEpsilon

from deepflame_torch import cases
from test_torch_examples_low_mach import MECH, _check_state, _steps


# --------------------------------------------------- A18 jet_flame_2d.py

def _jax_jet_2d(cells, model):
    """examples/jet_flame_2d.py:45-109 (float64) at `cells`."""
    mech = load_mechanism(MECH)
    th, tr, kin = make_thermo(mech), make_transport(mech), make_kinetics(mech)
    ns = mech.n_species
    iH2, iO2, iN2 = (mech.species_index(s) for s in ("H2", "O2", "N2"))
    nx, ny = 4 * cells, cells
    Lx, Ly = 0.08, 0.02
    mesh = StructuredMesh.box([Lx, Ly, Ly / ny], [nx, ny, 1],
                              origin=(0.0, -Ly / 2, 0.0))
    e = (empty(), empty())
    X, Yg, _ = mesh.cell_centers()
    jet_r = 0.002
    in_jet = np.abs(np.asarray(Yg)[0, :, 0]) < jet_r
    Y_in = np.zeros((ns, ny))
    Y_in[iH2, :] = np.where(in_jet, 0.30, 0.0)
    Y_in[iN2, :] = np.where(in_jet, 0.70, 0.767)
    Y_in[iO2, :] = np.where(in_jet, 0.0, 0.233)
    bcs_Y = []
    for i in range(ns):
        val = jnp.asarray(Y_in[i][None, :, None])
        bcs_Y.append(((fixed_value(val), zero_gradient()),
                      (zero_gradient(), zero_gradient()), e))
    u_jet, u_co = 40.0, 1.0
    u_prof = jnp.asarray(np.where(in_jet, u_jet, u_co)[None, :, None])
    T_in = jnp.asarray(np.where(in_jet, 400.0, 1400.0)[None, :, None])
    bU = ((fixed_value(u_prof), zero_gradient()),
          (zero_gradient(), zero_gradient()), e)
    bU0 = ((fixed_value(0.0), zero_gradient()),
           (zero_gradient(), zero_gradient()), e)
    bp = ((zero_gradient(), fixed_value(101325.0)),
          (zero_gradient(), zero_gradient()), e)
    Yt_in = jnp.moveaxis(jnp.asarray(Y_in)[:, None, :, None], 0, -1)
    h_prof = th.h_mass(T_in, Yt_in)
    bh = ((fixed_value(h_prof), zero_gradient()),
          (zero_gradient(), zero_gradient()), e)
    rho_prof = th.rho(jnp.asarray(101325.0), T_in, Yt_in)
    brho = ((fixed_value(rho_prof), zero_gradient()),
            (zero_gradient(), zero_gradient()), e)
    opts = RosenbrockOptions(rtol=1e-6, atol=1e-12, max_steps=20000, grow=10.0)
    models = {"EDC": EDC, "PaSR": PaSR, "laminar": Laminar}
    solver = LowMachSolver(
        mesh=mesh, thermo=th, transport=tr,
        combustion=models[model](th, kin, ode_opts=opts),
        bcs_U=(bU, bU0, bU0), bcs_p=bp, bcs_h=bh, bcs_Y=bcs_Y, bcs_rho=brho,
        config=LowMachConfig(chemistry=True, div_scheme="upwind",
                             inert_index=int(iN2)),
        turbulence=KEpsilon())
    Y0 = np.zeros((ns,) + mesh.shape)
    Y0[iN2], Y0[iO2] = 0.767, 0.233
    T0 = jnp.full(mesh.shape, 1400.0)
    s = solver.initial_state(jnp.full(mesh.shape, 101325.0), T0,
                             jnp.asarray(Y0),
                             k0=u_jet**2 * 0.01, eps0=u_jet**3 * 0.1 / jet_r)
    return solver, s


# cells = 6 (24 x 6 x 1): the coarsest mesh with a cell centre in the 2 mm
# jet (y = +-1.67 mm); at cells = 4 the centres lie at +-2.5 and +-7.5 mm
# and no fuel enters
JET_CELLS = 6


@pytest.mark.parametrize("model", ["EDC", "PaSR", "laminar"])
def test_jet_flame_2d_matches_the_example(model):
    """jet_flame_2d at cells = JET_CELLS with each --model: the
    initial state, k and epsilon as the example's, then 2 steps of 2 us
    within TOL with equal iterations; the per-species inlet profiles reach
    the fields (H2 enters the first column)."""
    solver_j, sj = _jax_jet_2d(JET_CELLS, model)
    solver_t, st, dt, info = cases.jet_flame_2d(MECH, model=model, n=JET_CELLS,
                                                device="cpu")
    assert dt == 2e-6 and info["steps"] == 300
    assert type(solver_t.combustion).__name__ == type(
        solver_j.combustion).__name__
    _check_state(sj, st, 1e-14)
    _, out_t = _steps(solver_j, sj, solver_t, st, dt, 2)
    assert float(out_t[-1].Y[info["h2_index"], 0].max()) > 0.01


def test_jet_flame_2d_rejects_an_unknown_model():
    with pytest.raises(ValueError, match="EDC"):
        cases.jet_flame_2d(MECH, model="FGM", n=4, device="cpu")
