"""Turbulence-chemistry interaction in the port's structured low-Mach step
against the JAX package (float64, CPU).

The 16 x 8 x 8 structured jet of `__graft_entry__._build_3d_jet` (on the
9-species test mechanism) with EDC v2005, two 0.5 us steps: the step
computes the SGS k, epsilon and nu before the chemistry and EDC integrates
each cell over its fine-structure time tau*. Tolerances as in
tests/test_torch_low_mach.py (each field within 1e-8 of its largest value,
velocity and fluxes 1e-6, equal Krylov counts). PaSR dynamicScale on the
same jet, through run_case, is in tests/test_torch_runtime.py; the
face-list jet with EDC and PaSR in tests/test_torch_low_mach_fl_tci.py.

Also: the Laminar and DNN steps, whose models read no turbulence fields,
give bit for bit the results they gave before the step computed them: the
step only does so for models that set `reads_turb`, and a Laminar model
that is handed the fields ignores them.
"""
import dataclasses
import os

import torch

from deepflame_tpu.chemistry.integrator import RosenbrockOptions as JOpts
from deepflame_tpu.combustion import EDC as JEDC

import deepflame_torch.chemistry as tc
from deepflame_torch.cases import (jet_flame_3d_les, jet_with_combustion,
                                   reacting_tgv_3d_les_dnn)
from deepflame_torch.chemistry.integrator import RosenbrockOptions
from deepflame_torch.combustion import EDC, Laminar
from deepflame_torch.ops import kernels as K
from test_torch_low_mach import run_both
from test_torch_low_mach_jet import JET_DT, jax_jet

MECH = os.path.join(os.path.dirname(__file__), "data", "h2_air_9sp.json")
OPTS = dict(rtol=1e-4, atol=1e-8, max_steps=2000, grow=10.0)
# EDC integrates each cell over tau* (up to 0.1 s), so the 1900 K kernel's
# cells reach equilibrium within the call, where the integrator's error
# estimate is round-off; the step its controller suggests for the next call
# (chem_dt, about 0.3-0.6 s there) then differs by up to 1e-3 of its value
# between the packages while T, Y and p agree to 1e-15: chem_dt is held to
# 1e-2 of each cell's value, the fields to the usual tolerances
CHEM_DT_RTOL = 1e-2


def test_structured_jet_edc_matches_jax():
    solver_j, state_j = jax_jet(8)
    solver_j = dataclasses.replace(solver_j, combustion=JEDC(
        solver_j.thermo, solver_j.combustion.kinetics, ode_opts=JOpts(**OPTS)))
    solver_t, st0 = jet_flame_3d_les(MECH, n=8, dtype=torch.float64,
                                     device="cpu")
    iH2 = tc.load_mechanism(MECH, device="cpu").species_index("H2")
    solver_t, _ = jet_with_combustion(solver_t, st0, EDC(
        solver_t.thermo, solver_t.combustion.kinetics,
        ode_opts=RosenbrockOptions(**OPTS)), iH2)
    K.reset_launches()
    _, st = run_both(solver_j, state_j, solver_t, JET_DT, 2,
                     chem_dt_rtol=CHEM_DT_RTOL)
    assert all(v == 0 for v in K.launches.values())
    assert st.cscalars == () and st.turb == ()
    assert float(st.T.max()) > 1800.0


class _HandedTurb(Laminar):
    """Laminar, but the step hands it the turbulence fields."""
    reads_turb = True


def test_laminar_and_dnn_steps_unchanged():
    """One jet step with Laminar and one DNN TGV step (n = 4): handing the
    models the turbulence fields changes no bit, and the state carries no
    transported scalars."""
    solver, s0 = jet_flame_3d_les(MECH, n=4, dtype=torch.float64,
                                  device="cpu")
    dnn, d0 = reacting_tgv_3d_les_dnn(MECH, n=4, dtype=torch.float64,
                                      compute_dtype=None, hidden=(16, 16, 16),
                                      device="cpu")
    c = solver.combustion
    handed = dataclasses.replace(solver, combustion=_HandedTurb(
        c.thermo, c.kinetics, ode_opts=c.ode_opts, n_bins=c.n_bins))
    for a, b, s, dt in ((solver, handed, s0, JET_DT),
                        (dnn, None, d0, 2.5e-7)):
        plain, _ = a.step(s, dt)
        assert plain.cscalars == () and plain.turb == ()
        if b is None:       # DNNChemistry reads no turbulence fields
            assert not a.combustion.reads_turb
            again, _ = a.step(s, dt)
        else:
            again, _ = b.step(s, dt)
        for x, y in zip(plain[:9] + (plain.chem_dt,),
                        again[:9] + (again.chem_dt,)):
            for u, v in zip(x if isinstance(x, tuple) else (x,),
                            y if isinstance(y, tuple) else (y,)):
                assert torch.equal(u, v)
