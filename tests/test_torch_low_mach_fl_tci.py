"""Turbulence-chemistry interaction in the port's face-list low-Mach step
against the JAX package (float64, CPU): the 16 x 8 x 8 face-list jet
(`jet_flame_3d_les_fl`) with EDC v2005 and with PaSR globalScale, two 0.5
us steps each. The step hands the models the SGS k, epsilon and nu from
the face-list LES (the JAX face-list step has no transported-scalar path).
Tolerances as in tests/test_torch_low_mach_fl.py."""
import dataclasses

import pytest
import torch

from deepflame_tpu.chemistry.integrator import RosenbrockOptions as JOpts
import deepflame_tpu.combustion as jcomb

import deepflame_torch.combustion as tcomb
from deepflame_torch.cases import jet_flame_3d_les_fl
from deepflame_torch.chemistry.integrator import RosenbrockOptions
from deepflame_torch.ops import kernels as K
from test_torch_low_mach_fl import JET_DT, MECH, jax_jet, run_both_fl

OPTS = dict(rtol=1e-4, atol=1e-8, max_steps=2000, grow=10.0)
# EDC integrates each cell over tau* (up to 0.1 s), so the 1900 K kernel's
# cells reach equilibrium within the call, where the integrator's error
# estimate is round-off; the step its controller suggests for the next call
# (chem_dt, about 0.3-0.6 s there) then differs by up to 1e-3 of its value
# between the packages while T, Y and p agree to 1e-15: chem_dt is held to
# 1e-2 of each cell's value, the fields to the usual tolerances
CHEM_DT_RTOL = 1e-2


@pytest.mark.parametrize("model,kw", [("EDC", {}),
                                      ("PaSR", dict(mixing_scale="globalScale"))],
                         ids=["EDC", "PaSR-globalScale"])
def test_facelist_jet_mixing_model_matches_jax(model, kw):
    solver_j, state_j = jax_jet(8)
    solver_j = dataclasses.replace(solver_j, combustion=getattr(jcomb, model)(
        solver_j.thermo, solver_j.combustion.kinetics, ode_opts=JOpts(**OPTS),
        **kw))
    solver_t, _ = jet_flame_3d_les_fl(MECH, n=8, dtype=torch.float64,
                                      device="cpu")
    solver_t = dataclasses.replace(solver_t, combustion=getattr(tcomb, model)(
        solver_t.thermo, solver_t.combustion.kinetics,
        ode_opts=RosenbrockOptions(**OPTS), **kw))
    K.reset_launches()
    _, st = run_both_fl(solver_j, state_j, solver_t, JET_DT, 2,
                         chem_dt_rtol=CHEM_DT_RTOL if model == "EDC"
                         else None)
    assert all(v == 0 for v in K.launches.values())
    assert float(st.T.max()) > 1800.0
