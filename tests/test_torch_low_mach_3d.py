"""PyTorch port of the 3D reacting LES step against the JAX package (float64,
CPU): the flagship configuration of __graft_entry__._build_3d_les at n = 8
on the 9-species test mechanism, 2 steps of 0.25 us. Tolerances and their
reasons: see tests/test_torch_low_mach.py."""
import os

import jax.numpy as jnp
import torch

from __graft_entry__ import _build_3d_les
from deepflame_torch.cases import reacting_tgv_3d_les
from test_torch_low_mach import FIELDS, _rel, run_both

MECH = os.path.join(os.path.dirname(__file__), "data", "h2_air_9sp.json")


def test_reacting_tgv_3d_les():
    solver_j, state_j = _build_3d_les(n=8, dtype=jnp.float64, mech_path=MECH)
    solver_t, state_t0 = reacting_tgv_3d_les(MECH, n=8, dtype=torch.float64,
                                             device="cpu")
    for k in FIELDS:
        assert _rel(getattr(state_j, k), getattr(state_t0, k)) <= 1e-14, k
    state_j, state_t = run_both(solver_j, state_j, solver_t, 2.5e-7, 2)
    # the step really changed the state: the flow moved and the kernel cooled
    assert float((state_t.T - state_t0.T).abs().max()) > 1.0
