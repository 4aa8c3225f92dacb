"""The plain reference against deepflame_torch's CPU path on a small box
(n = 8) in float64: DF-ODENet's rates and one whole step from a marched
state, with the program's own rates fed to the reference's flow step."""
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import case, check, march, spec  # noqa: E402


@pytest.mark.parametrize("seed", [1, 2147483659])
def test_reference_matches_the_program_in_float64(seed):
    cell = spec.load_cell("tgv192-dnn-f32.kernel")
    config = dict(cell.config, n=8, fields_dtype="float64",
                  dfodenet=dict(cell.config["dfodenet"], precision="float64"))
    solver, species = case.build_solver(config, "cpu")
    inputs = case.make_inputs(config, cell.traffic, seed, species, "cpu")
    solver = case.with_nets(solver, config, inputs.weights)
    s0 = solver.initial_state(inputs.p, inputs.T, inputs.Y, inputs.U)
    m = march.March(solver, s0, cell.traffic["dt_s"], 20, capture=3)
    while m.captured is None:
        m.step()
    s_in, RR, s_out = m.captured
    judge = check.Judge(config, case.mech_path(config), species,
                        inputs.weights, cell.traffic["dt_s"], "cpu")
    st = check.state_dict(s_in, torch.float64)
    RR_ref = torch.movedim(judge.rates(st), 0, -1)
    assert float(RR_ref.abs().max()) > 1.0          # the hot cells react
    scale = RR_ref.abs().amax(dim=(0, 1, 2))
    assert float(((RR - RR_ref).abs().amax(dim=(0, 1, 2))
                  / torch.clamp(scale, min=1e-300)).max()) < 1e-10
    numbers = judge.numbers(s_in, RR, s_out)
    assert numbers["rr_gap"] < 1e-10
    for k in ("T_gap", "Y_gap", "U_gap", "p_gap"):
        assert numbers[k] < 1e-10, (k, numbers)
    # T moved in the step by far more than the gap
    assert float((s_out.T - s_in.T).abs().max()) > 1.0


def test_reference_step_moves_every_field():
    """One step moves every compared field past its limit, so a step that
    returns its state unchanged fails each of them."""
    cell = spec.load_cell("tgv192-dnn-bf16.kernel")
    config = dict(cell.config, n=8)
    solver, species = case.build_solver(config, "cpu")
    inputs = case.make_inputs(config, cell.traffic, 5, species, "cpu")
    solver = case.with_nets(solver, config, inputs.weights)
    s0 = solver.initial_state(inputs.p, inputs.T, inputs.Y, inputs.U)
    judge = check.Judge(config, case.mech_path(config), species,
                        inputs.weights, cell.traffic["dt_s"], "cpu")
    s1, _ = solver.step(s0, cell.traffic["dt_s"])
    RR = torch.movedim(judge.rates(check.state_dict(s1, torch.float64)), 0, -1)
    numbers = judge.numbers(s1, RR, s1)
    for k in check.NAMES[1:]:
        assert numbers[k] > cell.limits[k], (k, numbers)
