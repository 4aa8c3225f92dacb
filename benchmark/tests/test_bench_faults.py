"""A whole run, less the harness's look for a card, on the CPU at n = 8,
with the timed path broken underneath: `correct` comes out false for
each fault a cell of this benchmark can have, and true for the sound
program. (One card: no exchange between chips to leave out.)"""
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from deepflame_torch.chemistry.dnn import DFODENet  # noqa: E402
from deepflame_torch.solvers import LowMachSolver  # noqa: E402
from deepflame_torch.chemistry import load_mechanism  # noqa: E402
from harness import case, main, spec  # noqa: E402

CELLS = ["tgv192-dnn-bf16.kernel", "tgv192-dnn-f32.kernel"]


def _run(cell_name, seed=2147483651):
    cell = spec.load_cell(cell_name)
    cell.config["n"] = 8
    result, numbers = main.run(cell, seed, 0.5, False, time.perf_counter(),
                               device="cpu")
    return result, numbers, cell.limits


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    result, numbers, limits = _run(cell)
    assert result["correct"], (numbers, limits)
    assert result["failed"] == 0 and result["attempted"] > 0


def _unchanged(self, s, dt, sources=None):
    return s, {}


def _half_the_cells(inner):
    def rates(self, T, p, Y, rho):
        RR = inner(self, T, p, Y, rho)
        flat = RR.reshape(-1, RR.shape[-1]).clone()
        flat[flat.shape[0] // 2:] = 0.0
        return flat.reshape(RR.shape)
    return rates


def _one_rate_altered(inner):
    def rates(self, T, p, Y, rho):
        RR = inner(self, T, p, Y, rho).clone()
        flat = RR.reshape(-1, RR.shape[-1])
        i = int(torch.argmax(flat.abs().amax(-1)))
        flat[i] *= 1.5
        return RR
    return rates


def _one_net_zeroed(inner, column):
    def fused(self, x):
        out = inner(self, x).clone()
        out[..., column] = 0.0
        return out
    return fused


def _one_temperature_altered(inner):
    def step(self, s, dt, sources=None):
        new, diag = inner(self, s, dt, sources)
        T = new.T.clone()
        T.view(-1)[0] += 10.0
        return new._replace(T=T), diag
    return step


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_the_cells",
                                   "one_rate_altered",
                                   "one_temperature_altered"])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    if fault == "unchanged":
        monkeypatch.setattr(LowMachSolver, "step", _unchanged)
    elif fault == "one_temperature_altered":
        monkeypatch.setattr(LowMachSolver, "step",
                            _one_temperature_altered(LowMachSolver.step))
    else:
        wrap = {"half_the_cells": _half_the_cells,
                "one_rate_altered": _one_rate_altered}[fault]
        monkeypatch.setattr(DFODENet, "rates", wrap(DFODENet.rates))
    result, numbers, limits = _run(cell)
    assert not result["correct"], (fault, numbers, limits)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("species", ["H", "O", "OH", "HO2", "H2O2"])
def test_one_radical_net_left_out_is_not_correct(cell, species, monkeypatch):
    """The net of one radical gives no output (its species' rate is then
    only the renormalisation's share): the mixture in the traffic's hot
    sphere holds every radical, so each net's rates count."""
    config = spec.load_cell(cell).config
    names = list(load_mechanism(case.mech_path(config),
                                device="cpu").species_names)
    monkeypatch.setattr(DFODENet, "_fused_mlp",
                        _one_net_zeroed(DFODENet._fused_mlp,
                                        names.index(species)))
    result, numbers, limits = _run(cell)
    assert not result["correct"], (species, numbers, limits)
