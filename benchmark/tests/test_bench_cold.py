"""The cold-gas configuration, the half-burnt traffic and their two cells:
they load, their fields hold the hot shares the cells state, their two
readers read a synthetic `Run`, and a whole run of each on the CPU at
n = 8 reads `correct`."""
import json
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import case, main, spec, trace  # noqa: E402

COLD, BURNT = "tgv192-cold-dnn-bf16.kernel", "tgv192-dnn-bf16.burnt"
READERS = {"dnn_lanes_per_reacting_cell", "chemistry_ms_per_reacting_mcell"}


@pytest.mark.parametrize("name,config,traffic", [
    (COLD, "tgv3d-h2-cold-dnn-bf16", "kernel"),
    (BURNT, "tgv3d-h2-dnn-bf16", "burnt")])
def test_cells_load(name, config, traffic):
    cell = spec.load_cell(name)
    assert cell.config["name"] == config and cell.traffic["name"] == traffic
    assert cell.chips == 1
    assert {m["name"] for m in cell.per_layer} == READERS
    assert {m["name"] for m in cell.end_to_end} == {
        "cell_updates_per_s", "peak_device_gib", "setup_s"}
    assert set(cell.limits) == {"rr_gap", "T_gap", "Y_gap", "U_gap", "p_gap"}


def test_cold_configuration_departs_from_the_bf16_one_in_the_gas_alone():
    cold = spec.load_cell(COLD).config
    warm = spec.load_cell("tgv192-dnn-bf16.kernel").config
    differ = {k for k in cold.keys() | warm.keys() if cold.get(k) != warm.get(k)}
    assert differ == {"name", "source", "deployment", "departures", "agrees",
                      "T_unburnt_K"}
    assert cold["T_unburnt_K"] == 300.0 < cold["dfodenet"]["frozen_T"]
    assert cold["departures"]["T_unburnt_K"]["here"] == 300.0
    # its own source, and `reduced` names exactly its departures: no other
    # configuration has both its source and its reduced keys
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    entries = {c["name"]: (c["source"], frozenset(c["reduced"]))
               for c in bench["configs"]}
    mine = entries.pop(cold["name"])
    assert mine == (cold["source"], frozenset(cold["departures"]))
    assert mine not in entries.values()


@pytest.mark.parametrize("name,hot_share,reacting_share", [
    (COLD, 0.0194, 0.0194), (BURNT, 0.500, 1.0)])
def test_hot_shares_at_n24(name, hot_share, reacting_share):
    cell = spec.load_cell(name)
    cell.config["n"] = 24
    species = list(cell.traffic["hot_Y"])
    inp = case.make_inputs(cell.config, cell.traffic, 2718281901, species,
                           "cpu")
    n = inp.T.numel()
    hot = float((inp.T == cell.traffic["hot_T_K"]).sum()) / n
    reacting = float((inp.T > cell.config["dfodenet"]["frozen_T"]).sum()) / n
    assert hot == pytest.approx(hot_share, abs=0.005)   # 24^3 cells
    assert reacting == pytest.approx(reacting_share, abs=0.005)


def _run(B, hot, chem_s, steps=2):
    """A traced run's record: `B` lanes a launch of mlp_fused, one launch a
    profiled step (none when B is None), `hot` reacting cells and `chem_s`
    chemistry seconds at each step of the span stretch."""
    rec = main.Run(config={}, traffic={}, cells=1000, n_species=9,
                   setup_s=1.0, steps=3, wall_s=1.0, peak_bytes=0)
    rec.spans = [dict(step_s=1.0, chem_s=chem_s, iters={}, hot_cells=h)
                 for h in hot]
    args = lambda b: tuple(range(12)) + (b, 11, 16, 1600, 800, 400, 8)
    launches = [] if B is None else [("mlp_fused", "", 2, args(b))
                                     for b in B]
    launches.append(("stencil7_apply", "", 4, (0,) * 8))
    rec.trace = trace.Trace(steps=steps, window_s=1.0, busy_s=1.0, n_ops=1,
                            device_s={}, device_n={}, idle_by_host={},
                            launches=launches)
    return rec


HOT = [20, 25, 30, 35, 40, 45, 50, 55]          # a segment's steps


def test_lanes_per_reacting_cell():
    read = spec.metric_reader("dnn_lanes_per_reacting_cell")
    # the profiled steps are the segment's steps 1 and 2
    assert read(_run([25, 30], HOT, 0.1)) == 1.0
    assert read(_run([1000, 1000], HOT, 0.1)) == pytest.approx(2000 / 55)
    assert read(_run(None, HOT, 0.1)) is None
    assert read(_run([0, 0], HOT, 0.1)) is None
    assert read(_run([25, 30], [0] * 8, 0.1)) is None
    rec = _run([25, 30], HOT, 0.1)
    rec.trace = None
    assert read(rec) is None


def test_chemistry_ms_per_reacting_mcell():
    read = spec.metric_reader("chemistry_ms_per_reacting_mcell")
    assert read(_run(None, [2_000_000] * 8, 0.05)) == pytest.approx(25.0)
    assert read(_run(None, HOT, 0.002)) == pytest.approx(
        2.0 / (sum(HOT) / 8 * 1e-6))
    assert read(_run(None, [0] * 8, 0.05)) is None
    rec = _run(None, HOT, 0.05)
    rec.spans = None
    assert read(rec) is None


@pytest.mark.parametrize("name", [COLD, BURNT])
def test_whole_run_at_n8_is_correct(name):
    cell = spec.load_cell(name)
    cell.config["n"] = 8
    result, numbers = main.run(cell, 3141592653, 0.5, False,
                               time.perf_counter(), device="cpu")
    assert result["correct"] and result["failed"] == 0, numbers
    assert set(result["metrics"]) == {"cell_updates_per_s", "peak_device_gib",
                                      "setup_s"}
