"""The readers of the program's spans and counters (harness/program.py) on
a synthetic `Run`, and the idle split by span on synthetic records."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from deepflame_torch.runtime.timers import Span  # noqa: E402
from harness import main, program, spec  # noqa: E402

NEW = ("ueqn_ms", "yeqn_ms", "eeqn_ms", "peqn_ms", "props_ms",
       "chemistry_span_ms", "krylov_useful_share", "krylov_host_reads",
       "krylov_idle_ms")


def _step(scale):
    spans = {"lowmach.step": 100.0 * scale, "lowmach.chemistry": 40.0 * scale,
             "lowmach.props": 5.0 * scale, "lowmach.UEqn": 10.0 * scale,
             "lowmach.YEqn": 20.0 * scale, "lowmach.EEqn": 8.0 * scale,
             "lowmach.thermo": 3.0 * scale, "lowmach.pEqn": 12.0 * scale,
             "lowmach.end": 2.0 * scale, "krylov.bicgstab": 25.0 * scale,
             "krylov.cg": 9.0 * scale}
    counters = {"krylov.trips": 40, "krylov.lane_trips": 160,
                "krylov.lane_iters": 120, "krylov.host_reads": 15}
    return {"spans": spans, "counters": counters}


def _run(spans, idle):
    rec = main.Run(config={}, traffic={}, cells=8, n_species=9, setup_s=1.0,
                   steps=3, wall_s=1.0, peak_bytes=0)
    if spans is not None:
        rec.program = spans
    if idle is not None:
        rec.program_idle = idle
    return rec


@pytest.fixture
def run():
    return _run({"steps": [_step(1.0), _step(2.0)]},
                {"steps": 3, "window_s": 0.5, "busy_s": 0.35, "idle_s": 0.15,
                 "idle_by_span": [{"krylov.cg": 0.004, "krylov.bicgstab": 0.002,
                                   "lowmach.YEqn": 0.01, "no span": 0.001},
                                  {"krylov.cg": 0.001},
                                  {"krylov.bicgstab": 0.1}]})


@pytest.mark.parametrize("name,value", [
    ("ueqn_ms", 15.0), ("yeqn_ms", 30.0), ("eeqn_ms", 12.0),
    ("peqn_ms", 18.0), ("props_ms", 15.0), ("chemistry_span_ms", 60.0),
    ("krylov_useful_share", 75.0), ("krylov_host_reads", 15.0),
    ("krylov_idle_ms", 6.0)])                # the median of 6, 1, 100
def test_reader_on_a_synthetic_run(run, name, value):
    assert spec.metric_reader(name)(run) == pytest.approx(value)


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_none_without_the_program_record(name):
    read = spec.metric_reader(name)
    assert read(_run(None, None)) is None            # --trace 0
    assert read(_run({"steps": []}, None)) is None   # no steps


def test_span_readers_give_none_where_a_step_lacks_the_span(run):
    del run.program["steps"][1]["spans"]["lowmach.thermo"]
    assert spec.metric_reader("props_ms")(run) is None
    assert spec.metric_reader("ueqn_ms")(run) == pytest.approx(15.0)


def test_gaps_within_a_window():
    busy, gaps = program._gaps([(10, 20), (15, 30), (40, 50)], 0, 60)
    assert busy == [[10, 30], [40, 50]]
    assert gaps == [(0, 10), (30, 40), (50, 60)]
    busy, gaps = program._gaps([(10, 20), (25, 30)])
    assert gaps == [(20, 25)]


def _span(name, parent, h0, h1):
    return Span(name, parent, 0, (h0, h1), 0.0, 0.0, {})


def test_idle_split_by_the_innermost_host_span():
    # step [0, 100]: UEqn [10, 40] holding krylov.bicgstab [20, 35]
    spans = [_span("lowmach.step", None, 1000, 2000),
             _span("lowmach.UEqn", 0, 1100, 1400),
             _span("krylov.bicgstab", 1, 1200, 1350)]
    # the event records, on the profiler's clock, in host order: step
    # start, UEqn start, bicgstab start, bicgstab end, UEqn end, step end
    marks = [(0, 1), (10, 11), (20, 21), (34, 35), (39, 40), (99, 100)]
    host = program._host_intervals(spans, marks)
    assert host == [(0, 100, "lowmach.step"), (10, 40, "lowmach.UEqn"),
                    (20, 35, "krylov.bicgstab")]
    idle = program._label([(2, 4), (12, 14), (22, 30), (36, 38), (50, 60)],
                          host, [0])
    assert len(idle) == 1
    assert idle[0] == pytest.approx({"lowmach.step": 12e-6,
                                     "lowmach.UEqn": 4e-6,
                                     "krylov.bicgstab": 8e-6})
    with pytest.raises(RuntimeError, match="5 event records for 6"):
        program._host_intervals(spans, marks[:-1])


def test_idle_split_by_step():
    # two steps [0, 100] and [110, 200], each holding a CG solve
    host = [(0, 100, "lowmach.step"), (20, 40, "krylov.cg"),
            (110, 200, "lowmach.step"), (130, 150, "krylov.cg")]
    idle = program._label([(25, 27), (102, 108), (135, 139), (160, 162)],
                          host, [0, 110])
    assert idle == [pytest.approx({"krylov.cg": 2e-6, "no span": 6e-6}),
                    pytest.approx({"krylov.cg": 4e-6, "lowmach.step": 2e-6})]
    assert program.krylov_idle_s(idle) == pytest.approx([2e-6, 4e-6])
