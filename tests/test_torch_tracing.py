"""The port's tracer (deepflame_torch.runtime.timers): spans and counters
inside the program, off by default; on the CPU at n = 8, and on the card
(marked gpu: run with `python -m pytest --noconftest tests/test_torch_tracing.py
-m gpu -q` on a machine with one)."""
import json
import math
import os
import time

import pytest
import torch

from deepflame_torch.cases import reacting_tgv_3d_les_dnn
from deepflame_torch.ops import linsolve
from deepflame_torch.runtime import timers

MECH = os.path.join(os.path.dirname(__file__), "data", "h2_air_9sp.json")
DT = 2.5e-7
STEP_SPANS = ("lowmach.chemistry", "lowmach.props", "lowmach.UEqn",
              "lowmach.YEqn", "lowmach.EEqn", "lowmach.thermo",
              "lowmach.pEqn", "lowmach.end")


def _tgv(n=8, dtype=torch.float64, device="cpu"):
    return reacting_tgv_3d_les_dnn(MECH, n=n, dtype=dtype,
                                   compute_dtype=dtype, hidden=(16, 8),
                                   device=device)


@pytest.fixture(scope="module")
def tgv():
    solver, s0 = _tgv()
    solver.step(s0, DT)          # first-call set-up outside the timed steps
    return solver, s0


def _lanes_problem(dtype=torch.float64):
    """Three lanes of a diagonally dominant 7-point operator on 6^3 cells,
    each lane its own diagonal, so the lanes converge after different
    iteration counts."""
    g = torch.Generator().manual_seed(3)
    d = torch.tensor([2.1, 3.0, 9.0], dtype=dtype).reshape(3, 1, 1, 1)

    def A(x):
        nb = sum(torch.roll(x, s, ax) for ax in (1, 2, 3) for s in (1, -1))
        return d * x - 0.3 * nb
    b = torch.rand((3, 6, 6, 6), generator=g, dtype=dtype)
    return A, b, torch.zeros_like(b), lambda r: r / d


def test_tracing_off_records_nothing():
    assert timers._active is None
    assert timers.span("a") is timers.span("b")       # one shared null
    A, b, x0, M = _lanes_problem()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timers.span("outside") as s:
            timers.count("x", 5)
            linsolve.cg(A, b, x0, M, tol=1e-10)
    assert s is None                                  # the null context
    assert timers._active is None                     # no tracer was made
    names = {e.name for e in prof.events()}
    assert not {"outside", "krylov.cg"} & names


def test_events_are_decided_at_the_first_span(monkeypatch):
    """A tracer made before the card is used decides on CUDA events at its
    first span, and read() refuses records whose first span came before
    the card was first used (their device times would be the host's)."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    tr = timers.PhaseTimers()
    with tr.phase("cpu"):
        pass
    assert [s.name for s in tr.read().spans] == ["cpu"]
    with tr.phase("before the card"):
        pass
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="first used"):
        tr.read()


def test_spans_nest_with_parents_steps_self_time_and_counters():
    with timers.tracing() as tr:
        for sleep in (0.0, 0.002):
            with timers.span("root"):
                with timers.span("a"):
                    timers.count("t", torch.tensor([1, 2, 3]))
                    with timers.span("a.inner"):
                        timers.count("t", torch.tensor(4))
                        timers.count("n", 2)
                time.sleep(sleep)
                with timers.span("b"):
                    pass
        timers.count("n", 10)                       # outside any span
    assert timers._active is None
    r = tr.read()
    assert [s.name for s in r.spans] == ["root", "a", "a.inner", "b"] * 2
    assert [s.parent for s in r.spans] == [None, 0, 1, 0, None, 4, 5, 4]
    assert [s.step for s in r.spans] == [0] * 4 + [1] * 4
    assert r.spans[5].counts == {"t": 6}
    assert r.spans[6].counts == {"t": 4, "n": 2}
    assert r.counters == {"t": 20, "n": 14}
    for i, s in enumerate(r.spans):
        assert s.t0_ms <= s.t1_ms and s.host_ns[0] <= s.host_ns[1]
        if s.parent is not None:
            p = r.spans[s.parent]
            assert p.t0_ms <= s.t0_ms and s.t1_ms <= p.t1_ms
    # self time: the span less its children; a leaf's is the whole span
    root = r.spans[4]
    assert r.self_ms(4) == pytest.approx(
        root.ms - r.spans[5].ms - r.spans[7].ms, abs=1e-9)
    assert r.self_ms(4) >= 2.0                      # the sleep between a, b
    assert r.self_ms(6) == r.spans[6].ms
    assert r.self_ms(5) == pytest.approx(r.spans[5].ms - r.spans[6].ms,
                                         abs=1e-9)
    assert tr.read() == ([], {})                    # read() clears
    with timers.tracing() as tr:
        with timers.span("open"):
            with pytest.raises(RuntimeError):
                tr.read()
    table = tr.report(r)
    assert table.splitlines()[0].split()[0] == "span"
    assert {"root", "a.inner", "t"} <= {ln.split()[0] for ln in
                                        table.splitlines()[1:]}


def test_spans_overlapping_children_are_covered_once():
    S = timers.Span
    r = timers.Records([S("p", None, 0, (0, 1), 0.0, 10.0, {}),
                        S("c", 0, 0, (0, 1), 1.0, 4.0, {}),
                        S("d", 0, 0, (0, 1), 3.0, 6.0, {}),
                        S("e", 0, 0, (0, 1), 9.0, 12.0, {})], {})
    assert r.self_ms(0) == pytest.approx(10.0 - 5.0 - 1.0)


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_krylov_counters_match_the_solve(solver):
    A, b, x0, M = _lanes_problem()
    with timers.tracing() as tr:
        res = getattr(linsolve, solver)(A, b, x0, M, tol=1e-10, max_iter=500)
    r = tr.read()
    assert [s.name for s in r.spans] == [f"krylov.{solver}"]
    c = r.spans[0].counts
    it = res.iterations
    assert len(set(it.tolist())) > 1                 # the lanes differ
    m, k = int(it.max()), linsolve.CHECK_EVERY
    assert c["krylov.lane_iters"] == int(it.sum())
    assert c["krylov.trips"] == k * math.ceil(m / k)
    assert c["krylov.lane_trips"] == c["krylov.trips"] * it.numel()
    assert c["krylov.lane_trips"] > c["krylov.lane_iters"]
    assert c["krylov.host_reads"] == math.ceil(m / k) + 1
    assert r.counters == c


def test_tgv_step_spans_cover_the_step(tgv):
    solver, s0 = tgv
    with timers.tracing() as tr:
        s = s0
        for _ in range(2):
            s, _ = solver.step(s, DT)
    r = tr.read()
    roots = [i for i, sp in enumerate(r.spans) if sp.parent is None]
    assert [r.spans[i].name for i in roots] == ["lowmach.step"] * 2
    for step, (i, j) in enumerate(zip(roots, roots[1:] + [len(r.spans)])):
        kids = [sp.name for sp in r.spans if sp.parent == i]
        assert kids == list(STEP_SPANS)              # n_outer = 1
        assert [sp.step for sp in r.spans[i:j]] == [step] * (j - i)
        covered = sum(sp.ms for sp in r.spans if sp.parent == i)
        assert covered >= 0.98 * r.spans[i].ms
        assert r.self_ms(i) <= 0.02 * r.spans[i].ms
        # each solve nests under its equation's span
        krylov = [(r.spans[sp.parent].name, sp.name) for sp in r.spans
                  if sp.step == step and sp.name.startswith("krylov.")]
        assert krylov == [("lowmach.UEqn", "krylov.bicgstab"),
                          ("lowmach.YEqn", "krylov.bicgstab"),
                          ("lowmach.EEqn", "krylov.bicgstab"),
                          ("lowmach.pEqn", "krylov.cg"),
                          ("lowmach.pEqn", "krylov.cg")]
    for name in ("krylov.lane_iters", "krylov.lane_trips", "krylov.trips",
                 "krylov.host_reads"):
        assert r.counters[name] > 0
    assert r.counters["krylov.lane_trips"] >= r.counters["krylov.lane_iters"]


def test_tgv_step_sends_only_reacting_cells_to_the_nets(tgv):
    """On the normal path (LowMachSolver.step -> DNNChemistry.correct) the
    nets see the cells above frozen_T alone (the 2000 K sphere in 700 K gas
    at frozen_T 700 K): the selection's spans sit in the chemistry span,
    which holds its counters."""
    solver, s0 = tgv
    with timers.tracing() as tr:
        solver.step(s0, DT)
    r = tr.read()
    chem = next(i for i, sp in enumerate(r.spans)
                if sp.name == "lowmach.chemistry")
    assert [sp.name for sp in r.spans if sp.parent == chem] == [
        "dnn.select", "dnn.scatter"]
    hot = int((s0.T > solver.combustion.net.frozen_T).sum())
    assert 0 < hot < s0.T.numel()
    assert r.spans[chem].counts == {"dnn.lanes": hot,
                                    "dnn.cells": s0.T.numel()}


def test_tgv_step_is_bitwise_the_same_with_tracing_on(tgv):
    solver, s0 = tgv
    s_off, d_off = solver.step(s0, DT)
    with timers.tracing():
        s_on, d_on = solver.step(s0, DT)
    for k, a, b in zip(s_off._fields, s_off, s_on):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), k
    assert d_off.keys() == d_on.keys()
    for k in d_off:
        assert torch.equal(torch.as_tensor(d_off[k]),
                           torch.as_tensor(d_on[k])), k


# ------------------------------------------------------------- card only

@pytest.fixture
def cuda_tgv():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    solver, s0 = _tgv(n=16, dtype=torch.float32, device="cuda")
    s0 = solver.step(s0, DT)[0]                      # builds the kernels
    torch.cuda.synchronize()
    return solver, s0


@pytest.mark.gpu
def test_card_kernel_launches_fall_inside_their_spans(cuda_tgv, tmp_path):
    """Every stencil7 and helmholtz7 launch of a profiled step is made
    inside the host interval of a Krylov span or of lowmach.UEqn, all on
    the profiler's clock."""
    solver, s0 = cuda_tgv
    with timers.tracing() as tr:
        with timers.trace(str(tmp_path)):
            solver.step(s0, DT)
            torch.cuda.synchronize()
    tr.read()
    ev = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in ev
             if e.get("cat") == "user_annotation"
             and (e["name"].startswith("krylov.") or e["name"] == "lowmach.UEqn")]
    launch = {e["args"]["correlation"]: e["ts"] for e in ev
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    kernels = [e for e in ev if e.get("cat") == "kernel"
               and ("stencil7" in e["name"] or "helmholtz7" in e["name"])]
    assert spans and len(kernels) > 10
    for k in kernels:
        t = launch[k["args"]["correlation"]]
        assert any(a <= t <= b for a, b in spans), k["name"]


@pytest.mark.gpu
def test_card_device_ops_unchanged_by_the_tracer(cuda_tgv, monkeypatch):
    """Under the device-only profiler the step's device operations are the
    same, in count and names, with tracing off, with tracing on (less its
    user annotations), and with the spans and counters taken out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from deepflame_torch.solvers import low_mach
    solver, s0 = cuda_tgv

    def ops(on=False):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if on:
                with timers.tracing() as tr:
                    solver.step(s0, DT)
            else:
                solver.step(s0, DT)
            torch.cuda.synchronize()
        if on:
            names = {s.name for s in tr.read().spans}
        else:
            names = set()
        return sorted(e.name for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and e.name not in names)
    off, on = ops(), ops(on=True)
    null = lambda *a, **k: timers._NULL
    monkeypatch.setattr(low_mach, "span", null)
    monkeypatch.setattr(linsolve, "span", null)
    monkeypatch.setattr(linsolve, "count", lambda *a, **k: None)
    bare = ops()
    assert len(off) > 100
    assert off == bare
    assert on == off
