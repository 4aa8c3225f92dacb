"""The port's tracer: spans and counters inside the program, and a
torch.profiler trace context.

Port of deepflame_tpu/runtime/timers.py (the reference's time_monitor_*
accumulators), grown into a tracer. It is off by default and on inside
`with tracing() as tr:`. While off, `span(name)` returns one shared null
context and `count(name, n)` returns at once: the cost is one test of a
module global. While on, a span records its name, its parent, the step it
belongs to (a span opened with none open starts a step; everything inside
it shares the step's id), its host start and end (`time.perf_counter_ns`)
and, when the card is in use at the first span of a recording, a pair of
CUDA timing events on the current stream, recorded without a synchronise;
on the CPU the device times are the host times. It also enters `torch.profiler.record_function(name)`, so any
profiler session (`trace()` below) shows it on the profiler's clock. A
counter adds to the innermost open span; a tensor value is summed on the
device at `read()`, never on the step path.

    from deepflame_torch.runtime import timers
    with timers.tracing() as tr:
        run_case(solver, state, control)
    print(tr.report())

`read()` synchronises once, resolves the events into device milliseconds
and returns and clears the records (`Records`); `report()` formats them as
a per-span table.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import NamedTuple

import torch
from torch.profiler import record_function

__all__ = ["PhaseTimers", "Records", "Span", "count", "span", "trace",
           "tracing"]

_NULL = contextlib.nullcontext()
_active = None          # the PhaseTimers recording now, or None


def span(name: str):
    """A context that records one span while tracing is on."""
    tr = _active
    if tr is None:
        return _NULL
    return _Open(tr, name)


def count(name: str, n=1) -> None:
    """Add n (an int, or a tensor whose elements are summed at read()) to
    counter `name` of the innermost open span while tracing is on."""
    tr = _active
    if tr is None:
        return
    tr.count(name, n)


@contextlib.contextmanager
def tracing():
    """Turn tracing on for the enclosed block, recording into a new
    PhaseTimers, which the context yields."""
    global _active
    tr = PhaseTimers()
    prev, _active = _active, tr
    try:
        yield tr
    finally:
        _active = prev


class Span(NamedTuple):
    name: str
    parent: int | None     # index of the enclosing span in Records.spans
    step: int              # shared by a root span and every span inside it
    host_ns: tuple         # (start, end), time.perf_counter_ns
    t0_ms: float           # device start and end, ms from the first
    t1_ms: float           # span's start (host times on the CPU)
    counts: dict           # counters added while this span was innermost

    @property
    def ms(self) -> float:
        return self.t1_ms - self.t0_ms


class Records(NamedTuple):
    spans: list            # Span, in the order they were opened
    counters: dict         # every counter's total, inside spans or not

    def self_ms(self, i: int) -> float:
        """Span i's device ms less the part its children cover."""
        return _self_ms(self.spans[i], [c for c in self.spans if c.parent == i])


def _self_ms(s: Span, children) -> float:
    covered, end = 0.0, s.t0_ms
    for a, b in sorted((c.t0_ms, c.t1_ms) for c in children):
        a, b = max(a, end), min(b, s.t1_ms)
        if b > a:
            covered += b - a
            end = b
    return s.ms - covered


class _Open:
    """One open span (the context `span` returns while tracing is on)."""
    __slots__ = ("tr", "name", "rec", "rf")

    def __init__(self, tr, name):
        self.tr, self.name = tr, name

    def __enter__(self):
        self.rec = self.tr._begin(self.name)
        self.rf = record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        self.tr._end(self.rec)
        return False


class PhaseTimers:
    """The tracer's records: spans and counters, held in memory until
    `read()`. Whether spans record CUDA events is decided at the first span
    of a recording (after construction or a `read()`): they do when the
    card is in use by then."""

    def __init__(self):
        self._recs = []        # [name, parent, step, h0, h1, e0, e1, counts]
        self._open = []        # indices of the open spans, innermost last
        self._outside = {}     # counters added with no span open
        self._steps = 0
        self._cuda = False

    def _event(self):
        if not self._cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _begin(self, name: str) -> list:
        if not self._recs:
            self._cuda = torch.cuda.is_initialized()
        parent = self._open[-1] if self._open else None
        if parent is None:
            step = self._steps
            self._steps += 1
        else:
            step = self._recs[parent][2]
        h0 = time.perf_counter_ns()
        rec = [name, parent, step, h0, None, self._event(), None, {}]
        self._open.append(len(self._recs))
        self._recs.append(rec)
        return rec

    def _end(self, rec: list) -> None:
        rec[6] = self._event()
        rec[4] = time.perf_counter_ns()
        self._open.pop()

    def phase(self, name: str):
        """A span recorded into this tracer whether or not tracing is on
        (the JAX package's accumulating phase)."""
        return _Open(self, name)

    def count(self, name: str, n=1) -> None:
        c = self._recs[self._open[-1]][7] if self._open else self._outside
        if isinstance(n, torch.Tensor):
            c.setdefault(name, []).append(n)
        else:
            c[name] = c.get(name, 0) + n

    def read(self) -> Records:
        """Synchronise once, resolve the events and the counters, and
        return the records, clearing them."""
        if self._open:
            raise RuntimeError("read() with spans open: "
                               + ", ".join(self._recs[i][0] for i in self._open))
        if self._recs and not self._cuda and torch.cuda.is_initialized():
            raise RuntimeError("the card was first used after the first span "
                               "of these records: their times are the host's")
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        recs, outside = self._recs, self._outside
        self._recs, self._outside = [], {}
        totals = {}

        def resolve(c):
            out = {}
            for k, v in c.items():
                if isinstance(v, list):
                    v = sum(t.sum() for t in v).item()
                out[k] = v
                totals[k] = totals.get(k, 0) + v
            return out

        spans = []
        if recs:
            ref_ev, ref_h = recs[0][5], recs[0][3]
        for name, parent, step, h0, h1, e0, e1, c in recs:
            if e0 is not None:
                t0, t1 = ref_ev.elapsed_time(e0), ref_ev.elapsed_time(e1)
            else:
                t0, t1 = (h0 - ref_h) * 1e-6, (h1 - ref_h) * 1e-6
            spans.append(Span(name, parent, step, (h0, h1), t0, t1, resolve(c)))
        resolve(outside)
        return Records(spans, totals)

    def report(self, records: Records | None = None) -> str:
        """The per-span table (device ms; `%` of the root spans' total),
        from `records` or from `read()`."""
        r = self.read() if records is None else records
        kids = {}
        for c in r.spans:
            kids.setdefault(c.parent, []).append(c)
        tot, self_ms, calls = {}, {}, {}
        for i, s in enumerate(r.spans):
            tot[s.name] = tot.get(s.name, 0.0) + s.ms
            self_ms[s.name] = (self_ms.get(s.name, 0.0)
                               + _self_ms(s, kids.get(i, ())))
            calls[s.name] = calls.get(s.name, 0) + 1
        root = sum(s.ms for s in r.spans if s.parent is None) or 1.0
        lines = [f"{'span':<24}{'total_ms':>12}{'calls':>8}{'avg_ms':>10}"
                 f"{'self_ms':>12}{'%':>7}"]
        for name, t in sorted(tot.items(), key=lambda kv: -kv[1]):
            n = calls[name]
            lines.append(f"{name:<24}{t:>12.3f}{n:>8}{t / n:>10.3f}"
                         f"{self_ms[name]:>12.3f}{100 * t / root:>7.1f}")
        for name, v in sorted(r.counters.items()):
            lines.append(f"{name:<24}{v:>12}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(out_dir: str):
    """torch.profiler trace of the enclosed work (host, and the card when one
    is in use), written to <out_dir>/trace.json (chrome://tracing,
    perfetto). Spans of an active tracer appear in it as user annotations."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
