"""The program's own spans and counters, and the device's idle split by
them, over whole segments of the march.

- `spans(step, steps)`: `steps` steps (a whole segment) with the program's
  tracer on (`deepflame_torch.runtime.timers`) and no profiler, ended by
  the tracer's one synchronise: per step the device ms of each span name
  and the counters. It runs before any profiler session of the run: after
  one, the host's launches stay slower in the process and the Krylov
  loops, host-paced, leave the card waiting longer (PERF.md, section 6). A
  whole segment keeps the later stretches at their steps of a segment and
  reads the same steps as `flow_ms`.
- `idle(step, steps)`: `steps` more steps (a whole segment) under the
  device-only profiler (CUDA activity: no host operation is recorded),
  tracing on; the device idle of that stretch, split by step (the root
  span begun last before the gap's middle) and by the innermost program
  span open on the host at the middle of each gap, and printed as a table
  on standard error. Gaps are found from the device's kernel and
  copy records only (user annotations are left out). The spans' host
  intervals are put on the profiler's clock by the tracer's own CUDA event
  records, which the profiler sees as runtime calls, one for each span
  end, in order; where they do not pair one for one, it raises.
"""
from __future__ import annotations

import bisect
import sys
import time

import torch

from deepflame_torch.runtime.timers import tracing

# the runtime call behind torch.cuda.Event.record, by PyTorch version
EVENT_RECORD = ("cudaEventRecord", "cudaEventRecordWithFlags")


def spans(step, steps: int) -> dict:
    torch.cuda.synchronize()
    with tracing() as tr:
        for _ in range(steps):
            step()
    per_step = [{"spans": {}, "counters": {}} for _ in range(steps)]
    for s in tr.read().spans:
        d = per_step[s.step]
        d["spans"][s.name] = d["spans"].get(s.name, 0.0) + s.ms
        for k, v in s.counts.items():
            d["counters"][k] = d["counters"].get(k, 0) + v
    return {"steps": per_step}


def idle(step, steps: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tracing() as tr:
            for _ in range(steps):
                step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    recs = tr.read()
    names = {s.name for s in recs.spans}
    dev, marks = [], []
    for e in prof.events():
        r = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if e.name not in names and not getattr(e, "is_user_annotation",
                                                   False):
                dev.append(r)
        elif e.name in EVENT_RECORD:
            marks.append(r)
    del prof
    host = _host_intervals(recs.spans, sorted(marks))
    roots = {s.name for s in recs.spans if s.parent is None}
    w0 = host[0][0]
    w1 = max([h[1] for h in host] + [b for _, b in dev])
    busy, gaps = _gaps(dev, w0, w1)
    idle_by_span = _label(gaps, host, [a for a, _, n in host if n in roots])
    _print_table(idle_by_span)
    return {"steps": steps, "window_s": window_s,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "idle_s": sum(b - a for a, b in gaps) * 1e-6,
            "idle_by_span": idle_by_span}


def _gaps(dev, w0=None, w1=None):
    """The union of the device intervals and the gaps between them, within
    [w0, w1] (the first interval's start to the last's end by default)."""
    busy = []
    for a, b in sorted(dev):
        if w0 is not None:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    if not busy:
        return busy, []
    lo = busy[0][0] if w0 is None else w0
    hi = busy[-1][1] if w1 is None else w1
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return busy, gaps


def _host_intervals(spans, marks):
    """(start, end, name) of each span on the profiler's clock, in order of
    start, from the event records' host times, which pair one for one with
    the spans' ends (else it raises)."""
    ends = sorted([(s.host_ns[0], i, 0) for i, s in enumerate(spans)]
                  + [(s.host_ns[1], i, 1) for i, s in enumerate(spans)])
    if len(marks) != len(ends) or not spans:
        raise RuntimeError(f"program spans: {len(marks)} event records for "
                           f"{len(ends)} span ends; idle cannot be split")
    at = [[None, None] for _ in spans]
    for (_, i, k), (a, b) in zip(ends, marks):
        at[i][k] = a if k == 0 else b
    return sorted((a, b, s.name) for (a, b), s in zip(at, spans))


def _label(gaps, host, steps) -> list:
    """Idle seconds by the innermost span open at each gap's middle (the
    latest-starting span that holds it: spans nest), a dict for each step:
    a gap belongs to the step whose root span began last before its middle
    (`steps`, the roots' starts in order)."""
    starts = [h[0] for h in host]
    out = [{} for _ in steps]
    for a, b in gaps:
        m = 0.5 * (a + b)
        label = "no span"
        for j in range(bisect.bisect_right(starts, m) - 1, -1, -1):
            if host[j][1] >= m:
                label = host[j][2]
                break
        d = out[max(bisect.bisect_right(steps, m) - 1, 0)]
        d[label] = d.get(label, 0.0) + (b - a) * 1e-6
    return out


def krylov_idle_s(idle_by_span) -> list:
    """Each step's idle seconds in gaps whose innermost span is a solve."""
    return [sum(v for k, v in d.items() if k.startswith("krylov."))
            for d in idle_by_span]


def _print_table(idle: list) -> None:
    print("device idle by program span, ms a step (mean over steps):",
          file=sys.stderr)
    tot = {}
    for d in idle:
        for k, v in d.items():
            tot[k] = tot.get(k, 0.0) + v
    for name, s in sorted(tot.items(), key=lambda kv: -kv[1]):
        print(f"  {name:<24}{1e3 * s / len(idle):10.3f}", file=sys.stderr)
    print("  krylov.* by step, ms: " + ", ".join(
        f"{1e3 * s:.3f}" for s in krylov_idle_s(idle)), file=sys.stderr)


def span_ms(run, names) -> float | None:
    """Mean device ms a step of the spans named `names`, summed; None
    without a program record or where a step lacks one of them."""
    p = getattr(run, "program", None)
    if not p or not p["steps"]:
        return None
    total = 0.0
    for d in p["steps"]:
        if any(n not in d["spans"] for n in names):
            return None
        total += sum(d["spans"][n] for n in names)
    return total / len(p["steps"])


def counter(run, name) -> float | None:
    """The counter's total over the stretch's steps; None without it."""
    p = getattr(run, "program", None)
    if not p or not p["steps"]:
        return None
    vals = [d["counters"][name] for d in p["steps"] if name in d["counters"]]
    return sum(vals) if vals else None
