"""The device trace of a steady stretch of the march, and the host's view of
its idle gaps.

- busy, operations and device time by name: `torch.profiler` with the
  device activity alone (CUPTI's kernel records, no host operations
  recorded, so that the host runs the steps as the window does) over a
  few whole steps; busy is the union of the device operations' intervals,
  the window the host clock from a synchronise before the first step to
  one after the last. (chip_smoke.py's `_profile_step` summed the device
  time of one profiled step and divided it by another step's wall time;
  here both come from one profiled stretch.)
- idle gaps by host operation, for the printed breakdown only: one more
  step profiled with the host activity too, each gap between device
  operations labelled by the innermost host operation running at its
  middle. That step runs slower under the profiler; no metric reads it.
- the kernels' launches in the stretch, with their shape arguments, from a
  spy on the program's one launch function (`deepflame_torch.ops.kernels.
  _launch`), so that each kernel's work is counted from the shapes it ran.
"""
from __future__ import annotations

import bisect
import dataclasses
import time

import torch

MARKER = "benchmark.trace_window"


@dataclasses.dataclass
class Trace:
    steps: int
    window_s: float
    busy_s: float
    n_ops: int
    device_s: dict          # device seconds by operation name
    device_n: dict          # device operations by name
    idle_by_host: dict      # idle seconds by host operation (the gap step)
    launches: list          # (kernel, form, itemsize, args) per launch


def _launch_spy(calls: list):
    """Install a recording wrapper on the program's launch function; returns
    a function that removes it (None where the program has none)."""
    try:
        from deepflame_torch.ops import kernels
        inner = kernels._launch
    except (ImportError, AttributeError):
        return None

    def spy(name, dtype, device, *args, form=""):
        calls.append((name, form, dtype.itemsize, args))
        return inner(name, dtype, device, *args, form=form)

    kernels._launch = spy

    def remove():
        kernels._launch = inner
    return remove


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def record(step, steps: int, gap_steps: int) -> Trace:
    """Run `step()` `steps` times under the device-only profiler, then
    `gap_steps` times under the host and device profiler, and read both."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = []
    remove = _launch_spy(calls)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    finally:
        if remove is not None:
            remove()
    dev = [(e.time_range.start, e.time_range.end, e.name)
           for e in prof.events() if e.device_type == DeviceType.CUDA]
    del prof
    device_s, device_n = {}, {}
    for a, b, name in dev:
        device_s[name] = device_s.get(name, 0.0) + (b - a) * 1e-6
        device_n[name] = device_n.get(name, 0) + 1
    busy = _union([(a, b) for a, b, _ in dev])
    return Trace(steps=steps, window_s=window_s,
                 busy_s=sum(b - a for a, b in busy) * 1e-6, n_ops=len(dev),
                 device_s=device_s, device_n=device_n,
                 idle_by_host=idle_gaps(step, gap_steps), launches=calls)


def idle_gaps(step, steps: int) -> dict:
    """Idle seconds between device operations, by the innermost host
    operation running at each gap's middle, over `steps` steps inside one
    marker span, profiled with host and device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with record_function(MARKER):
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
    events = list(prof.events())
    mark = [e for e in events if e.name == MARKER
            and e.device_type == DeviceType.CPU]
    w0, w1 = mark[0].time_range.start, mark[0].time_range.end
    dev, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.name == MARKER:        # its host span and its device-side copy
            continue
        if e.device_type == DeviceType.CUDA:
            if b > w0 and a < w1:
                dev.append((max(a, w0), min(b, w1)))
        elif b > a:
            host.append((a, b, e.name))
    gaps, t = [], w0
    for a, b in _union(dev):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    host.sort()
    starts = [h[0] for h in host]
    idle = {}
    for a, b in gaps:
        m = 0.5 * (a + b)
        label, i = "host: no operation", bisect.bisect_right(starts, m) - 1
        for j in range(i, max(i - 5000, -1), -1):
            if host[j][1] >= m:
                label = host[j][2]
                break
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    return idle


def kernel_time(t: Trace, part: str):
    """(device seconds, operations) of the device operations whose name
    holds `part`."""
    names = [k for k in t.device_s if part in k]
    return sum(t.device_s[k] for k in names), sum(t.device_n[k] for k in names)


def top(d: dict, k: int = 10) -> list:
    return [[name, v] for name, v in sorted(d.items(), key=lambda x: -x[1])[:k]]
