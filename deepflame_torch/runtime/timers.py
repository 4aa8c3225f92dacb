"""Per-phase wall-clock instrumentation.

Port of deepflame_tpu/runtime/timers.py: accumulating phase timers (the
reference's time_monitor_* accumulators) and a torch.profiler trace context.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

__all__ = ["PhaseTimers", "trace"]


class PhaseTimers:
    """Accumulating wall-clock timers. With `sync` set, each phase ends with
    torch.cuda.synchronize() (when the card is in use), so it counts the
    device work it launched."""

    def __init__(self, sync: bool = True):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.sync = sync

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [f"{'phase':<24}{'total_s':>10}{'calls':>8}{'avg_ms':>10}{'%':>6}"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<24}{t:>10.3f}{n:>8}{1e3 * t / n:>10.2f}"
                         f"{100 * t / total:>6.1f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(out_dir: str):
    """torch.profiler trace of the enclosed work (host, and the card when one
    is in use), written to <out_dir>/trace.json (chrome://tracing,
    perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
