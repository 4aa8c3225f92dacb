"""One run of one cell: set-up, the measured window, then (with --trace 1) a
segment of synchronised spans and a profiled stretch, then the check.

The printed line's `metrics` are the cell's end-to-end metrics with
--trace 0 and its per-layer metrics with --trace 1, each read by its own
module under benchmark/metrics/ from the `Run` record below.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time

import torch

from . import case, check, march, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "deepflame_tpu")

# Measurement policy, the same for every cell: warm-up steps in set-up;
# after the window (--trace 1) spans over one whole segment, then
# TRACE_FROM_STEP steps into the next, TRACE_STEPS steps under the
# device-only profiler and GAP_STEPS under the host and device profiler
# (idle gaps by host operation, for the breakdown only).
WARMUP_STEPS = 2
TRACE_FROM_STEP = 1
TRACE_STEPS = 2
GAP_STEPS = 1


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    config: dict
    traffic: dict
    cells: int
    n_species: int
    setup_s: float
    steps: int                # steps of the measured window
    wall_s: float             # its wall seconds
    peak_bytes: int
    spans: list = None        # per step of the span stretch (--trace 1)
    trace: trace.Trace = None  # the profiled stretch (--trace 1)
    power_limit_w: float = None


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", "0"], capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool,
        t_start: float, device="cuda"):
    """Returns (result dict without `checks`, the compared numbers)."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    phases = {"imports and card": time.perf_counter() - t_start}
    config, traffic = cell.config, cell.traffic
    solver, species = case.build_solver(config, device)
    _sync(device)
    phases["solver"] = time.perf_counter() - t_start
    inputs = case.make_inputs(config, traffic, seed, species, device)
    solver = case.with_nets(solver, config, inputs.weights)
    s0 = solver.initial_state(inputs.p, inputs.T, inputs.Y, inputs.U)
    _sync(device)
    phases["inputs"] = time.perf_counter() - t_start
    dt, K = traffic["dt_s"], traffic["segment_steps"]
    warm = march.March(solver, s0, dt, K, capture=-1)
    for _ in range(WARMUP_STEPS):
        warm.step()
    del warm
    m = march.March(solver, s0, dt, K, inputs.capture_step)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    phases["warm-up"] = setup_s
    print("set-up, seconds from the start to the end of each phase: "
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()),
          file=sys.stderr, flush=True)

    steps, wall = march.window(m, seconds)
    while m.captured is None:
        m.step()
    failed = m.close()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rec = Run(config=config, traffic=traffic, cells=s0.T.numel(),
              n_species=len(species),
              setup_s=setup_s, steps=steps, wall_s=wall, peak_bytes=peak)
    if traced:
        # spans over one whole segment, the profile at a fixed step of the
        # next: every traced run reads the same mix of steps
        while m.k:
            m.step()
        rec.spans = march.span_stretch(m, K, config["dfodenet"]["frozen_T"])
        for _ in range(TRACE_FROM_STEP):
            m.step()
        rec.trace = trace.record(m.step, TRACE_STEPS, GAP_STEPS)
    captured = m.captured
    del m, solver, s0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        rec.power_limit_w = power_limit()

    judge = check.Judge(config, case.mech_path(config), species,
                        inputs.weights, dt, device)
    numbers = judge.numbers(*captured)
    del captured, judge
    correct = check.verdict(numbers, cell.limits) and failed == 0

    metrics = {}
    for entry in (cell.per_layer if traced else cell.end_to_end):
        value = spec.metric_reader(entry["name"])(rec)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": steps, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = {
            "device_ops": trace.top(rec.trace.device_s),
            "idle_gaps": trace.top(rec.trace.idle_by_host)}
    result["power_limit_w"] = rec.power_limit_w
    return result, numbers


def report(result: dict, numbers: dict, limits: dict) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, and the result line, with them under its last key, as
    the last line on standard output."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in check.NAMES}
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(f"check failed_steps {result['failed']} limit 0", file=sys.stderr)
    print(f"correct {str(result['correct']).lower()}", file=sys.stderr, flush=True)
    result["checks"] = checks
    print(json.dumps(result), flush=True)


def main(argv=None, t_start=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, numbers = run(cell, args.seed, args.seconds, bool(args.trace),
                          t_start)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules the benchmark may not load: {bad}",
              file=sys.stderr)
        return 3
    report(result, numbers, cell.limits)
    return 0
