"""Readings that the limits of `correct` and a traffic mix's segment length
are set from; not run by the benchmark's own runs.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 [--control 1]
        [--scan-steps N] [--out FILE]

For each seed, in one process: the program's compared numbers at the step
a run of that seed compares (the same set-up, weights, field and step),
with --control 1 the control's numbers at the same step (the reference in
the precision below the configuration's, check.Judge.control), and with
--scan-steps N the range of T after each of N steps marched from the
initial field without restarts. Beside the rate gap of each species, a
witness: the same gaps of the program's chemistry at that step's input
through mlp_fused and through its plain version (ops.kernels.
mlp_fused_plain). One JSON line a seed on standard output and in FILE.
"""
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path[:0] = [str(BENCH), str(ROOT)]


def scan(solver, s0, dt, steps):
    """(min T, max T, all finite) after each step, no restarts."""
    import torch
    out, s = [], s0
    for _ in range(steps):
        s, _ = solver.step(s, dt)
        fin = bool(torch.isfinite(s.T).all() & torch.isfinite(s.U).all()
                   & torch.isfinite(s.p).all())
        out.append((float(s.T.min()), float(s.T.max()), fin))
    return out


def witness(chem, s_in, dt, judge, species):
    """Per-species gaps against the reference of the program's rates at
    `s_in` through mlp_fused and through its plain version."""
    import torch
    from deepflame_torch.chemistry import dnn
    from deepflame_torch.ops.kernels import mlp_fused_plain
    from harness import check
    RR_ref = judge.rates(check.state_dict(s_in, torch.float64))
    Yt = torch.movedim(s_in.Y, 0, -1)
    out, fused, chunk = {}, dnn.mlp_fused, chem.net.chunk
    try:
        for tag, fn in (("mlp_fused", fused), ("plain", mlp_fused_plain)):
            dnn.mlp_fused, chem.net.chunk = fn, 65536
            RR = chem.correct(s_in.T, s_in.p, Yt, dt).RR
            out[tag] = dict(zip(species, check.rate_gaps(
                torch.movedim(RR, -1, 0).to(torch.float64), RR_ref)))
            del RR
    finally:
        dnn.mlp_fused, chem.net.chunk = fused, chunk
    return out


def readings(cell, seed, control, scan_steps, device, solver0=None,
             species=None):
    import torch
    from harness import case, check, march
    config, traffic = cell.config, cell.traffic
    if solver0 is None:
        solver0, species = case.build_solver(config, device)
    inputs = case.make_inputs(config, traffic, seed, species, device)
    solver = case.with_nets(solver0, config, inputs.weights)
    s0 = solver.initial_state(inputs.p, inputs.T, inputs.Y, inputs.U)
    dt = traffic["dt_s"]
    m = march.March(solver, s0, dt, traffic["segment_steps"],
                    inputs.capture_step)
    while m.captured is None:
        m.step()
    captured = m.captured
    chem = m.tap.inner
    out = {"seed": seed, "capture_step": inputs.capture_step,
           "hot_at_capture": int((captured[0].T > config["dfodenet"][
               "frozen_T"]).sum()),
           "shift": inputs.shift, "hot_cells": int((s0.T > config[
               "dfodenet"]["frozen_T"]).sum())}
    if scan_steps:
        t0 = time.perf_counter()
        out["scan"] = scan(solver, s0, dt, scan_steps)
        out["scan_s_per_step"] = (time.perf_counter() - t0) / scan_steps
    del m, solver, s0
    judge = check.Judge(config, case.mech_path(config), species,
                        inputs.weights, dt, device)
    out["program"] = judge.numbers(*captured)
    out["program_rr_by_species"] = dict(zip(species, judge.rr_gaps))
    out["witness"] = witness(chem, captured[0], dt, judge, species)
    del chem
    if control:
        rr, held = judge.control(captured[0])
        out["control"] = judge.numbers(captured[0], rr, held)
        out["control_rr_by_species"] = dict(zip(species, judge.rr_gaps))
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main():
    import argparse
    import torch
    from harness import case, spec
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--scan-steps", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args()
    cell = spec.load_cell(args.workload)
    solver0, species = case.build_solver(cell.config, "cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(cell, seed, args.control, args.scan_steps, "cuda",
                     solver0, species)
        r["seconds"] = time.perf_counter() - t0
        r["workload"] = args.workload
        r["kind"] = torch.cuda.get_device_name(0)
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
