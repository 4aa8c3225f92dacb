"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile FILE]

From the root of the repository, on a machine with one CUDA card and the CUDA
toolkit (nvcc). In order:

1. prints the card (name and power limit as nvidia-smi gives them), the
   torch and CUDA versions and whether nvcc and triton are present; builds
   the port's CUDA kernels from deepflame_torch/csrc and prints the build time;
2. holds each kernel against its plain PyTorch version on the card at the
   shapes of the main path, and takes the device time of the kernel, the
   plain version and (where one PyTorch call computes the same function) the
   library call from torch.profiler, and the kernel wrapper's wall time per
   call with CUDA events;
3. checks the whole step on the card against the port's plain CPU path (the
   path the CPU tests hold against the JAX package) on a small float64 case;
4. drives the main path: the 3D reacting LES Taylor-Green step
   (deepflame_torch.cases.reacting_tgv_3d_les) at 96^3 in float32 on the
   9-species test mechanism, one warm-up step and two timed steps; every
   kernel must launch during the timed steps;
5. prints one JSON line of kernel figures, then, as the last line,
   {"ok": true, "device": {...}}.

Any failure raises, so the exit code is not 0 and no result line is printed.
With no CUDA device it exits with code 2 before doing anything. It never
imports JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MECH = os.path.join(HERE, "tests", "data", "h2_air_9sp.json")
PALLAS = "deepflame_tpu/ops/pallas_kernels.py"
N_MAIN, STEPS = 96, 2          # main path: cells per side, timed steps
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """Least time for the work: bytes over memory rate vs float32 operations
    over the non-tensor-core float32 peak, whichever is larger."""
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOP_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def device_ms(torch, fn, arg_sets, reps: int = 20, warm: int = 3,
              kernel: str | None = None) -> float:
    """Device time per call of fn(*args): the summed durations of the device
    operations that `reps` calls launch, as torch.profiler records them
    (host dispatch and the gaps between operations are not counted). The
    calls cycle through arg_sets, more than the 50 MB L2 cache together, so
    each call reads cold inputs. With `kernel` given, every call must have
    launched exactly one device operation, named with it."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(warm):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    check(dev, "the profiler recorded no device operation")
    if kernel is not None:
        named = sum(kernel in e.name for e in dev)
        check(named == reps == len(dev),
              f"{kernel}: {named} of {len(dev)} device operations for {reps} calls")
    return sum(e.time_range.elapsed_us() for e in dev) / reps / 1e3


def call_ms(torch, fn, arg_sets, reps: int = 20, warm: int = 3) -> float:
    """Wall time per call of fn(*args) back to back between two CUDA events:
    the device time, or the host's dispatch time where that is longer."""
    for i in range(warm):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def timings(torch, kernel_fn, kernel: str, plain_fn, sets, plain_reps: int = 20,
            library_fn=None, library_sets=None) -> dict:
    """Device ms of the kernel, its plain version and the library call, and
    the kernel wrapper's wall ms per call."""
    return dict(
        ms=device_ms(torch, kernel_fn, sets, kernel=kernel),
        call_ms=call_ms(torch, kernel_fn, sets),
        plain_ms=device_ms(torch, plain_fn, sets, reps=plain_reps),
        library_ms=(None if library_fn is None
                    else device_ms(torch, library_fn, library_sets)))


def max_rel_err(torch, a, b) -> tuple[float, float]:
    """(max |a - b|, max |a - b| / max |b|)."""
    err = float((a.double() - b.double()).abs().max())
    return err, err / max(float(b.double().abs().max()), 1e-300)


def check(ok, what: str) -> None:
    """Fail the run (asserts would vanish under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def phase_kernels(torch, K) -> dict:
    """Each kernel against its plain version at main-path shapes."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}

    # --- stencil: the 9-species batch at 96^3, float32
    S, n = 9, 96
    shape = (S, n, n, n)
    sets = []
    for _ in range(2):
        sets.append([torch.randn(shape, generator=g, device=dev)
                     for _ in range(2)]
                    + [tuple(torch.randn(shape, generator=g, device=dev)
                             for _ in range(3)) for _ in range(2)])
    x, D, lo, hi = sets[0]
    err, rel = max_rel_err(torch, K.stencil7_apply(x, D, lo, hi),
                           K.stencil_apply_plain(x, D, lo, hi))
    print(f"stencil7_apply {shape} f32: max abs err {err:.3e}, "
          f"rel {rel:.3e} (tolerance 1e-5 of the largest |out|)")
    check(rel <= 1e-5, "stencil7_apply disagrees with its plain version")
    cells = S * n ** 3
    b_ms, b_by = bound_ms(9 * 4 * cells, 13 * cells)
    out["stencil7_apply"] = dict(
        route="cuda", source="deepflame_torch/csrc/stencil7.cu",
        replaces=f"{PALLAS}:378 (stencil_apply_tiled)", max_abs_err=err,
        **timings(torch, K.stencil7_apply, "stencil7_kernel",
                  K.stencil_apply_plain, sets, plain_reps=5),
        bound_ms=b_ms, bound_by=b_by,
        shape=list(shape), dtype="float32")

    # --- Helmholtz: the pressure operator at 96^3, float32, main-path spacing
    h = 2.0 * math.pi * 1e-3 / n
    sp = (h, h, h)
    sets = []
    for _ in range(4):
        xp = torch.randn((n + 2,) * 3, generator=g, device=dev)
        gam = tuple(torch.rand(s, generator=g, device=dev) * 1e-6 + 1e-7
                    for s in ((n + 1, n, n), (n, n + 1, n), (n, n, n + 1)))
        d = torch.rand((n, n, n), generator=g, device=dev) * 3.0 + 1.0
        sets.append((xp, gam, d, sp))
    err, rel = max_rel_err(torch, K.helmholtz7_apply(*sets[0]),
                           K.helmholtz_apply_plain(*sets[0]))
    print(f"helmholtz7_apply {n}^3 f32: max abs err {err:.3e}, rel {rel:.3e} "
          f"(tolerance 1e-5 of the largest |out|)")
    check(rel <= 1e-5, "helmholtz7_apply disagrees with its plain version")
    n_bytes = 4 * ((n + 2) ** 3 + 3 * (n + 1) * n * n + 2 * n ** 3)
    b_ms, b_by = bound_ms(n_bytes, 22 * n ** 3)
    out["helmholtz7_apply"] = dict(
        route="cuda", source="deepflame_torch/csrc/helmholtz7.cu",
        replaces=f"{PALLAS}:438 (helmholtz_apply)",
        also_replaces=f"{PALLAS}:301 (helmholtz_apply_tiled)",
        max_abs_err=err,
        **timings(torch, K.helmholtz7_apply, "helmholtz7_kernel",
                  K.helmholtz_apply_plain, sets),
        bound_ms=b_ms, bound_by=b_by,
        shape=[n, n, n], dtype="float32")

    # --- Gauss-Jordan: n = 10 (9 species + T), L = 2^17 lanes, both dtypes.
    # W = I + 0.1 N(0, 1): condition number below ~5, like I - gamma dt J at
    # the step sizes the controller accepts.
    nn, L = 10, 1 << 17
    tol = {torch.float32: 1e-4, torch.float64: 1e-10}
    for dt in (torch.float32, torch.float64):
        sets = []
        for _ in range(6):
            W = (torch.eye(nn, device=dev, dtype=torch.float64)[:, :, None]
                 + 0.1 * torch.randn((nn, nn, L), generator=g, device=dev,
                                     dtype=torch.float64)).to(dt)
            sets.append((W,))
        err, rel = max_rel_err(torch, K.gj_inverse(*sets[0]),
                               K.gj_inverse_plain(*sets[0]))
        name = "f32" if dt == torch.float32 else "f64"
        print(f"gj_inverse n={nn} L={L} {name}: max abs err {err:.3e}, "
              f"rel {rel:.3e} (tolerance {tol[dt]:g} of the largest entry)")
        check(rel <= tol[dt], f"gj_inverse {name} disagrees with its plain version")
        lib_sets = [(W.permute(2, 0, 1).contiguous(),) for (W,) in sets]
        size = 4 if dt == torch.float32 else 8
        # float64 work is bounded here by its bytes alone (the float32
        # operation peak does not apply to it)
        flops = (2 * nn ** 3 + 3 * nn ** 2) * L if dt == torch.float32 else 0
        b_ms, b_by = bound_ms(2 * nn * nn * L * size, flops)
        figures = dict(
            route="cuda", source="deepflame_torch/csrc/gj_inverse.cu",
            replaces=f"{PALLAS}:189 (gj_inverse_lanes)", max_abs_err=err,
            **timings(torch, K.gj_inverse, "gj_inverse_kernel",
                      K.gj_inverse_plain, sets, plain_reps=5,
                      library_fn=torch.linalg.inv, library_sets=lib_sets),
            bound_ms=b_ms, bound_by=b_by, shape=[nn, nn, L], dtype=str(dt)[6:])
        if dt == torch.float32:
            out["gj_inverse"] = figures
        else:
            print("gj_inverse f64 figures (bound: bytes only): "
                  + json.dumps(figures))
    for name, f in out.items():
        print(f"{name}: kernel {f['ms']:.4f} ms on the device "
              f"({f['call_ms']:.4f} ms per wrapper call back to back), "
              f"plain {f['plain_ms']:.4f} ms, library {f['library_ms']} ms, "
              f"bound {f['bound_ms']:.4f} ms ({f['bound_by']})")
    return out


def phase_reference(torch) -> None:
    """One float64 step of the n = 8 flagship case on the card (kernels)
    against the port's CPU path (plain versions)."""
    from deepflame_torch.cases import reacting_tgv_3d_les
    from deepflame_torch.ops import kernels as K

    before = dict(K.launches)
    results = {}
    for dev in ("cuda", "cpu"):
        solver, state = reacting_tgv_3d_les(MECH, n=8, dtype=torch.float64,
                                            device=dev)
        for _ in range(2):
            state, _ = solver.step(state, 2.5e-7)
        results[dev] = state
    check(all(K.launches[k] > before[k] for k in K.launches),
          "reference step on the card did not launch every kernel")
    worst = 0.0
    for k in ("p", "T", "U", "Y", "rho", "ha"):
        _, rel = max_rel_err(torch, getattr(results["cuda"], k).cpu(),
                             getattr(results["cpu"], k))
        worst = max(worst, rel)
        # round-off: sums taken in another order on the card (see
        # tests/test_torch_low_mach.py for the same bound against JAX)
        check(rel <= (1e-6 if k == "U" else 1e-8), f"reference {k}: {rel:.3e}")
    print(f"reference: n=8 float64, 2 steps on the card vs the CPU path: "
          f"largest field deviation {worst:.3e} of the field's largest value")


def phase_main(torch, K, n: int, steps: int, profile: str | None) -> dict:
    from deepflame_torch.cases import reacting_tgv_3d_les

    dt = 2.5e-7
    t0 = time.perf_counter()
    solver, state = reacting_tgv_3d_les(MECH, n=n, dtype=torch.float32)
    torch.cuda.synchronize()
    print(f"main path: {n}^3 float32 reacting LES TGV built in "
          f"{time.perf_counter() - t0:.2f} s "
          f"({solver.combustion.n_bins} chemistry bins, sort "
          f"'{solver.combustion.sort}', dt {dt:g} s)")
    t0 = time.perf_counter()
    state, diag = solver.step(state, dt)                     # warm-up
    torch.cuda.synchronize()
    print(f"warm-up step: {time.perf_counter() - t0:.3f} s")
    T_before = state.T.clone()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, diag = solver.step(state, dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launches)
    ms = wall / steps * 1e3
    print(f"main path counts over {steps} steps: {json.dumps(counts)}")
    print(f"main path: {ms:.2f} ms/step, "
          f"{n ** 3 / (wall / steps):.4e} cell-updates/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print("diagnostics of the last step: " + json.dumps(
        {k: float(v) for k, v in diag.items()}))
    check(all(c > 0 for c in counts.values()),
          f"a kernel of the path was not launched: {counts}")
    check(bool(torch.isfinite(state.T).all() and torch.isfinite(state.p).all()),
          "non-finite T or p")
    check(state.T.shape == (n, n, n) and state.Y.shape == (9, n, n, n),
          "state shapes")
    check(float((state.T - T_before).abs().max()) > 0.0, "T did not change")
    check(float((state.Y.sum(0) - 1.0).abs().max()) < 1e-5,
          "mass fractions do not sum to 1")
    _breakdown_step(torch, solver, state, dt)
    if profile:
        _profile_step(torch, solver, state, dt, ms, profile)
    return counts


def _breakdown_step(torch, solver, state, dt) -> None:
    """One more step with the chemistry call timed inside it (synchronised
    before and after), for the chemistry's share of a step."""
    import deepflame_torch.combustion.basic as basic

    inner, spent = basic.solve_chemistry, []

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **k)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    basic.solve_chemistry = timed
    try:
        t0 = time.perf_counter()
        solver.step(state, dt)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        basic.solve_chemistry = inner
    print(f"breakdown step: {total * 1e3:.2f} ms, of which chemistry "
          f"{spent[0] * 1e3:.2f} ms ({spent[0] / total:.3f})")


def _profile_step(torch, solver, state, dt, step_ms: float, path: str) -> None:
    """Device time by kernel over one step, written to `path`, and the
    device's busy share of an unprofiled step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solver.step(state, dt)
        torch.cuda.synchronize()
    # device-side events (kernels, copies, fills) of the one stream
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    print(f"profiled step: device busy {busy_us / 1e3:.2f} ms in {len(dev)} "
          f"device operations; busy share of the unprofiled {step_ms:.2f} ms "
          f"step {busy_us / 1e3 / step_ms:.3f}")
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(table)
    print(table[:3000])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="FILE",
                    help="profile one extra step; write its device-time "
                         "table to FILE")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from deepflame_torch.ops import kernels as K

    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    print(f"nvcc: {K.find_nvcc()}, "
          f"triton: {importlib.util.find_spec('triton') is not None}")
    t0 = time.perf_counter()
    logs = K.build()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"({', '.join(logs) or 'already built'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    figures = phase_kernels(torch, K)
    phase_reference(torch)
    counts = phase_main(torch, K, N_MAIN, STEPS, args.profile)

    kernels = [dict(name=name, launches=counts[name], **f)
               for name, f in figures.items()]
    for k in kernels:
        k["kernel_ms"] = k["ms"]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
