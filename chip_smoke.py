"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile FILE]

From the root of the repository, on a machine with one CUDA card and the CUDA
toolkit (nvcc). In order:

1. prints the card (name and power limit as nvidia-smi gives them), the
   torch and CUDA versions and whether nvcc and triton are present; builds
   the port's CUDA kernels from deepflame_torch/csrc and prints the build time;
2. holds each kernel against its plain PyTorch version on the card at the
   shapes of the main paths, and takes the device time of the kernel, the
   plain version and (where one PyTorch call computes the same function) the
   library call from torch.profiler, and the kernel wrapper's wall time per
   call with CUDA events; the fused MLP in bf16, f32 and f64;
3. checks whole steps on the card against the port's plain CPU path (the
   path the CPU tests hold against the JAX package) on small float64 cases:
   the stiff-chemistry case, the DNN-chemistry case and the face-list jet;
4. drives the three main paths in float32 on the 9-species test mechanism,
   warm-up steps and then two timed steps each, with the launch counts set
   to 0 just before the timed steps and read just after:
   - the stiff path at 96^3, the 3D reacting LES Taylor-Green step
     (deepflame_torch.cases.reacting_tgv_3d_les); the stencil, Helmholtz
     and Gauss-Jordan kernels must launch;
   - the DNN path at 96^3, the same step with DF-ODENet chemistry in bf16
     (deepflame_torch.cases.reacting_tgv_3d_les_dnn); the stencil and
     Helmholtz kernels must launch, and the fused MLP once per step;
   - the face-list path, the 3D LES jet flame on a 128 x 64 x 64 blockMesh
     mesh (deepflame_torch.cases.jet_flame_3d_les_fl, dt 5e-7 s, two
     warm-up steps as bench.py takes); the ELL SpMV and Gauss-Jordan
     kernels must launch;
5. runs the DNN case through the case runtime at 32^3 (a CaseConfig, the
   solver factory with an npz checkpoint of seeded weights, run_case with
   splittingStrategy, one checkpoint, then a restart from it);
6. prints one JSON line of kernel figures, then, as the last line,
   {"ok": true, "device": {...}}.

Any failure raises, so the exit code is not 0 and no result line is printed.
With no CUDA device it exits with code 2 before doing anything. It never
imports JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
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
N_MAIN, STEPS = 96, 2          # main paths: cells per side, timed steps
N_RUNTIME = 32                 # runtime phase: cells per side
DT = 2.5e-7                    # step of the TGV cases [s]
N_JET, JET_DT = 64, 5e-7       # face-list jet: (2n, n, n) cells; its step [s]
# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12        # float32 outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12    # bf16 on the tensor cores, dense


def bound_ms(n_bytes: float, n_flops: float,
             flop_rate: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """Least time for the work: bytes over memory rate vs operations over
    the peak rate of their type (default float32 outside the tensor cores),
    whichever is larger."""
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, n_flops / flop_rate
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def device_ms(torch, fn, arg_sets, reps: int = 20, warm: int = 3,
              kernel: str | None = None, attempts: int = 3) -> float:
    """Device time per call of fn(*args): the summed durations of the device
    operations that `reps` calls launch, as torch.profiler records them
    (host dispatch and the gaps between operations are not counted). The
    calls cycle through arg_sets, more than the 50 MB L2 cache together, so
    each call reads cold inputs. With `kernel` given, every device operation
    recorded must be that kernel, and the time is the mean over the launches
    recorded (the profiler has been seen to drop one record of twenty long
    launches). A profiled window that records no device operation, or the
    wrong kernel count, is profiled again, up to `attempts` windows in all:
    the profiler has been seen to return a window with no device record."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(warm):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        named = (len(dev) if kernel is None
                 else sum(kernel in e.name for e in dev))
        ok = bool(dev) and (kernel is None or (
            named == len(dev) and reps - 1 <= named <= reps))
        if ok:
            break
        print(f"profiled window {attempt + 1} of {attempts}: {len(dev)} "
              f"device operations ({named} named {kernel}) for {reps} calls")
    check(dev, "the profiler recorded no device operation")
    check(ok, f"{kernel}: {named} of {len(dev)} device operations for {reps} "
              f"calls")
    return sum(e.time_range.elapsed_us() for e in dev) / (
        named if kernel is not None else reps) / 1e3


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
            library_fn=None, library_sets=None, reps: int = 20) -> dict:
    """Device ms of the kernel, its plain version and the library call, and
    the kernel wrapper's wall ms per call."""
    return dict(
        ms=device_ms(torch, kernel_fn, sets, reps=reps, kernel=kernel),
        call_ms=call_ms(torch, kernel_fn, sets, reps=reps),
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


def phase_kernels(torch, K, jet_conn) -> dict:
    """Each kernel against its plain version at main-path shapes; jet_conn:
    the face-list jet's ELL connectivity (its solver's p_ell)."""
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
    out["mlp_fused"] = _mlp_figures(torch, K, g)
    out["ell_matvec"] = _ell_figures(torch, K, g, jet_conn)
    for name, f in out.items():
        print(f"{name}: kernel {f['ms']:.4f} ms on the device "
              f"({f['call_ms']:.4f} ms per wrapper call back to back), "
              f"plain {f['plain_ms']:.4f} ms, library {f['library_ms']} ms, "
              f"bound {f['bound_ms']:.4f} ms ({f['bound_by']})")
    return out


def _mlp_operands(torch, g, wdt, B, S=8, F=11, hidden=(1600, 800, 400)):
    """Operands of mlp_fused at the DNN path's widths: He-scaled normal
    weights (the first layer padded with zero rows to 16, as DFODENet
    stacks it), small biases, x of unit scale."""
    dev = "cuda"
    xdt = torch.float32 if wdt == torch.bfloat16 else wdt
    sizes = (F,) + hidden + (1,)
    Ws, bs = [], []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        W = torch.randn((S, a, b), generator=g, device=dev) * (2.0 / a) ** 0.5
        if i == 0:
            W = torch.nn.functional.pad(W, (0, 0, 0, (-a) % 16))
        Ws.append(W.to(wdt).contiguous())
        bs.append((0.1 * torch.randn((S, b), generator=g, device=dev)).to(xdt))
    x = torch.randn((B, F), generator=g, device=dev).to(xdt)
    return x, Ws, bs


def _mlp_work(B, S, F, Ws, wsize, xsize) -> tuple[float, float]:
    """(bytes, operations) of one call: x, weights, biases and out once;
    two operations per multiply-add of the four layers (unpadded)."""
    widths = [F] + [W.shape[2] for W in Ws]
    macs = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    n_bytes = (B * F * xsize + S * macs * wsize + S * sum(widths[1:]) * xsize
               + B * S * xsize)
    return n_bytes, 2.0 * B * S * macs


def _mlp_figures(torch, K, g) -> dict:
    """mlp_fused against its plain version: bf16 at the DNN main path's one
    call (B = 96^3 cells, S = 8, widths 11 -> 1600 -> 800 -> 400 -> 1; the
    plain version in 2^17-lane chunks), float32 at B = 2^14 and float64 at
    B = 2^12. Tolerances relative to the largest |out|: bf16 2e-3 (a sum in
    another order can move one bf16 rounding of an activation), f32 1e-5,
    f64 1e-12. No single PyTorch call computes the four-layer MLP, so the
    library time is null; the cuBLAS chain (four torch.baddbmm and three
    F.gelu in bf16, 2^17 lanes at a time) is printed as a yardstick. The
    port never calls it."""
    import torch.nn.functional as F_nn

    chunk = 1 << 17
    rows = {}
    for wdt, B, tol, name in ((torch.bfloat16, N_MAIN ** 3, 2e-3, "bf16"),
                              (torch.float32, 1 << 14, 1e-5, "f32"),
                              (torch.float64, 1 << 12, 1e-12, "f64")):
        sets = [_mlp_operands(torch, g, wdt, B)]
        x, Ws, bs = sets[0]
        sets.append((torch.randn(x.shape, generator=g, device="cuda").to(
            x.dtype), Ws, bs))
        plain = lambda x_, W_, b_: K.mlp_fused_plain(x_, W_, b_, chunk=chunk)
        err, rel = max_rel_err(torch, K.mlp_fused(x, Ws, bs), plain(x, Ws, bs))
        print(f"mlp_fused {name} B={B} S=8 widths 11-1600-800-400-1: max abs "
              f"err {err:.3e}, rel {rel:.3e} (tolerance {tol:g} of the "
              f"largest |out|)")
        check(rel <= tol, f"mlp_fused {name} disagrees with its plain version")
        n_bytes, flops = _mlp_work(B, 8, 11, Ws, Ws[0].element_size(),
                                   x.element_size())
        if wdt == torch.bfloat16:
            b_ms, b_by = bound_ms(n_bytes, flops, BF16_TC_FLOP_PER_S)
        elif wdt == torch.float32:
            b_ms, b_by = bound_ms(n_bytes, flops)
        else:   # bounded here by its bytes alone (no float64 peak is used)
            b_ms, b_by = bound_ms(n_bytes, 0.0)
        rows[name] = dict(
            route="cuda", source="deepflame_torch/csrc/mlp_fused.cu",
            replaces=f"{PALLAS}:69 (mlp_fused_lanes)", max_abs_err=err,
            **timings(torch, K.mlp_fused, "mlp_fused_", plain, sets,
                      plain_reps=2, reps=5 if name == "bf16" else 20),
            bound_ms=b_ms, bound_by=b_by, shape=[B, 8, 11], dtype=name)
    # the cuBLAS chain on the bf16 operands
    x, Ws, bs = _mlp_operands(torch, g, torch.bfloat16, N_MAIN ** 3)
    xs = [torch.nn.functional.pad(x[i:i + chunk], (0, 5)).to(torch.bfloat16)
          [None].expand(8, -1, -1).contiguous() for i in range(0, len(x), chunk)]
    bb = [b.to(torch.bfloat16)[:, None, :] for b in bs]

    def chain(xs_):
        for h in xs_:
            for i in range(4):
                h = torch.baddbmm(bb[i], h, Ws[i])
                if i < 3:
                    h = F_nn.gelu(h)
    rows["bf16"]["cublas_chain_ms"] = device_ms(torch, chain, [(xs,)], reps=3,
                                                warm=1)
    del xs
    for name in ("f32", "f64"):
        print(f"mlp_fused {name} figures: " + json.dumps(rows[name]))
    return rows["bf16"]


def _ell_csr(torch, diag, nbr, coef, side):
    """The same matrix as a CSR tensor (diagonal plus the non-pad slots,
    columns sorted in each row), for the cuSPARSE yardstick."""
    n = diag.shape[0]
    rows = torch.arange(n, device=diag.device, dtype=torch.int64)[:, None]
    cols = torch.cat([rows, nbr.long()], 1)
    vals = torch.cat([diag[:, None], coef], 1)
    keep = torch.cat([torch.ones_like(side[:, :1], dtype=torch.bool),
                      side != 0], 1)
    cols, order = torch.where(keep, cols, n).sort(1)
    vals = torch.gather(vals, 1, order)
    keep = cols < n
    crow = torch.zeros(n + 1, dtype=torch.int64, device=diag.device)
    crow[1:] = keep.sum(1).cumsum(0)
    return torch.sparse_csr_tensor(crow, cols[keep], vals[keep], (n, n))


def _ell_figures(torch, K, g, conn) -> dict:
    """ell_matvec against its plain version on the jet's own ELL
    connectivity (128 x 64 x 64 cells, w = 6, pads at the row with
    coefficient 0) with seeded random diag, coef and x, in float32 (the main
    path's type) and float64. Tolerance: 1e-6 (f32) and 1e-14 (f64) of the
    largest |out|, the order of a six-term sum. Library time: cuSPARSE SpMV
    (A_csr @ x) on the same matrix as a CSR tensor built outside the timed
    call. Bound: bytes (x, diag, nbr, coef and out once) over the memory
    rate; 2(w + 1) operations per row do not bind."""
    _, side, nbr = conn
    n, w = nbr.shape
    tol = {torch.float32: 1e-6, torch.float64: 1e-14}
    rows = {}
    for dt in (torch.float32, torch.float64):
        sets, lib_sets = [], []
        for _ in range(4):              # > 50 MB of operands: cold reads
            coef = torch.where(side != 0, torch.randn(
                (n, w), generator=g, device="cuda", dtype=dt), 0.0)
            diag = torch.rand(n, generator=g, device="cuda", dtype=dt) + 6.0
            x = torch.randn(n, generator=g, device="cuda", dtype=dt)
            sets.append((x, diag, nbr.clone(), coef))
            lib_sets.append((_ell_csr(torch, diag, nbr, coef, side), x))
        err, rel = max_rel_err(torch, K.ell_matvec(*sets[0]),
                               K.ell_matvec_plain(*sets[0]))
        name = "f32" if dt == torch.float32 else "f64"
        print(f"ell_matvec n={n} w={w} {name}: max abs err {err:.3e}, rel "
              f"{rel:.3e} (tolerance {tol[dt]:g} of the largest |out|)")
        check(rel <= tol[dt], f"ell_matvec {name} disagrees with its plain "
                              f"version")
        size = dt.itemsize
        n_bytes = (3 * size + w * 4 + w * size) * n
        # float64 is bounded here by its bytes alone (no float64 peak used)
        b_ms, b_by = bound_ms(n_bytes, 2 * (w + 1) * n
                              if dt == torch.float32 else 0.0)
        rows[name] = dict(
            route="cuda", source="deepflame_torch/csrc/ell_matvec.cu",
            replaces=f"{PALLAS}:114 (ell_matvec)", max_abs_err=err,
            **timings(torch, K.ell_matvec, "ell_matvec_kernel",
                      K.ell_matvec_plain, sets,
                      library_fn=lambda A, x_: A @ x_, library_sets=lib_sets),
            bound_ms=b_ms, bound_by=b_by, shape=[n, w], dtype=name)
    print("ell_matvec f64 figures (bound: bytes only): "
          + json.dumps(rows["f64"]))
    return rows["f32"]


# kernels each path must launch during its timed steps
PATH_KERNELS = {"stiff": ("stencil7_apply", "helmholtz7_apply", "gj_inverse"),
                "dnn": ("stencil7_apply", "helmholtz7_apply", "mlp_fused"),
                "fl": ("ell_matvec", "gj_inverse")}
STEP_DT = {"stiff": DT, "dnn": DT, "fl": JET_DT}


def _build_case(path: str, n: int, dtype, device=None, **kw):
    from deepflame_torch.cases import (jet_flame_3d_les_fl, reacting_tgv_3d_les,
                                       reacting_tgv_3d_les_dnn)
    if path == "stiff":
        return reacting_tgv_3d_les(MECH, n=n, dtype=dtype, device=device, **kw)
    if path == "fl":
        return jet_flame_3d_les_fl(MECH, n=n, dtype=dtype, device=device, **kw)
    return reacting_tgv_3d_les_dnn(MECH, n=n, dtype=dtype, device=device, **kw)


def phase_reference(torch, K) -> None:
    """Two float64 steps of each n = 8 case on the card (kernels) against
    the port's CPU path (plain versions). The DNN case computes its MLP in
    float64 (the f64 kernel) with the same seeded weights on both sides; the
    face-list jet is 16 x 8 x 8 cells."""
    for path, kw in (("stiff", {}), ("dnn", {"compute_dtype": None}),
                     ("fl", {})):
        before = dict(K.launches)
        results = {}
        for dev in ("cuda", "cpu"):
            solver, state = _build_case(path, 8, torch.float64, device=dev,
                                        **kw)
            for _ in range(2):
                state, _ = solver.step(state, STEP_DT[path])
            results[dev] = state
        check(all(K.launches[k] > before[k] for k in PATH_KERNELS[path]),
              f"{path} reference step on the card did not launch "
              f"{PATH_KERNELS[path]}")
        worst = 0.0
        for k in ("p", "T", "U", "Y", "rho", "ha"):
            _, rel = max_rel_err(torch, getattr(results["cuda"], k).cpu(),
                                 getattr(results["cpu"], k))
            worst = max(worst, rel)
            # round-off: sums taken in another order on the card (see
            # tests/test_torch_low_mach.py for the same bound against JAX)
            check(rel <= (1e-6 if k == "U" else 1e-8),
                  f"{path} reference {k}: {rel:.3e}")
        print(f"reference ({path}): n=8 float64, 2 steps on the card vs the "
              f"CPU path: largest field deviation {worst:.3e} of the field's "
              f"largest value")


def build_jet(torch, n: int):
    """The face-list jet at (2n, n, n) in float32: blockMesh, then the
    solver, each timed."""
    from deepflame_torch.cases import jet_blockmesh_dict
    from deepflame_torch.mesh import build_blockmesh, parse_blockmesh_dict
    t0 = time.perf_counter()
    gm = build_blockmesh(parse_blockmesh_dict(jet_blockmesh_dict(n)))
    t1 = time.perf_counter()
    print(f"fl path: blockMesh of the jet, {gm.n_cells} cells and "
          f"{gm.owner.shape[0]} interior faces, built on the host in "
          f"{t1 - t0:.2f} s")
    solver, state = _build_case("fl", n, torch.float32, mesh=gm)
    torch.cuda.synchronize()
    print(f"fl path: jet solver and initial state built in "
          f"{time.perf_counter() - t1:.2f} s ({solver.combustion.n_bins} "
          f"chemistry bins, {len(solver.m_Y_groups)} species BC groups, "
          f"dt {JET_DT:g} s)")
    return solver, state


def _check_fl(torch, solver, state, n_cells) -> None:
    """Jet state: shapes, rows of Y summing to 1, inlet and outlet mass
    fluxes finite and of opposite sign."""
    check(state.T.shape == (n_cells,) and state.Y.shape == (n_cells, 9),
          "fl: state shapes")
    check(float((state.Y.sum(1) - 1.0).abs().max()) < 1e-5,
          "fl: mass fractions do not sum to 1")
    flux = {p.name: float((fb * p.mag_sf).sum())
            for p, fb in zip(solver.mesh.patches, state.phi_b)}
    print(f"fl boundary mass fluxes [kg/s]: {json.dumps(flux)}")
    check(all(math.isfinite(v) for v in flux.values()),
          "fl: non-finite boundary flux")
    check(flux["inlet"] < 0.0 < flux["outlet"],
          "fl: inlet and outlet mass fluxes are not of opposite sign")


def phase_main(torch, K, path: str, n: int, steps: int,
               profile: str | None, built=None) -> dict:
    """Warm-up steps (two on the jet, as bench.py takes, one on the TGV)
    and `steps` timed steps of a main path in float32; returns the launch
    counts of the timed steps. `built`: (solver, state) built already."""
    dt = STEP_DT[path]
    if built is None:
        t0 = time.perf_counter()
        solver, state = _build_case(path, n, torch.float32)
        torch.cuda.synchronize()
        comb = solver.combustion
        what = (f"{comb.n_bins} chemistry bins, sort '{comb.sort}'"
                if path == "stiff" else
                f"DF-ODENet {len(comb.net.nets)} nets "
                f"{[comb.net.nets[0][0][0].shape[0]] + [W.shape[1] for W, _ in comb.net.nets[0]]}"
                f" in {comb.net.compute_dtype}, y_std {float(comb.net.y_std[0]):g}")
        print(f"{path} path: {n}^3 float32 reacting LES TGV built in "
              f"{time.perf_counter() - t0:.2f} s ({what}, dt {dt:g} s)")
    else:
        solver, state = built
    n_cells = state.T.numel()
    for i in range(2 if path == "fl" else 1):
        t0 = time.perf_counter()
        state, diag = solver.step(state, dt)
        torch.cuda.synchronize()
        print(f"{path} warm-up step {i + 1}: {time.perf_counter() - t0:.3f} s")
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
    print(f"{path} path counts over {steps} steps: {json.dumps(counts)}")
    print(f"{path} path: {ms:.2f} ms/step, "
          f"{n_cells / (wall / steps):.4e} cell-updates/s ({n_cells} cells), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"{path} diagnostics of the last step: " + json.dumps(
        {k: float(v) for k, v in diag.items()}))
    check(all(counts[k] > 0 for k in PATH_KERNELS[path]),
          f"a kernel of the {path} path was not launched: {counts}")
    if path == "dnn":
        check(counts["mlp_fused"] == steps,
              f"mlp_fused launched {counts['mlp_fused']} times in {steps} steps")
    check(bool(torch.isfinite(state.T).all() and torch.isfinite(state.p).all()),
          f"{path}: non-finite T or p")
    check(float((state.T - T_before).abs().max()) > 0.0, f"{path}: T did not change")
    if path == "fl":
        _check_fl(torch, solver, state, n_cells)
    else:
        check(state.T.shape == (n, n, n) and state.Y.shape == (9, n, n, n),
              f"{path}: state shapes")
        check(float((state.Y.sum(0) - 1.0).abs().max()) < 1e-5,
              f"{path}: mass fractions do not sum to 1")
    if path == "dnn":
        _check_dnn_rates(torch, solver, state)
    _breakdown_step(torch, solver, state, path)
    if profile or path != "stiff":
        _profile_step(torch, solver, state, ms, profile, path)
    return counts


def _check_dnn_rates(torch, solver, state) -> None:
    """The DNN chemistry on the final state: RR zero in frozen cells
    (T <= 700 K), non-zero in the hot sphere, summing to zero per cell
    within float32 round-off of rho / delta_t; the new Y sums to 1."""
    comb = solver.combustion
    Yt = torch.movedim(state.Y, 0, -1)
    chem = comb.correct(state.T, state.p, Yt, DT)
    RR = chem.RR
    frozen = state.T <= comb.net.frozen_T
    hot = state.T > 1500.0
    rho = comb.thermo.rho(state.p, state.T, Yt)
    sum_rr = (RR.sum(-1).abs() / (rho / comb.net.delta_t)).max()
    print(f"DNN rates on the final state: {int(hot.sum())} cells above "
          f"1500 K, {int(frozen.sum())} frozen; max |RR| "
          f"{float(RR.abs().max()):.4e} kg/m^3/s; max |sum RR| / (rho / "
          f"delta_t) {float(sum_rr):.3e}")
    check(bool(torch.isfinite(RR).all()), "non-finite RR")
    check(not bool(frozen.any()) or float(RR[frozen].abs().max()) == 0.0,
          "RR non-zero in frozen cells")
    check(int(hot.sum()) > 0 and bool((RR[hot].abs().amax(-1) > 0).all()),
          "RR zero in a hot cell")
    check(float(sum_rr) <= 1e-5, "RR does not sum to zero per cell")
    check(float((chem.Y.sum(-1) - 1.0).abs().max()) < 1e-5,
          "the chemistry's Y does not sum to 1")


def _breakdown_step(torch, solver, state, path: str) -> None:
    """One more step with the chemistry call timed inside it (synchronised
    before and after), for the chemistry's share of a step: the stiff
    integrator (solve_chemistry) or the DNN model's correct()."""
    import deepflame_torch.combustion.basic as basic
    from deepflame_torch.combustion import DNNChemistry

    owner, attr = ((DNNChemistry, "correct") if path == "dnn"
                   else (basic, "solve_chemistry"))
    inner, spent = getattr(owner, attr), []

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **k)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    setattr(owner, attr, timed)
    try:
        t0 = time.perf_counter()
        solver.step(state, STEP_DT[path])
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        setattr(owner, attr, inner)
    print(f"{path} breakdown step: {total * 1e3:.2f} ms, of which chemistry "
          f"{spent[0] * 1e3:.2f} ms ({spent[0] / total:.3f})")


def _profile_step(torch, solver, state, step_ms: float, out: str | None,
                  path: str) -> None:
    """Device time by kernel over one step (the table written to `out` when
    given), the device's busy share of an unprofiled step and, on the DNN
    path, the fused MLP's share of the device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solver.step(state, STEP_DT[path])
        torch.cuda.synchronize()
    # device-side events (kernels, copies, fills) of the one stream
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    mlp_us = sum(e.time_range.elapsed_us() for e in dev
                 if "mlp_fused_" in e.name)
    print(f"{path} profiled step: device busy {busy_us / 1e3:.2f} ms in "
          f"{len(dev)} device operations; busy share of the unprofiled "
          f"{step_ms:.2f} ms step {busy_us / 1e3 / step_ms:.3f}"
          + (f"; mlp_fused {mlp_us / 1e3:.2f} ms, {mlp_us / busy_us:.3f} of "
             f"the device time" if path == "dnn" else ""))
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    if out:
        stem, ext = os.path.splitext(os.path.abspath(out))
        os.makedirs(os.path.dirname(stem), exist_ok=True)
        with open(f"{stem}_{path}{ext}", "w") as f:
            f.write(table)
    print(table[:3000])


def phase_runtime(torch, K, n: int) -> None:
    """The DNN case through the case runtime at n^3, float32: a CaseConfig
    whose torch_model is an npz of seeded weights (examples/train_dfodenet.py's
    keys), the solver factory, run_case with splittingStrategy for 4 steps
    with a checkpoint every 2, then a restart from the last checkpoint for 2
    more. The factory's DF-ODENet computes in the fields' float32 (the f32
    kernel), with chemistry on every second step."""
    import tempfile

    import numpy as np

    from deepflame_torch.chemistry.dnn import init_params
    from deepflame_torch.mesh import StructuredMesh, cyclic
    from deepflame_torch.runtime import config as C
    from deepflame_torch.runtime import latest_time
    from deepflame_torch.runtime.driver import run_case
    from deepflame_torch.runtime.factory import build_low_mach_solver

    ns = 9
    nets = init_params(torch.Generator().manual_seed(0), ns, device="cpu")
    flat = {f"net{i}_{k}{j}": t.numpy() for i, net in enumerate(nets)
            for j, Wb in enumerate(net) for k, t in zip("Wb", Wb)}
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "dfodenet.npz")
        np.savez(npz, x_mean=np.zeros(ns + 2), x_std=np.ones(ns + 2),
                 y_mean=np.zeros(ns - 1), y_std=np.full(ns - 1, 1e-6),
                 delta_t=DT, n_species=ns, n_layers=4, **flat)
        case = C.CaseConfig(
            chemistry=C.ChemistryProperties(
                mechanism_file=MECH, torch_on=True, torch_model=npz,
                frozen_temperature=700.0, inert_specie="N2"),
            combustion=C.CombustionProperties(model="DNN"),
            turbulence=C.TurbulenceProperties(simulation_type="LES",
                                              les_model="Sigma"),
            control=C.ControlDict(end_time=4 * DT, delta_t=DT,
                                  write_interval=2 * DT),
            # the flagship step's solver settings (LowMachConfig defaults)
            solution=C.SolutionControl(n_outer_correctors=1, p_tol=1e-7,
                                       p_rel_tol=1e-2),
            dtype="float32")
        L = 2.0 * math.pi * 1e-3
        mesh = StructuredMesh.box([L, L, L], [n, n, n])
        bcs = ((cyclic(), cyclic()),) * 3
        t0 = time.perf_counter()
        solver, _ = build_low_mach_solver(case, mesh, (bcs, bcs, bcs), bcs,
                                          bcs, bcs, bcs)
        _, tgv = _build_case("stiff", n, torch.float32)
        state0 = solver.initial_state(tgv.p, tgv.T, tgv.Y, tgv.U)
        print(f"runtime: {n}^3 DNN case from a CaseConfig built in "
              f"{time.perf_counter() - t0:.2f} s")
        ckpt = os.path.join(tmp, "checkpoints")
        K.reset_launches()
        t0 = time.perf_counter()
        state = run_case(solver, state0, case.control, checkpoint_dir=ckpt,
                         splitting=True, log_every=2)
        later = dataclasses.replace(case.control, end_time=6 * DT)
        restarted = run_case(solver, state0, later, checkpoint_dir=ckpt,
                             splitting=True, log_every=2, restart=True)
        torch.cuda.synchronize()
        counts = dict(K.launches)
        print(f"runtime: 4 + 2 steps in {time.perf_counter() - t0:.2f} s; "
              f"counts {json.dumps(counts)}; checkpoints at "
              f"{sorted(os.listdir(ckpt))}, latest {latest_time(ckpt):g} s")
        check(counts["mlp_fused"] == 3,
              "runtime: chemistry should run on 3 of the 6 split steps")
        check(abs(float(restarted.time) / (6 * DT) - 1.0) < 1e-6,
              "runtime: restart did not run to the end time")
        for s_ in (state, restarted):
            check(bool(torch.isfinite(s_.T).all() and torch.isfinite(s_.p).all()),
                  "runtime: non-finite T or p")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="FILE",
                    help="profile one extra step of each main path (the DNN "
                         "and face-list paths always are); write the "
                         "device-time tables to FILE with _stiff, _dnn and "
                         "_fl before its extension")
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

    jet = build_jet(torch, N_JET)
    figures = phase_kernels(torch, K, jet[0].p_ell)
    phase_reference(torch, K)
    counts = {path: phase_main(torch, K, path, N_MAIN, STEPS, args.profile)
              for path in ("stiff", "dnn")}
    counts["fl"] = phase_main(torch, K, "fl", N_JET, STEPS, args.profile,
                              built=jet)
    del jet
    phase_runtime(torch, K, N_RUNTIME)

    # each kernel's launches on its own path
    own = lambda name: {"mlp_fused": "dnn", "ell_matvec": "fl"}.get(name,
                                                                    "stiff")
    kernels = [dict(name=name, launches=counts[own(name)][name], **f)
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
