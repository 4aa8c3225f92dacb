"""Variants of the Gauss-Jordan kernels against each other, built from -D
defines that deepflame_torch/csrc/gj_inverse.cu reads.

    python3 tools/gj_inverse_ablate.py [--variants NAME,...] [--reps N]
                                       [--sweep NAME,...]

From the root of the repository, on a machine with one CUDA card and nvcc.
Each variant is one nvcc build of the source as it is, with its defines,
into build/ablate/ (all builds started together); for each it prints what
ptxas reports for every kernel instantiation (registers, spill bytes). The
port's wrapper (deepflame_torch.ops.kernels.gj_inverse) then runs on each
variant's library in turn at chip_smoke.py's shapes: n = 10 at the
chemistry's lane counts and at 2^17 lanes, n = 54 at 4,096, in float32 and
float64, W = I + 0.1 sqrt(10 / n) N(0, 1). For each variant and shape it
checks the result against the plain version (f32 1e-4, f64 1e-10 of the
largest entry) and prints one JSON line with the device ms per call from
torch.profiler over `reps` calls (six input sets in turn). The variants
named by --sweep also take n from 2 to 20 at 32,768 lanes in both types,
which shows where the register kernel stops paying. First, once: the
device ms of an empty kernel's launch, and at each shape the plain
version's and torch.linalg.inv's. The variants run in the order given and
then once more in reverse, so that a drift of the card's clocks shows as a
difference between the two passes. A variant that disagrees with the plain
version is reported and the run goes on; the exit code is then 1. It never
imports JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# name: defines (the source's defaults are the first variant)
VARIANTS = {
    "default": [],
    "reg-block-32": ["-DGJ_REG_BLOCK=32"],
    "reg-block-128": ["-DGJ_REG_BLOCK=128"],
    # float32 n = 15 in the register kernel (spill-free, 252 registers)
    "reg-to-15-f32": ["-DGJ_REG_MAX_N_F32=15"],
    # the register kernel past the defaults: where ptxas starts to spill
    "reg-to-18-and-12": ["-DGJ_REG_MAX_N_F32=18", "-DGJ_REG_MAX_N_F64=12"],
    # n = 10 in kernel 2, in both types
    "cols-from-10": ["-DGJ_REG_MAX_N_F32=9", "-DGJ_REG_MAX_N_F64=9"],
    # kernel 2 divides by the pivot instead of multiplying by its reciprocal
    "cols-divide": ["-DGJ_COLS_DIVIDE=1"],
    # tiles of kernel 2: 8 x 4 in float32; 8 x 8 (f32) and 4 x 8 (f64)
    "cols-r-8-f32": ["-DGJ_COLS_R_F32=8"],
    "cols-c-8": ["-DGJ_COLS_R_F32=8", "-DGJ_COLS_R_F64=4", "-DGJ_COLS_C=8"],
    # pivot steps unrolled a trip in kernel 2
    "cols-unroll-4": ["-DGJ_COLS_UNROLL=4"],
}
# (type, n, lanes)
SHAPES = [("f32", 10, 4096), ("f32", 10, 6912), ("f32", 10, 32768),
          ("f32", 10, 55296), ("f32", 10, 1 << 17), ("f64", 10, 4096),
          ("f64", 10, 1 << 17), ("f32", 54, 4096), ("f64", 54, 4096)]
SWEEP_L = 32768


def kernel_of(fn: str) -> str:
    """'reg f32 n=14', 'cols f64', 'empty' from a mangled kernel name."""
    m = re.search(r"gj_inverse_reg_kernelI([fd])Li(\d+)E", fn)
    if m:
        return f"reg {'f32' if m.group(1) == 'f' else 'f64'} n={m.group(2)}"
    m = re.search(r"gj_inverse_cols_kernelI([fd])E", fn)
    if m:
        return f"cols {'f32' if m.group(1) == 'f' else 'f64'}"
    return "empty" if "gj_empty_kernel" in fn else fn


def build(K, names) -> dict:
    """One nvcc per variant, all started together; the library paths."""
    out_dir = os.path.join(HERE, "build", "ablate")
    os.makedirs(out_dir, exist_ok=True)
    src = str(K.CSRC / "gj_inverse.cu")
    jobs = {}
    for name in names:
        so = os.path.join(out_dir, f"libgj_inverse-{name}.so")
        cmd = [K.find_nvcc(), *K.NVCC_FLAGS, *VARIANTS[name], "-o", so, src]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        report = {kernel_of(fn): dict(registers=regs, stack=stack,
                                      spill_stores=st, spill_loads=ld)
                  for fn, regs, stack, st, ld in K.ptxas_report(log)}
        print(json.dumps(dict(variant=name, defines=VARIANTS[name],
                              ptxas=report)))
        libs[name] = so
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweep", default="",
                    help="variants that also take the sweep over n")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gj_inverse_ablate: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepflame_torch.ops import kernels as K

    print(cs.card_line())
    names = args.variants.split(",")
    t0 = time.perf_counter()
    libs = build(K, names)
    print(f"{len(libs)} variants built in {time.perf_counter() - t0:.1f} s")
    K._libs["gj_inverse"] = ctypes.CDLL(libs[names[0]])
    print(json.dumps(dict(empty_launch_ms=cs.empty_launch_ms(torch, K))))
    g = torch.Generator(device="cuda").manual_seed(0)
    dts = {"f32": torch.float32, "f64": torch.float64}
    sweep = [s for s in args.sweep.split(",") if s]
    shapes = SHAPES + ([(d, n, SWEEP_L) for d in dts for n in range(2, 21)]
                       if sweep else [])
    cases = []
    for dname, n, L in shapes:
        sets = [(cs.gj_operand(torch, g, n, L, dts[dname]),)
                for _ in range(6)]
        ref = K.gj_inverse_plain(*sets[0])
        tol = 1e-4 if dname == "f32" else 1e-10
        cases.append((dname, n, L, sets, ref, tol))
        if (dname, n, L) in SHAPES:
            lib = [(W.permute(2, 0, 1).contiguous(),) for (W,) in sets]
            print(json.dumps(dict(
                variant="plain", dtype=dname, n=n, L=L,
                ms=cs.device_ms(torch, K.gj_inverse_plain, sets, reps=5),
                library_ms=cs.device_ms(torch, torch.linalg.inv, lib))))
    failed = 0
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            # the wrapper takes the variant's library from here on
            K._libs["gj_inverse"] = ctypes.CDLL(libs[name])
            reg = {d: K.gj_limits(dts[d])[0] for d in dts}
            for dname, n, L, sets, ref, tol in cases:
                if (dname, n, L) not in SHAPES and name not in sweep:
                    continue
                _, rel = cs.max_rel_err(torch, K.gj_inverse(*sets[0]), ref)
                if not rel <= tol:
                    failed += 1
                    print(f"FAILED {name} {dname} n={n} L={L}: {rel:.3e} "
                          f"of the largest entry, over {tol:g}")
                try:
                    ms = cs.device_ms(torch, K.gj_inverse, sets,
                                      reps=args.reps, kernel="gj_inverse_",
                                      attempts=6)
                except RuntimeError as e:   # the profiler lost records
                    print(e)
                    ms = None
                print(json.dumps(dict(
                    variant=name, dtype=dname, n=n, L=L, round=rnd,
                    kernel="reg" if n <= reg[dname] else "cols", ms=ms,
                    rel_err=rel)))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
