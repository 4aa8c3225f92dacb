"""Variants of the fused MLP kernel's f32 and f64 modes against each other,
built from -D defines that deepflame_torch/csrc/mlp_fused.cu reads.

    python3 tools/mlp_fused_ablate.py [--variants NAME,...] [--reps N]

From the root of the repository, on a machine with one CUDA card and nvcc.
Each variant is one nvcc build of the source as it is, with its defines,
into build/ablate/ (all builds started together). The port's wrapper
(deepflame_torch.ops.kernels.mlp_fused) then runs on each variant's library
in turn, at chip_smoke.py's shapes: f32 at B = 2^14 and f64 at B = 2^12, S
= 8, widths 11 -> 1600 -> 800 -> 400 -> 1. For each variant and mode it
checks the result against the plain version (f32 1e-5, f64 1e-12 of the
largest |out|) and prints one JSON line: device ms per call in all and by
kernel (layer 1, the GEMMs of layers 2 and 3, the layer-4 sum), from
torch.profiler over `reps` calls, and the share of chip_smoke's bound;
before each pass, the plain version's device ms (the cuBLAS chain in the
mode's type). The variants run in the order given and then once more in
reverse, so that a drift of the card's clocks shows as a difference between
the two passes.
It never imports JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# name: defines (the source's defaults are the first variant)
VARIANTS = {
    "default": [],
    "l1-x-in-registers": ["-DMLP_L1_KR=16"],
    "l1-1-block-an-sm": ["-DMLP_L1_MIN_BLOCKS=1"],
    "l1-6-blocks-an-sm": ["-DMLP_L1_MIN_BLOCKS=6"],
    "f64-mma-k8": ["-DMLP_F64_MMA_K=8"],
    "f64-mma-k16": ["-DMLP_F64_MMA_K=16"],
    "f64-stage-k16": ["-DMLP_F64_STAGE_K=16"],
    "f64-3-stages-k16": ["-DMLP_F64_STAGES=3", "-DMLP_F64_STAGE_K=16"],
    # 8 warps of 64 x 32 a block (128 columns), one block an SM
    "f64-warps-n4-3-stages": ["-DMLP_F64_WARPS_N=4", "-DMLP_F64_STAGES=3"],
    "f64-warps-n4-3-stages-k16": ["-DMLP_F64_WARPS_N=4", "-DMLP_F64_STAGES=3",
                                  "-DMLP_F64_STAGE_K=16"],
    "f32-stage-k32": ["-DMLP_F32_STAGE_K=32"],
    "f32-one-block-an-sm": ["-DMLP_F32_MIN_BLOCKS=1"],
}


def layer_of(kernel: str) -> str:
    """The layer a kernel of the f32/f64 modes computes, from its name as
    the profiler gives it, demangled (gemm_kernel<VEC, LAST>) or not."""
    if "l1_fma_kernel" in kernel:
        return "layer 1"
    if "out_kernel" in kernel:
        return "layer-4 sum"
    if "gemm_kernel<" in kernel:
        last = kernel.split("gemm_kernel<")[1].split(">")[0].endswith("true")
    else:
        last = kernel.split("gemm_kernelI")[1][:8].endswith("Lb1E")
    return "layer 3" if last else "layer 2"


def build(K, names) -> dict:
    """One nvcc per variant, all started together; the library paths."""
    out_dir = os.path.join(HERE, "build", "ablate")
    os.makedirs(out_dir, exist_ok=True)
    src = str(K.CSRC / "mlp_fused.cu")
    jobs = {}
    for name in names:
        so = os.path.join(out_dir, f"libmlp_fused-{name}.so")
        cmd = [K.find_nvcc(), *K.NVCC_FLAGS, *VARIANTS[name], "-o", so, src]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")]
        print(f"{name}: built{'; ' + '; '.join(spills) if spills else ''}")
        libs[name] = so
    return libs


def by_kernel(torch, fn, args, reps) -> tuple[float, dict]:
    """Device ms per call of fn(*args), in all and by layer."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev or any("mlp_fused_" not in e.name for e in dev):
        raise RuntimeError(f"profiled window: {[e.name for e in dev][:5]}")
    parts = {}
    for e in dev:
        part = layer_of(e.name)
        parts[part] = parts.get(part, 0.0) + e.time_range.elapsed_us()
    return (sum(parts.values()) / reps / 1e3,
            {k: v / reps / 1e3 for k, v in parts.items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mlp_fused_ablate: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepflame_torch.ops import kernels as K

    print(cs.card_line())
    names = args.variants.split(",")
    t0 = time.perf_counter()
    libs = build(K, names)
    print(f"{len(libs)} variants built in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for wdt, B, tol in ((torch.float32, 1 << 14, 1e-5),
                        (torch.float64, 1 << 12, 1e-12)):
        x, Ws, bs = cs._mlp_operands(torch, g, wdt, B)
        Ws = K.mlp_pack(Ws)
        ref = K.mlp_fused_plain(x, Ws, bs)
        mode = "f32" if wdt == torch.float32 else "f64"
        cases.append((mode, B, tol, (x, Ws, bs), ref, cs.mlp_bound(mode, B)[2]))
    for rnd, order in enumerate((names, names[::-1])):
        for mode, B, _, ops, _, b_ms in cases:
            ms = cs.device_ms(torch, K.mlp_fused_plain, [ops], reps=5)
            print(json.dumps(dict(variant="plain", mode=mode, B=B, round=rnd,
                                  ms=ms, bound_share=b_ms / ms)))
        for name in order:
            # the wrapper takes the variant's library from here on
            K._libs["mlp_fused"] = ctypes.CDLL(libs[name])
            for mode, B, tol, ops, ref, b_ms in cases:
                _, rel = cs.max_rel_err(torch, K.mlp_fused(*ops), ref)
                if rel > tol:
                    raise RuntimeError(f"{name} {mode}: {rel:.3e} of the "
                                       f"largest |out|, over {tol:g}")
                ms, parts = by_kernel(torch, K.mlp_fused, ops, args.reps)
                print(json.dumps(dict(
                    variant=name, defines=VARIANTS[name], mode=mode, B=B,
                    round=rnd, ms=ms, bound_share=b_ms / ms, by_layer_ms=parts,
                    rel_err=rel)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
