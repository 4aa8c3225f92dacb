"""Variants of the Helmholtz kernel against each other, built from -D defines
that deepflame_torch/csrc/helmholtz7.cu reads.

    python3 tools/helmholtz7_ablate.py [--variants NAME,...] [--reps N]
                                       [--parent SOURCE]

From the root of the repository, on a machine with one CUDA card and nvcc.
Each variant is one nvcc build of the source as it is, with its defines,
into build/ablate/ (all builds started together; ptxas's registers and
spills printed for each). With --parent, SOURCE (an earlier helmholtz7.cu
that has only the padded entry points) is built beside them as the variant
"parent". The port's wrappers (deepflame_torch.ops.kernels.helmholtz7_apply
and helmholtz7_apply_bc) then run on each variant's library in turn at
chip_smoke.py's shapes, float32: the BC form at 96^3 (cyclic), on every
level of the structured jet's multigrid hierarchy from 128 x 64 x 64 (its
pressure BCs), at the FGM jet's 1024 x 512 x 1 (empty z) and the chamber's
41 x 100 x 41 (walls), and at 96^3 in float64; the padded form at 96^3, on
every level of that hierarchy, at 1024 x 512 x 1 and 41 x 100 x 41. Operands as chip_smoke.py
draws them, four sets in turn (more than the L2 cache at the large
shapes). For each variant, form and shape it checks the result against the
plain version (f32 1e-5, f64 1e-13 of the largest |out|) and prints one
JSON line: device ms per call from torch.profiler over `reps` calls, the
bound (chip_smoke.py's formulas) and the share of it reached. The variants
run in the order given and then once more in reverse, so that a drift of
the card's clocks shows as a difference between the two passes. A variant
that disagrees is reported and the run goes on; the exit code is then 1.
It never imports JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# name: defines (the source's defaults are the first variant)
VARIANTS = {
    "default": [],
    # threads a block along the plane
    "threads-128": ["-DHH_THREADS=128"],
    "threads-512": ["-DHH_THREADS=512"],
    # blocks a launch aims at, so the chunk of planes a block marches over
    "target-264": ["-DHH_TARGET_BLOCKS=264"],
    "target-1056": ["-DHH_TARGET_BLOCKS=1056"],
    "target-2112": ["-DHH_TARGET_BLOCKS=2112"],
    # as many threads as the defaults in blocks of 128
    "threads-128-target-1056": ["-DHH_THREADS=128",
                                "-DHH_TARGET_BLOCKS=1056"],
    # a fixed chunk: 1 is one cell a thread, no march
    "chunk-1": ["-DHH_CHUNK=1"],
    "chunk-16": ["-DHH_CHUNK=16"],
}


def build(K, names, parent: str | None) -> dict:
    """One nvcc per variant, all started together; the library paths."""
    out_dir = os.path.join(HERE, "build", "ablate")
    os.makedirs(out_dir, exist_ok=True)
    src = str(K.CSRC / "helmholtz7.cu")
    jobs = {}
    for name in names + (["parent"] if parent else []):
        so = os.path.join(out_dir, f"libhelmholtz7-{name}.so")
        cmd = ([K.find_nvcc(), *K.NVCC_FLAGS, "-o", so, parent]
               if name == "parent" else
               [K.find_nvcc(), *K.NVCC_FLAGS, *VARIANTS[name], "-o", so, src])
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        report = {fn: dict(registers=regs, stack=stack, spill_stores=st,
                           spill_loads=ld)
                  for fn, regs, stack, st, ld in K.ptxas_report(log)}
        print(json.dumps(dict(variant=name, defines=VARIANTS.get(name, []),
                              ptxas=report)))
        libs[name] = so
    return libs


def staggered(torch, operands):
    """The operand set (x, gamma, diag, spacing, rule) with x, the faces and
    diag copied into views that start 100,064 x (k + 1) values (128-byte
    aligned) into a
    buffer of their own (k the operand's index): their starts no longer lie
    at one offset from 2 MB-aligned allocations."""
    x, gam, d, sp, rule = operands

    def moved(t, k):
        off = 100_064 * (k + 1)
        buf = torch.empty(off + t.numel(), dtype=t.dtype, device=t.device)
        v = buf[off:].view(t.shape)
        v.copy_(t)
        return v
    return (moved(x, 0), tuple(moved(t, k + 1) for k, t in enumerate(gam)),
            moved(d, 4), sp, rule)


def cases(torch, cs, K, g, probe: bool = False) -> list:
    """(form, label, operand sets, bound ms, tolerance) at the smoke's
    shapes; with `probe` the 96^3 and FGM BC-form cases also with their
    operands staggered in memory."""
    from deepflame_torch.mesh import (StructuredMesh, cyclic, empty,
                                      fixed_value, zero_gradient)
    from deepflame_torch.ops.multigrid import mg_levels

    zg = zero_gradient()
    jet = ((zg, fixed_value(101325.0)), (zg, zg), (zg, zg))
    cyc = ((cyclic(), cyclic()),) * 3
    fgm = ((zg, fixed_value(101325.0)), (zg, zg), (empty(), empty()))
    n, nj = cs.N_MAIN, cs.N_JET
    h = 2.0 * math.pi * 1e-3 / n
    h_fgm = cs.FGM_LX / cs.FGM_NX
    chamber = (cs.AACHEN_NXZ, cs.AACHEN_NY, cs.AACHEN_NXZ)
    h_chamber = (0.02 / cs.AACHEN_NXZ, 0.1 / cs.AACHEN_NY,
                 0.02 / cs.AACHEN_NXZ)
    jet_mesh = StructuredMesh.box([0.06, 0.03, 0.03], [2 * nj, nj, nj],
                                  device="cuda")
    bc = [("TGV 96^3 cyclic", (n, n, n), (h, h, h), cyc, torch.float32)]
    levels = [m for m, *_ in mg_levels(
        jet_mesh, torch.ones(jet_mesh.shape, device="cuda"),
        tuple(torch.ones(s, device="cuda") for s in (
            (2 * nj + 1, nj, nj), (2 * nj, nj + 1, nj),
            (2 * nj, nj, nj + 1))))]
    for lvl, m in enumerate(levels):
        bc.append((f"jet level {lvl}", m.shape, m.spacing, jet,
                   torch.float32))
    bc += [("FGM 1024 x 512 x 1", (cs.FGM_NX, cs.FGM_NY, 1),
            (h_fgm,) * 3, fgm, torch.float32),
           ("chamber walls", chamber, h_chamber, ((zg, zg),) * 3,
            torch.float32),
           ("TGV 96^3 cyclic f64", (n, n, n), (h, h, h), cyc,
            torch.float64)]
    out = []
    for label, shape, spacing, bcs, dt in bc:
        sets = cs._helmholtz_bc_sets(torch, g, shape, spacing, bcs, dt)
        bound = cs.helmholtz_bc_bound(shape, sets[0][0].element_size())[0]
        out.append(("bc", label, sets, bound,
                    1e-5 if dt == torch.float32 else 1e-13))
        if probe and label.startswith(("TGV 96^3 cyclic", "FGM")):
            out.append(("bc", label + ", staggered",
                        [staggered(torch, s) for s in sets], bound,
                        1e-5 if dt == torch.float32 else 1e-13))
    for label, shape, spacing in (
            ("TGV 96^3", (n, n, n), (h, h, h)),
            *((f"jet level {lvl}", m.shape, m.spacing)
              for lvl, m in enumerate(levels)),
            ("FGM 1024 x 512 x 1", (cs.FGM_NX, cs.FGM_NY, 1), (h_fgm,) * 3),
            ("chamber", chamber, h_chamber)):
        out.append(("padded", label,
                    cs._helmholtz_sets(torch, g, shape, spacing),
                    cs.helmholtz_padded_bound(shape)[0], 1e-5))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--probe", action="store_true",
                    help="also the 96^3 and FGM BC-form cases with the "
                         "operands staggered in memory")
    ap.add_argument("--parent", metavar="SOURCE",
                    help="an earlier helmholtz7.cu to time beside them "
                         "(padded form only)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("helmholtz7_ablate: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepflame_torch.ops import kernels as K

    print(cs.card_line())
    names = args.variants.split(",")
    t0 = time.perf_counter()
    libs = build(K, names, args.parent)
    print(f"{len(libs)} variants built in {time.perf_counter() - t0:.1f} s")
    K._libs["helmholtz7_apply"] = ctypes.CDLL(libs[names[0]])
    print(json.dumps(dict(empty_launch_ms=cs.empty_launch_ms(torch, K))))
    g = torch.Generator(device="cuda").manual_seed(0)
    todo = cases(torch, cs, K, g, args.probe)
    fns = {"bc": (K.helmholtz7_apply_bc, K.helmholtz_apply_bc_plain),
           "padded": (K.helmholtz7_apply, K.helmholtz_apply_plain)}
    for form, label, sets, bound, _ in todo:
        print(json.dumps(dict(variant="plain", form=form, case=label,
                              ms=cs.device_ms(torch, fns[form][1], sets,
                                              reps=5), bound_ms=bound)))
    order = names + (["parent"] if args.parent else [])
    failed = 0
    for rnd, names_in_turn in enumerate((order, order[::-1])):
        for name in names_in_turn:
            # the wrappers take the variant's library from here on
            K._libs["helmholtz7_apply"] = ctypes.CDLL(libs[name])
            for form, label, sets, bound, tol in todo:
                if name == "parent" and form == "bc":
                    continue
                kernel_fn, plain_fn = fns[form]
                _, rel = cs.max_rel_err(torch, kernel_fn(*sets[0]),
                                        plain_fn(*sets[0]))
                if not rel <= tol:
                    failed += 1
                    print(f"FAILED {name} {form} {label}: {rel:.3e} of the "
                          f"largest |out|, over {tol:g}")
                try:
                    ms = cs.device_ms(torch, kernel_fn, sets, reps=args.reps,
                                      kernel="helmholtz7_kernel", attempts=6)
                except RuntimeError as e:   # the profiler lost records
                    print(e)
                    ms = None
                print(json.dumps(dict(
                    variant=name, form=form, case=label, round=rnd, ms=ms,
                    bound_ms=bound, share=bound / ms if ms else None,
                    rel_err=rel)))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
