"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile FILE] [--phases LIST]

From the root of the repository, on a machine with one CUDA card and the CUDA
toolkit (nvcc). In order:

1. prints the card (name and power limit as nvidia-smi gives them), the
   torch and CUDA versions and whether nvcc and triton are present; builds
   the port's CUDA kernels from deepflame_torch/csrc and prints the build time;
2. holds each kernel against its plain PyTorch version on the card at the
   shapes of the main paths, and takes the device time of the kernel, the
   plain version and (where one PyTorch call computes the same function) the
   library call from torch.profiler, and the kernel wrapper's wall time per
   call with CUDA events; the fused MLP in bf16 (96^3 lanes), f32 (2^14 and
   96^3) and f64 (2^12), with its launches per call and scratch; the
   Gauss-Jordan inverse at n = 10 and 2^17 lanes in both types, at the lane
   counts the chemistry launches it with, and at n = 54 (gri30's size) in
   both types, beside the device time of an empty kernel's launch; the
   stencil at the structured jet's (9, 128, 64, 64) and the aachenBomb's
   (1, 3 and 9 lanes of 41 x 100 x 41) and the plan jet's lattice pressure
   (1, 128, 64, 64) with the boundary coefficients zeroed; the Helmholtz
   operator in its BC form (ghosts computed in the kernel from a ghost
   rule) at 96^3 (cyclic), on every level of the structured jet's
   multigrid hierarchy with its pressure BCs, on the FGM jet's 1024 x 512 x
   1 and the chamber's 41 x 100 x 41, and at 96^3 in float64, and in its
   padded form at 96^3, on the jet's levels, the FGM jet's and the
   chamber's meshes; the jet's pressure matvec as the solver calls it,
   pad_field and the padded form against the BC form in turns (old, new,
   new, old: device ms and device operations per matvec, wall ms per
   call); and the ELL SpMV on the blockMesh jet's and the blockMesh
   chamber's connectivity;
3. checks whole steps on the card against the port's plain CPU path (the
   path the CPU tests hold against the JAX package) on small float64 cases:
   the stiff-chemistry case, the DNN-chemistry case, the face-list jet, the
   structured jet with Jacobi and with multigrid pressure preconditioning,
   and the stiff case with the dynamic Smagorinsky model; and a
   constant-volume 0D ignition;
4. drives the four main paths in float32 on the 9-species test mechanism,
   one warm-up step and then one timed step each, with the launch counts set
   to 0 just before the timed steps and read just after:
   - the stiff path at 96^3, the 3D reacting LES Taylor-Green step
     (deepflame_torch.cases.reacting_tgv_3d_les); the stencil, Helmholtz
     and Gauss-Jordan kernels must launch;
   - the DNN path at 96^3, the same step with DF-ODENet chemistry in bf16
     (deepflame_torch.cases.reacting_tgv_3d_les_dnn); the stencil and
     Helmholtz kernels must launch, and the fused MLP once per step;
   - the face-list path, the 3D LES jet flame on a 128 x 64 x 64 blockMesh
     mesh (deepflame_torch.cases.jet_flame_3d_les_fl, dt 5e-7 s); the ELL
     SpMV and Gauss-Jordan
     kernels must launch;
   - the structured jet, the same case on the 128 x 64 x 64 box
     (deepflame_torch.cases.jet_flame_3d_les, bench.py's jet line; one
     FieldBCs per species); the stencil, Helmholtz and Gauss-Jordan kernels
     must launch. Then one more step of its state with Jacobi and with
     multigrid pressure preconditioning, whose smoother must run the
     Helmholtz kernel on every level, and the two jets' ms/step side by
     side;
5. runs the DNN case through the case runtime at 32^3 (a CaseConfig, the
   solver factory with an npz checkpoint of seeded weights, run_case with
   splittingStrategy, one checkpoint, then a restart from it);
6. tci (in a whole run its workers start beside item 3's and it is
   checked before item 4 is timed): the structured jet at n = 8 (16 x 8 x
   8) in float64 with PaSR
   dynamicScale and with EDC v2005, 2 steps through run_case with the
   jet's function objects (cases.jet_function_objects) on the card and on
   the CPU path: fields and the transported Z, Zvar and Chi within 1e-8
   (U 1e-6), the written files' probe and line cells, histogram counts and
   separable min/max locations equal, their values within 1e-10 of each
   column's largest (1e-8 for columns computed from the velocity);
7. sjet-pasr: the structured jet at 128 x 64 x 64 in float32 with the
   factory's PaSR dynamicScale through run_case, 1 warm-up and 1 timed
   steps with the function objects writing every step (launch counts set
   to 0 just before the timed steps, read just after; the stencil,
   Helmholtz and Gauss-Jordan kernels must launch; every file written,
   finite, one row or snapshot a write, line coordinates the cell centres,
   T in [200, 3500] K); the Gauss-Jordan trips run against those the
   drains needed; a step with PaSR's correct() timed in it; the function
   objects' wall and device ms and bytes to the host per write;
8. sjet-edc: one step of that jet with EDC v2005, its trips counted, the
   three kernels launching;
9. light checks, card against CPU: the Peng-Robinson tables at 10 MPa on
   the 96^3 TGV fields (float64), set_r_delta_t on the PaSR jet's state,
   an OpenFOAM field file of the n = 8 jet's T read back onto the card;
10. hs, the density-based solver: gates first, card against the CPU path
   in float64 (both sides, and cj_speed, in worker processes side by side,
   all done before anything is timed; in a whole run beside the gates of
   items 11 and 12, in one window of 8 workers): the
   2D H2-air detonation at 64 x 8 (igniters over the lower half), 2 steps,
   fields within 1e-8; the Sod tube (tests/data/air.yaml, 400 cells) once
   per flux scheme and once with WENO5, fields within 1e-8 and the plateau
   within 3 % of the exact p* and u*. Then the reference's 2000 x 100
   channel (deepflame_torch.cases.detonation_2d_h2) in float32, its
   solver from runtime.factory.build_high_speed_solver with a CaseConfig,
   1 warm-up and 1 timed step through run_case (launch counts set to 0
   just before, read just after; gj_inverse must launch); the chemistry
   split's share of one more step; one split with every cell active (a
   labelled measurement, not the path); cj_speed on the test mechanism
   (three points, the test's options);
11. amr, adaptive mesh refinement on the density-based solver. Gates first,
   card against the CPU path in float64, in worker processes side by side,
   every conserved field of coarse and fine within 1e-8 of its largest
   value and the patch offsets equal after every step: FrontPatchAMR2D on
   the 64 x 8 channel (2 row patches, pc 16, ratio 2, igniters over the
   lower half, 2 steps; fine cells must burn) and on tests/test_patch_amr.py's
   curved front in air (3 rows, 10 steps; the rows must move, by different
   amounts), MovingPatchAMR with reflux and NestedPatchAMR (2 levels,
   criteria, reflux) on the 1D tube at 100 cells (the example's spacing and
   4 mm driver, so 0.67 m; 2 steps).
   Then the reference's 2000 x 100
   channel with front-shaped row patches (deepflame_torch.cases.
   detonation_2d_h2_amr: 5 patches of 96 x 26 fine cells, ratio 4) in
   float32, 1 warm-up and 1 timed coarse step (launch counts set to 0 just
   before, read just after; gj_inverse must launch in the coarse drain and
   in the fine one, one drain a substep for every row): ms per coarse step,
   the example's cell-updates per coarse step, launches and lanes of each
   drain, the row offsets, the fine substeps' share of one more step, peak
   memory, one step of the uniform channel beside it and, labelled, one step
   of the uniform x-refined 8000 x 100 channel at dt / 4; the 1D tube
   at 300 cells with 2 nested levels, criteria and reflux
   (cases.detonation_1d_amr), 1 warm-up and 1 timed step (gj_inverse must
   launch); and gj_inverse against its plain version and the library at
   the smallest and the largest fine drain of the timed steps (rows that
   join the kernels line's gj_inverse path shapes);
12. fgm, the flareFGM solver on data/flare_CH4_drm19_SandiaD_4D.tbl: the
   Sandia D jet at 96 x 48 in float64, 2 steps, card against CPU with the
   table and with a seeded DeepFGM (fields 1e-8, velocity and fluxes
   1e-6); the native and the Python parser's seconds on the nc41 table;
   the jet at 1024 x 512 in float32, 1 warm-up and 2 timed steps (the
   stencil and Helmholtz kernels must launch), the table lookups' share of
   one more step;
13. spray and mist, the spray solvers. Gates first, card against the CPU
   path in float64, in worker processes side by side (in a whole run item
   17's gates and shock runs beside them): the aachenBomb
   chamber at 11 x 20 x 11, 2 steps, the CPU replaying the card's draws
   (deepflame_torch.lagrangian.cloud.draw), gas fields and parcel
   position, velocity, diameter and temperature within 1e-8; the RAS
   channel of tests/test_wall_functions.py with KOmegaSST and wall
   functions, 2 steps, 1e-8; the water-mist tube at 64 cells with 400
   parcels, 2 steps, 1e-8. Then the reference's threeD_aachenBomb at 41 x
   100 x 41 in float32 (deepflame_torch.cases.aachen_bomb_3d: kEpsilon,
   Laminar chemistry, water into the test mechanism's air), 2 warm-up and
   2 timed steps (the stencil and Helmholtz kernels must launch), the
   cloud's, the RAS model's and the chemistry's shares of one more step,
   one evolve with all 32,768 slots active and one chemistry solve with
   every cell in the drain's bins (labelled measurements), the kernels at
   the chamber's shapes; and oneD_detH2WaterMist at 700 cells with 80,000
   parcels x 275 in float32 (deepflame_torch.cases.
   watermist_detonation_1d, the mist released in the first step), 1
   warm-up and 2 timed steps (gj_inverse must launch), the cloud's and the
   chemistry split's shares of one more step, gj_inverse at the split's
   lanes;
14. the face-list backend's paths, each with float64 gates first (in
   worker processes, 2 steps; in a whole run those of fljet, hsfl and
   fgmfl in one window of 8 workers) and then 1 warm-up and 1 (fljet) or 2
   timed steps in
   float32 with the launch counts set to 0
   just before and read just after:
   - fljet: the structured jet on shift-plan meshes
     (deepflame_torch.cases.jet_flame_3d_les_plan) at 128 x 64 x 64;
     gates at 16 x 8 x 8: card against CPU, plan against no plan, and its
     deviation from the structured jet equal on the card and the CPU;
     stencil7_apply and gj_inverse must launch, ell_matvec must not; then
     the AMG setup and one step with AMG beside one with Jacobi;
   - hsfl: the detonation channel on plan meshes at 2000 x 100
     (cases.detonation_2d_h2_fl); gates at 64 x 8: card against CPU
     (1e-8) and against the structured step (5e-3); gj_inverse must launch;
   - fgmfl: the Sandia D jet on plan meshes at 1024 x 512 with RNG
     k-epsilon and a DeepFGM distilled on the card by train_deep_fgm
     (cases.sandia_d_fgm_2d_fl); gates at 96 x 48: card against CPU with
     and without RAS and against the structured FGM step; stencil7_apply
     must launch;
   - sprayfl: the aachenBomb chamber as a blockMesh hex block at 41 x 100 x
     41 (cases.aachen_bomb_3d_fl: kEpsilon with wall functions, the cloud
     on an overlay grid); gate at 11 x 20 x 11, the CPU replaying the
     card's draws; ell_matvec must launch, gj_inverse must not;
15. dist, the distributed paths (deepflame_torch.parallel) on 4 ranks that
   share the card over gloo (spawned processes, a file store, halo planes
   staged through the host; the ranks joined with a deadline and killed
   on expiry). Float64 gates first, each over 2 steps
   against the port's single-device CPU step (in worker processes side by
   side), every field within 1e-8 of its largest value (the jets' velocity
   and fluxes 1e-6), the diagnostics bit-equal on every rank and each
   solve's iteration counts equal on every rank and within 1 of the
   single-device step's: the stiff TGV at n = 8 split (2, 1, 1) and (2, 2,
   1), the structured jet at 16 x 8 x 8 split (2, 1, 1) (beside the first,
   on the other two ranks), the blockMesh jet at n = 8 on 4 ranks; each
   also against the single-device step on the card, every field within
   1e-9 (what the decomposition alone changes), and the single-device
   card step against the CPU's printed beside; and
   solve_chemistry(cross_shard=True) of 4,096 cells on the 4 ranks against
   the global solve. Then, in float32: the 96^3 stiff TGV over (4, 1, 1)
   ranks (DistributedLowMach), 1 warm-up and 1 timed step and one more with
   dlb_cross_shard, helmholtz7_apply and gj_inverse launching on every rank;
   the 128 x 64 x 64 blockMesh jet on 4 ranks in (1, 2, 2) blocks
   (DistributedLowMachFL, block_order), 1 warm-up and 1 timed step,
   ell_matvec and gj_inverse launching on every rank. Per path: ms per step
   (rank 0's wall time, closed by synchronize and a barrier),
   cell-updates/s, launches, halo exchanges and all_reduces per step with
   their bytes, peak memory per rank. Then each kernel against its plain
   version at the shapes these paths launched it with (_dist_kernel_rows),
   rows of the kernels line;
16. dnnloop, DF-ODENet training and the closed-loop DNN flame
   (deepflame_torch.chemistry.dnn_train, cases.dnn_closed_loop_flame).
   Float64 gates first, card against the CPU path, each side in a worker
   process, all side by side: the data set of 256 states and 3 Adam steps
   at hidden widths (32, 16, 8) (arrays within 1e-10, weights within
   1e-9), the anchored flame and both models of the closed loop at 64
   cells, 2 steps (every field within 1e-8, iterations equal), each flame
   from the same burnt composition (a 4-read ignition on the CPU); the
   2,048-state float32 data set is built on the card beside them
   (gj_inverse must launch). Then, in float32 at the DNN TGV's widths
   ([11, 1600, 800, 400, 1] x 8): 2 epochs of Adam at batch 512 (no kernel
   may launch: training runs the plain MLP), ms per step and samples/s;
   the npz checkpoint written, read back and served in the reference's
   Tu500K-Phi1 flame at 512 cells, 2 timed Laminar steps and 1 warm-up
   and 10 timed DNN steps (launch counts set to 0 just before, read just
   after; the stencil and Helmholtz kernels must launch in both,
   gj_inverse in the Laminar steps, mlp_fused once a DNN step), fields
   finite with T > 0, closed_loop_compare's numbers after 2 steps of each
   (printed, not gated); then mlp_fused f32 at B = 512 and 1,024, the
   stencil at (1, 3 and 9 lanes of) 512 x 1 x 1 with open boundaries, the
   Helmholtz BC form with the flame's pressure BCs and gj_inverse at the
   data set's and the flame's drain lanes (in a fresh worker), each
   against its plain version;
17. examples, the examples' own families (deepflame_torch.cases.flame_1d,
   reacting_tgv_2d, jet_flame_2d, detonation_1d, shock_watermist_1d,
   droplet_relaxation; examples/flame_1d.py, reacting_tgv_2d.py,
   jet_flame_2d.py, detonation_1d.py, shock_watermist_1d.py,
   single_droplet_motion.py). Float64 gates first, card against the CPU
   path, each side in a worker, all side by side, 2 steps: the free flame
   at 32 cells, the TGV at 8 x 8, the jet at cells = 6 with EDC, the
   detonation at 40 cells over 0.2 m, the shock at 24 cells dry and with
   the fog (every field and parcel array within 1e-8 of its largest value,
   Krylov iterations and chemistry lanes equal), and 10 steps of each
   droplet run; beside them, in two more workers, the shock's own run on
   the card, float32 at 240 cells to 2 ms, dry and through the fog: the
   dry speed over x in (0.1, 1.0) m within 3 % of the Rankine-Hugoniot 417
   m/s; the fog's printed beside it (the example expects it slower: see
   ROADMAP section C on the vapour's energy). Then at each example's mesh
   and options (the
   launch counts set to 0 just before the timed steps, read just after):
   the flame at 256 cells, 1 warm-up and 1 timed step in float32 and in
   float64 (the example's default: in float32 no stiff lane reaches the
   implicit tier), the front and T_max printed; the TGV at 64 x 64 in
   float32, 1 warm-up and 2 steps through run_case with its function
   objects writing every step (one row and one line a write, finite, the
   line at the cell centres); the jet at 96 x 24 with EDC in float64, 1 +
   1 steps; the stencil, Helmholtz and Gauss-Jordan kernels must launch on
   these three; the detonation at 625 cells in float32,
   gj_inverse must launch (1 + 1 steps), the front and p_max printed; the
   shock dry and
   with the fog, float32, 1 + 2 steps each, and the droplet's three runs
   whole in float64 (within 2 % of the reference integration), no kernel
   may launch on these; then the stencil and the Helmholtz BC form at the
   three low-Mach meshes with their BCs, and gj_inverse at the smallest
   and the largest drain of each type's timed steps, in a fresh worker,
   each against its plain version;
18. prints its total seconds, the card line, one JSON line of kernel
   figures, then, as the last line, {"ok": true, "device": {...}}.

Any failure raises, so the exit code is not 0 and no result line is printed.
With no CUDA device it exits with code 2 before doing anything. It never
imports JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MECH = os.path.join(HERE, "tests", "data", "h2_air_9sp.json")
PALLAS = "deepflame_tpu/ops/pallas_kernels.py"
N_MAIN, STEPS = 96, 1          # main paths: cells per side, timed steps
N_RUNTIME = 32                 # runtime phase: cells per side
DT = 2.5e-7                    # step of the TGV cases [s]
N_JET, JET_DT = 64, 5e-7       # face-list jet: (2n, n, n) cells; its step [s]
# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12        # float32 outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12    # bf16 on the tensor cores, dense
FP64_TC_FLOP_PER_S = 67e12     # float64 on the tensor cores
FP64_FLOP_PER_S = 34e12        # float64 outside the tensor cores
# mlp_fused at the DNN path's DF-ODENet: widths F -> H1 -> H2 -> H3 -> 1
MLP_S, MLP_WIDTHS = 8, (11, 1600, 800, 400, 1)
# per mode: (bytes of a weight, bytes of x, biases and out, peak FLOP/s)
MLP_MODES = {"bf16": (2, 4, BF16_TC_FLOP_PER_S), "f32": (4, 4, FP32_FLOP_PER_S),
             "f64": (8, 8, FP64_TC_FLOP_PER_S)}


def bound_ms(n_bytes: float, n_flops: float,
             flop_rate: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """Least time for the work: bytes over memory rate vs operations over
    the peak rate of their type (default float32 outside the tensor cores),
    whichever is larger."""
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, n_flops / flop_rate
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def device_ms(torch, fn, arg_sets, reps: int = 20, warm: int = 3,
              kernel: str | None = None, attempts: int = 5,
              ops_per_call: int | None = None) -> float:
    """Device time per call of fn(*args) (see device_profile)."""
    return device_profile(torch, fn, arg_sets, reps, warm, kernel, attempts,
                          ops_per_call)[0]


def device_profile(torch, fn, arg_sets, reps: int = 20, warm: int = 3,
                   kernel: str | None = None, attempts: int = 5,
                   ops_per_call: int | None = None) -> tuple[float, int]:
    """(device ms per call, device operations recorded in the window) of
    fn(*args). The time is the summed durations of the device
    operations that `reps` calls launch, as torch.profiler records them
    (host dispatch and the gaps between operations are not counted). The
    calls cycle through arg_sets, more than the 50 MB L2 cache together, so
    each call reads cold inputs. With `kernel` given, every device operation
    recorded must be that kernel, and the time is the mean over the launches
    recorded (the profiler has been seen to drop one record of twenty long
    launches). With `ops_per_call` given as well, the check is strict: the
    window must hold exactly reps x ops_per_call device operations, all
    named `kernel`, and the time is their sum over `reps`. With no `kernel`
    the window must hold a whole multiple of `reps` operations. A profiled
    window that records no device operation, or the wrong count, is
    profiled again, up to `attempts` windows in all: the profiler has been
    seen to return a window with no device record. Each window opens and closes with
    a marker kernel (torch.cuda._sleep's spin_kernel) that is neither timed
    nor counted: the profiler has been seen to lose one record at an edge
    of a window in every attempt (79 of 80 records)."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(warm):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for i in range(reps):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "spin_kernel" not in e.name]
        named = (len(dev) if kernel is None
                 else sum(kernel in e.name for e in dev))
        if ops_per_call is None:
            # without a kernel name, each call's operations must all be
            # there: a whole multiple of reps
            ok = bool(dev) and (
                len(dev) % reps == 0 if kernel is None
                else named == len(dev) and reps - 1 <= named <= reps)
        else:
            ok = named == len(dev) == reps * ops_per_call
        if ok:
            break
        names = collections.Counter(e.name for e in dev)
        print(f"profiled window {attempt + 1} of {attempts}: {len(dev)} "
              f"device operations ({named} named {kernel}) for {reps} calls; "
              f"by name " + json.dumps(names.most_common()))
    check(dev, "the profiler recorded no device operation")
    check(ok, f"{kernel}: {named} of {len(dev)} device operations for {reps} "
              f"calls")
    return sum(e.time_range.elapsed_us() for e in dev) / (
        named if kernel is not None and ops_per_call is None else reps
    ) / 1e3, len(dev)


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
            library_fn=None, library_sets=None, reps: int = 20,
            ops_per_call: int | None = None, warm: int = 3) -> dict:
    """Device ms of the kernel, its plain version and the library call (and
    the device operations per library call that its profiled window
    recorded), and the kernel wrapper's wall ms per call, each after `warm`
    calls. With
    `ops_per_call` (see device_profile) also the device operations per call
    that the kernel's profiled window recorded, as
    `cuda_launches_per_call`."""
    ms, records = device_profile(torch, kernel_fn, sets, reps=reps, warm=warm,
                                 kernel=kernel, ops_per_call=ops_per_call)
    out = dict(
        ms=ms, call_ms=call_ms(torch, kernel_fn, sets, reps=reps, warm=warm),
        plain_ms=device_ms(torch, plain_fn, sets, reps=plain_reps, warm=warm),
        library_ms=None)
    if library_fn is not None:
        lib_reps = 20
        out["library_ms"], lib_records = device_profile(
            torch, library_fn, library_sets, reps=lib_reps)
        out["library_ops_per_call"] = lib_records / lib_reps
    if ops_per_call is not None:
        out["cuda_launches_per_call"] = records / reps
    return out


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


def phase_kernels(torch, K, jet_conn, chamber_conn) -> dict:
    """Each kernel against its plain version at main-path shapes; jet_conn:
    the face-list jet's ELL connectivity (its solver's p_ell);
    chamber_conn: the face-list aachenBomb chamber's."""
    from deepflame_torch.mesh import cyclic

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}

    # --- stencil: the 9-species batch at 96^3 (periodic), at the structured
    # jet's 128 x 64 x 64 and at the FGM jet's 1024 x 512 x 1 (one scalar
    # and the three momentum components; boundary coefficients zeroed),
    # float32
    S, n = 9, 96
    out["stencil7_apply"] = _stencil_row(torch, K, g, (S, n, n, n), False)
    row = _stencil_row(torch, K, g, (S, 2 * N_JET, N_JET, N_JET), True)
    print("stencil7_apply at the structured jet's shape: " + json.dumps(row))
    out["stencil7_apply"]["sjet_shape"] = row
    out["stencil7_apply"]["fgm_shapes"] = []
    for lanes in (1, 3):
        row = _stencil_row(torch, K, g, (lanes, FGM_NX, FGM_NY, 1), True)
        print("stencil7_apply at the FGM jet's shape: " + json.dumps(row))
        out["stencil7_apply"]["fgm_shapes"].append(row)
    # the aachenBomb chamber: k or eps, momentum, the 9 species; walls
    out["stencil7_apply"]["spray_shapes"] = []
    for lanes in (1, 3, 9):
        row = _stencil_row(torch, K, g, (lanes, AACHEN_NXZ, AACHEN_NY,
                                         AACHEN_NXZ), True)
        print("stencil7_apply at the aachenBomb's shape: " + json.dumps(row))
        out["stencil7_apply"]["spray_shapes"].append(row)
    # the plan jet's lattice pressure CG: one lane of 128 x 64 x 64, closed
    # walls (the coefficients across a boundary zero); its V/V_mean row
    # scaling is 1 on the uniform box, so the coefficients are as drawn
    row = _stencil_row(torch, K, g, (1, 2 * N_JET, N_JET, N_JET), True)
    print("stencil7_apply at the plan jet's pressure shape: " + json.dumps(row))
    out["stencil7_apply"]["fljet_pressure_shape"] = row

    # --- Helmholtz: the pressure operator at 96^3, float32, main-path
    # spacing, in the BC form the main paths run (the TGV's cyclic axes)
    # and in the padded form; then the padded form on the structured jet's
    # 128 x 64 x 64 and each level of its multigrid hierarchy, the FGM
    # jet's 1024 x 512 x 1 and the chamber's 41 x 100 x 41; then the BC
    # form at those shapes with each case's pressure BCs, and at 96^3 in
    # float64; then the jet's pressure matvec as the solver calls it, old
    # against new
    h = 2.0 * math.pi * 1e-3 / n
    cyc = ((cyclic(), cyclic()),) * 3
    tgv_bc = _helmholtz_bc_row(torch, K, _helmholtz_bc_sets(
        torch, g, (n, n, n), (h, h, h), cyc), "TGV, cyclic")
    out["helmholtz7_apply"] = dict(tgv_bc)
    out["helmholtz7_apply"]["padded"] = _helmholtz_row(
        torch, K, _helmholtz_sets(torch, g, (n, n, n), (h, h, h)))
    out["helmholtz7_apply"]["sjet_levels"] = _helmholtz_levels(torch, K, g)
    h = FGM_LX / FGM_NX
    row = _helmholtz_row(torch, K, _helmholtz_sets(
        torch, g, (FGM_NX, FGM_NY, 1), (h, h, h)))
    print("helmholtz7_apply at the FGM jet's shape: " + json.dumps(row))
    out["helmholtz7_apply"]["fgm_shape"] = row
    row = _helmholtz_row(torch, K, _helmholtz_sets(
        torch, g, (AACHEN_NXZ, AACHEN_NY, AACHEN_NXZ),
        (0.02 / AACHEN_NXZ, 0.1 / AACHEN_NY, 0.02 / AACHEN_NXZ)))
    print("helmholtz7_apply at the aachenBomb's shape: " + json.dumps(row))
    out["helmholtz7_apply"]["spray_shape"] = row
    out["helmholtz7_apply"]["bc_rows"] = _helmholtz_bc_rows(torch, K, g,
                                                           tgv_bc)
    out["helmholtz7_apply"]["solver_matvec"] = _solver_matvec(torch, K, g)

    out["gj_inverse"] = _gj_figures(torch, K, g)
    out["mlp_fused"] = _mlp_figures(torch, K, g)
    out["ell_matvec"] = _ell_figures(torch, K, g, jet_conn)
    row = _ell_figures(torch, K, g, chamber_conn)
    print("ell_matvec at the face-list chamber's shape: " + json.dumps(row))
    out["ell_matvec"]["chamber_shape"] = row
    for name, f in out.items():
        print(f"{name}: kernel {f['ms']:.4f} ms on the device "
              f"({f['call_ms']:.4f} ms per wrapper call back to back), "
              f"plain {f['plain_ms']:.4f} ms, library {f['library_ms']} ms, "
              f"bound {f['bound_ms']:.4f} ms ({f['bound_by']})")
    return out


def _stencil_row(torch, K, g, shape, open_boundaries: bool) -> dict:
    """stencil7_apply against its plain version at `shape` (S, nx, ny, nz)
    in float32 on two seeded operand sets; with open_boundaries the
    coefficients that reach across a boundary (lo at the first cell, hi at
    the last, every axis) are zero, as FvMatrix.stencil() leaves them on a
    non-periodic mesh. Tolerance 1e-5 of the largest |out|."""
    dev = "cuda"
    sets = []
    for _ in range(2):
        x, D = (torch.randn(shape, generator=g, device=dev) for _ in range(2))
        lo, hi = (tuple(torch.randn(shape, generator=g, device=dev)
                        for _ in range(3)) for _ in range(2))
        if open_boundaries:
            for ax in range(3):
                n_ax = shape[ax + 1]
                lo[ax].narrow(ax + 1, 0, 1).zero_()
                hi[ax].narrow(ax + 1, n_ax - 1, 1).zero_()
        sets.append([x, D, lo, hi])
    err, rel = max_rel_err(torch, K.stencil7_apply(*sets[0]),
                           K.stencil_apply_plain(*sets[0]))
    print(f"stencil7_apply {shape} f32: max abs err {err:.3e}, "
          f"rel {rel:.3e} (tolerance 1e-5 of the largest |out|)")
    check(rel <= 1e-5, f"stencil7_apply {shape} disagrees with its plain "
                       "version")
    cells = math.prod(shape)
    b_ms, b_by = bound_ms(9 * 4 * cells, 13 * cells)
    return dict(
        route="cuda", source="deepflame_torch/csrc/stencil7.cu",
        replaces=f"{PALLAS}:378 (stencil_apply_tiled)", max_abs_err=err,
        **timings(torch, K.stencil7_apply, "stencil7_kernel",
                  K.stencil_apply_plain, sets, plain_reps=5),
        bound_ms=b_ms, bound_by=b_by, shape=list(shape), dtype="float32")


def _helmholtz_row(torch, K, sets) -> dict:
    """helmholtz7_apply against its plain version on `sets` of (x padded,
    gamma faces, diag, spacing), float32, tolerance 1e-5 of the largest
    |out|; bound: x padded, the three face arrays, diag and out once, 22
    operations a cell."""
    nx, ny, nz = sets[0][2].shape
    err, rel = max_rel_err(torch, K.helmholtz7_apply(*sets[0]),
                           K.helmholtz_apply_plain(*sets[0]))
    print(f"helmholtz7_apply {nx} x {ny} x {nz} f32: max abs err {err:.3e}, "
          f"rel {rel:.3e} (tolerance 1e-5 of the largest |out|)")
    check(rel <= 1e-5, f"helmholtz7_apply {nx}x{ny}x{nz} disagrees with its "
                       "plain version")
    b_ms, b_by = helmholtz_padded_bound((nx, ny, nz))
    return dict(
        route="cuda", source="deepflame_torch/csrc/helmholtz7.cu",
        replaces=f"{PALLAS}:438 (helmholtz_apply)",
        also_replaces=f"{PALLAS}:301 (helmholtz_apply_tiled)",
        form="padded", max_abs_err=err,
        **timings(torch, K.helmholtz7_apply, "helmholtz7_kernel",
                  K.helmholtz_apply_plain, sets),
        bound_ms=b_ms, bound_by=b_by, shape=[nx, ny, nz], dtype="float32")


def _helmholtz_bc_row(torch, K, sets, label: str) -> dict:
    """helmholtz7_apply_bc against its plain version on `sets` of (x, gamma
    faces, diag, spacing, ghost rule), f32 within 1e-5 and f64 within 1e-13
    of the largest |out|; bound: x, diag, out and the face arrays of the
    active axes once each, 1 + 7 operations a cell per active axis."""
    x = sets[0][0]
    shape = tuple(x.shape)
    tol = 1e-5 if x.dtype == torch.float32 else 1e-13
    err, rel = max_rel_err(torch, K.helmholtz7_apply_bc(*sets[0]),
                           K.helmholtz_apply_bc_plain(*sets[0]))
    dname = str(x.dtype).replace("torch.", "")
    print(f"helmholtz7_apply_bc {shape} {dname} ({label}): max abs err "
          f"{err:.3e}, rel {rel:.3e} (tolerance {tol:g} of the largest "
          f"|out|)")
    check(rel <= tol, f"helmholtz7_apply_bc {shape} {dname} ({label}) "
                      "disagrees with its plain version")
    b_ms, b_by = helmholtz_bc_bound(shape, x.element_size())
    return dict(
        route="cuda", source="deepflame_torch/csrc/helmholtz7.cu",
        replaces=f"{PALLAS}:438 (helmholtz_apply)",
        also_replaces=f"{PALLAS}:301 (helmholtz_apply_tiled)",
        form="bc", bcs=label, max_abs_err=err,
        **timings(torch, K.helmholtz7_apply_bc, "helmholtz7_kernel",
                  K.helmholtz_apply_bc_plain, sets),
        bound_ms=b_ms, bound_by=b_by, shape=list(shape), dtype=dname)


def helmholtz_padded_bound(shape) -> tuple[float, str]:
    """Bound of the padded form in float32: x padded, the three face
    arrays, diag and out once, 22 operations a cell."""
    nx, ny, nz = shape
    cells = nx * ny * nz
    n_bytes = 4 * ((nx + 2) * (ny + 2) * (nz + 2) + (nx + 1) * ny * nz
                   + nx * (ny + 1) * nz + nx * ny * (nz + 1) + 2 * cells)
    return bound_ms(n_bytes, 22 * cells)


def helmholtz_bc_bound(shape, itemsize: int) -> tuple[float, str]:
    """Bound of the BC form: x, diag and out, and the face arrays of the
    axes longer than one cell, once each; 1 + 7 operations a cell for each
    such axis."""
    cells = math.prod(shape)
    active = [ax for ax, n_ax in enumerate(shape) if n_ax > 1]
    faces = sum(cells // shape[ax] * (shape[ax] + 1) for ax in active)
    return bound_ms(itemsize * (3 * cells + faces),
                    (1 + 7 * len(active)) * cells,
                    FP32_FLOP_PER_S if itemsize == 4 else FP64_FLOP_PER_S)


def _helmholtz_bc_sets(torch, g, shape, spacing, bcs, dtype=None) -> list:
    """Four seeded operand sets of helmholtz7_apply_bc on a mesh of `shape`
    with the pressure BCs `bcs`: x N(0, 1), face coefficients in [1e-7,
    1.1e-6], diag in [1, 4], float32 unless `dtype`."""
    from deepflame_torch.mesh import StructuredMesh
    from deepflame_torch.ops.kernels import ghost_rule

    dtype = dtype or torch.float32
    rule = ghost_rule(bcs, StructuredMesh(*shape, *spacing,
                                          device=torch.device("cuda")))
    check(rule is not None, "a pressure BC without a scalar ghost factor")
    nx, ny, nz = shape
    r = lambda s: torch.rand(s, generator=g, device="cuda", dtype=dtype)
    sets = []
    for _ in range(4):
        x = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
        gam = tuple(r(s) * 1e-6 + 1e-7 for s in (
            (nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)))
        sets.append((x, gam, r(shape) * 3.0 + 1.0, spacing, rule))
    return sets


def _helmholtz_bc_rows(torch, K, g, tgv_row) -> list:
    """The BC form at the main paths' shapes, each row printed: the TGV's
    96^3 (cyclic; `tgv_row`, measured already), every level of the
    structured jet's multigrid hierarchy with the jet's pressure BCs (level
    0 is its 128 x 64 x 64 pressure), the FGM jet's 1024 x 512 x 1 (empty
    z), the chamber's 41 x 100 x 41 (walls), and 96^3 in float64."""
    from deepflame_torch.mesh import (StructuredMesh, cyclic, empty,
                                      fixed_value, zero_gradient)
    from deepflame_torch.ops.multigrid import mg_levels

    zg = zero_gradient()
    jet = ((zg, fixed_value(101325.0)), (zg, zg), (zg, zg))
    rows = [tgv_row]
    mesh = StructuredMesh.box([0.06, 0.03, 0.03],
                              [2 * N_JET, N_JET, N_JET], device="cuda")
    hier = []
    for x, gam, d, _, _ in _helmholtz_bc_sets(torch, g, mesh.shape,
                                              mesh.spacing, jet):
        hier.append(mg_levels(mesh, d, gam))
    for lvl in range(len(hier[0])):
        sets = []
        for levels in hier:
            m, gam, d, _ = levels[lvl]
            sets.append((torch.randn(m.shape, generator=g, device="cuda"),
                         gam, d, m.spacing, K.ghost_rule(jet, m)))
        row = _helmholtz_bc_row(torch, K, sets, f"jet bcs_p, multigrid "
                                                f"level {lvl}")
        row["level"] = lvl
        rows.append(row)
    h = FGM_LX / FGM_NX
    rows.append(_helmholtz_bc_row(torch, K, _helmholtz_bc_sets(
        torch, g, (FGM_NX, FGM_NY, 1), (h, h, h),
        ((zg, fixed_value(101325.0)), (zg, zg), (empty(), empty()))),
        "FGM jet bcs_p, empty z"))
    rows.append(_helmholtz_bc_row(torch, K, _helmholtz_bc_sets(
        torch, g, (AACHEN_NXZ, AACHEN_NY, AACHEN_NXZ),
        (0.02 / AACHEN_NXZ, 0.1 / AACHEN_NY, 0.02 / AACHEN_NXZ),
        ((zg, zg),) * 3), "aachenBomb walls"))
    h = 2.0 * math.pi * 1e-3 / N_MAIN
    rows.append(_helmholtz_bc_row(torch, K, _helmholtz_bc_sets(
        torch, g, (N_MAIN,) * 3, (h, h, h),
        ((cyclic(), cyclic()),) * 3, torch.float64), "TGV, cyclic"))
    for row in rows[1:]:
        print("helmholtz7_apply_bc: " + json.dumps(row))
    return rows


def _solver_matvec(torch, K, g) -> dict:
    """The structured jet's pressure matvec as the solver calls it, at 128 x
    64 x 64 with its pressure BCs, float32: the parent's (pad_field, then
    the padded form) against the BC form (ops.kernels.helmholtz_operator,
    as the solver calls it), on the same four operand sets, measured in
    turns old, new, new, old. Each turn: device ms per matvec
    (every device operation of the window summed, over the calls), device
    operations per matvec, and wall ms per call back to back. The BC form
    must be one device operation and agree with the old matvec."""
    from deepflame_torch.mesh import (StructuredMesh, fixed_value, pad_field,
                                      zero_gradient)

    zg = zero_gradient()
    bcs = ((zg, fixed_value(101325.0)), (zg, zg), (zg, zg))
    mesh = StructuredMesh.box([0.06, 0.03, 0.03],
                              [2 * N_JET, N_JET, N_JET], device="cuda")
    sets = [s[:3] for s in _helmholtz_bc_sets(torch, g, mesh.shape,
                                              mesh.spacing, bcs)]
    forms = {
        "old": lambda x, gam, d: K.helmholtz7_apply(
            pad_field(x, bcs, mesh, homogeneous=True), gam, d, mesh.spacing),
        "new": K.helmholtz_operator(bcs, mesh)}
    err, rel = max_rel_err(torch, forms["new"](*sets[0]),
                           forms["old"](*sets[0]))
    check(rel <= 1e-6, f"jet matvec: the BC form and pad_field + the padded "
                       f"form disagree ({rel:.3e})")
    reps, turns = 20, []
    for name in ("old", "new", "new", "old"):
        ms, ops = device_profile(torch, forms[name], sets, reps=reps)
        turns.append(dict(matvec=name, device_ms=ms, device_ops=ops / reps,
                          wall_ms=call_ms(torch, forms[name], sets,
                                          reps=reps)))
    rec = dict(shape=list(mesh.shape), bcs="jet bcs_p", dtype="float32",
               rel_err=rel, turns=turns)
    for name in ("old", "new"):
        mine = [t for t in turns if t["matvec"] == name]
        rec[name] = {k: sum(t[k] for t in mine) / len(mine)
                     for k in ("device_ms", "device_ops", "wall_ms")}
    print("solver_matvec: " + json.dumps(rec))
    check(all(t["device_ops"] == 1 for t in turns if t["matvec"] == "new"),
          "jet matvec: the BC form is not one device operation")
    return rec


def _helmholtz_sets(torch, g, shape, spacing) -> list:
    """Four seeded operand sets of helmholtz7_apply on a mesh of `shape`:
    x padded N(0, 1), face coefficients in [1e-7, 1.1e-6], diag in
    [1, 4], float32."""
    nx, ny, nz = shape
    sets = []
    for _ in range(4):
        xp = torch.randn((nx + 2, ny + 2, nz + 2), generator=g, device="cuda")
        gam = tuple(torch.rand(s, generator=g, device="cuda") * 1e-6 + 1e-7
                    for s in ((nx + 1, ny, nz), (nx, ny + 1, nz),
                              (nx, ny, nz + 1)))
        d = torch.rand(shape, generator=g, device="cuda") * 3.0 + 1.0
        sets.append((xp, gam, d, spacing))
    return sets


def _helmholtz_levels(torch, K, g) -> list:
    """helmholtz7_apply on the structured jet's mesh (128 x 64 x 64 over 60
    x 30 x 30 mm) and on every level of the multigrid hierarchy that
    ops.multigrid builds from it (the coarsened gamma and diag of four
    seeded fine operand sets), each row printed."""
    from deepflame_torch.mesh import StructuredMesh
    from deepflame_torch.ops.multigrid import mg_levels

    mesh = StructuredMesh.box([0.06, 0.03, 0.03],
                              [2 * N_JET, N_JET, N_JET], device="cuda")
    hier = []
    for _ in range(4):
        sh = mesh.shape
        gam = tuple(torch.rand(f, generator=g, device="cuda") * 1e-6 + 1e-7
                    for f in ((sh[0] + 1,) + sh[1:],
                              (sh[0], sh[1] + 1, sh[2]), sh[:2] + (sh[2] + 1,)))
        d = torch.rand(sh, generator=g, device="cuda") * 3.0 + 1.0
        hier.append(mg_levels(mesh, d, gam))
    rows = []
    for lvl in range(len(hier[0])):
        sets = []
        for levels in hier:
            m, gam, d, _ = levels[lvl]
            xp = torch.randn(tuple(n + 2 for n in m.shape), generator=g,
                             device="cuda")
            sets.append((xp, gam, d, m.spacing))
        row = _helmholtz_row(torch, K, sets)
        row["level"] = lvl
        print(f"helmholtz7_apply multigrid level {lvl}: " + json.dumps(row))
        rows.append(row)
    return rows


def empty_launch_ms(torch, K) -> float:
    """Device ms of one launch of an empty kernel (the Gauss-Jordan
    library's): the floor under any kernel's time, beside the bounds of
    small calls."""
    empty = K._function("gj_inverse", "empty")
    return device_ms(torch, lambda: empty(torch.cuda.current_stream()
                                          .cuda_stream), [()],
                     kernel="gj_empty_kernel")


def gj_operand(torch, g, n: int, L: int, dtype):
    """W = I + 0.1 sqrt(10 / n) N(0, 1), (n, n, L): condition number below
    ~5 at every n, like I - gamma dt J at the step sizes the controller
    accepts (the unpivoted elimination is meant for matrices near I)."""
    return (torch.eye(n, device="cuda", dtype=torch.float64)[:, :, None]
            + (0.1 * (10.0 / n) ** 0.5) * torch.randn(
                (n, n, L), generator=g, device="cuda",
                dtype=torch.float64)).to(dtype)


def gj_bound(n: int, L: int, dtype) -> tuple[float, str]:
    """bound_ms of one gj_inverse call: n^2 values read and written per
    lane; float32 also (2 n^3 + 3 n^2) operations per lane at the FP32
    peak; float64 is bounded by its bytes alone (no float64 peak used)."""
    size = dtype.itemsize
    flops = (2 * n ** 3 + 3 * n ** 2) * L if size == 4 else 0
    return bound_ms(2 * n * n * L * size, flops)


def _gj_row(torch, K, g, n: int, L: int, dtype) -> dict:
    """gj_inverse at (n, n, L) against its plain version (tolerance f32
    1e-4, f64 1e-10 of the largest entry) on six seeded input sets, timed
    beside the plain version and torch.linalg.inv on the same matrices
    lanes first; which kernel of the library ran ("reg" or "cols")."""
    sets = [(gj_operand(torch, g, n, L, dtype),) for _ in range(6)]
    err, rel = max_rel_err(torch, K.gj_inverse(*sets[0]),
                           K.gj_inverse_plain(*sets[0]))
    name = "f32" if dtype == torch.float32 else "f64"
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    check(rel <= tol, f"gj_inverse {name} n={n} L={L} disagrees with its "
                      f"plain version: {rel:.3e} of the largest entry")
    b_ms, b_by = gj_bound(n, L, dtype)
    return dict(
        route="cuda", source="deepflame_torch/csrc/gj_inverse.cu",
        replaces=f"{PALLAS}:189 (gj_inverse_lanes)", max_abs_err=err,
        rel_err=rel,
        kernel="reg" if n <= K.gj_limits(dtype)[0] else "cols",
        **timings(torch, K.gj_inverse, "gj_inverse_", K.gj_inverse_plain,
                  sets, plain_reps=5, library_fn=torch.linalg.inv,
                  library_sets=[(W.permute(2, 0, 1).contiguous(),)
                                for (W,) in sets]),
        bound_ms=b_ms, bound_by=b_by, shape=[n, n, L], dtype=name)


def _gj_figures(torch, K, g) -> dict:
    """gj_inverse: the launch floor (an empty kernel's device time), the
    library's limits, then rows of _gj_row: n = 10 (9 species + T) at 2^17
    lanes in float32 (the kernels line's entry) and float64 (its own
    line); float32 n = 10 at the lane counts the chemistry launches it
    with, a bin and the cold slab of the jet (4,096 and 32,768 lanes) and of
    the TGV (6,912 and 55,296), and the detonation's split: its igniters'
    hot cells (40 lanes, part of one block) and the whole 2000 x 100
    channel (200,000), one drain bin of the aachenBomb chamber
    (AACHEN_BIN_LANES) and the mist's split (MIST_SPLIT_LANES), as
    `path_shapes` (the amr phase adds the AMR channel's fine drains); n =
    54 (gri30's size) at 4,096 lanes in both types, as `n54`. At 2^17
    lanes the six input sets exceed the 50 MB L2 cache together, so each
    call reads cold inputs; at the path shapes they lie in it together, as
    the integrator's freshly made matrices would."""
    floor = empty_launch_ms(torch, K)
    print(f"empty kernel launch: {floor:.5f} ms of device time (the floor "
          f"beside the bounds of small calls)")
    for dt in (torch.float32, torch.float64):
        reg, top = K.gj_limits(dt)
        print(f"gj_inverse {dt}: register kernel for n <= {reg}, "
              f"register-tile kernel up to n = {top}")
    entry = _gj_row(torch, K, g, 10, 1 << 17, torch.float32)
    print("gj_inverse f64 figures (bound: bytes only): "
          + json.dumps(_gj_row(torch, K, g, 10, 1 << 17, torch.float64)))
    entry["empty_launch_ms"] = floor
    entry["path_shapes"] = []
    for L in (4096, 6912, 32768, 55296, 40, HS_NX * HS_NY, AACHEN_BIN_LANES,
              MIST_SPLIT_LANES):
        row = _gj_row(torch, K, g, 10, L, torch.float32)
        print(f"gj_inverse n=10 L={L} f32: " + json.dumps(row))
        entry["path_shapes"].append(row)
    entry["n54"] = []
    for dt in (torch.float32, torch.float64):
        row = _gj_row(torch, K, g, 54, 4096, dt)
        print(f"gj_inverse n=54 L=4096 {row['dtype']}: " + json.dumps(row))
        entry["n54"].append(row)
    return entry


def _mlp_operands(torch, g, wdt, B, S=MLP_S, widths=MLP_WIDTHS):
    """Operands of mlp_fused at the DNN path's widths: He-scaled normal
    weights (the first layer padded with zero rows to 16, as DFODENet
    stacks it), small biases, x of unit scale. The weights are row-major;
    the kernel takes them through mlp_pack."""
    dev = "cuda"
    xdt = torch.float32 if wdt == torch.bfloat16 else wdt
    Ws, bs = [], []
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        W = torch.randn((S, a, b), generator=g, device=dev) * (2.0 / a) ** 0.5
        if i == 0:
            W = torch.nn.functional.pad(W, (0, 0, 0, (-a) % 16))
        Ws.append(W.to(wdt).contiguous())
        bs.append((0.1 * torch.randn((S, b), generator=g, device=dev)).to(xdt))
    x = torch.randn((B, widths[0]), generator=g, device=dev).to(xdt)
    return x, Ws, bs


def _mlp_work(B, S, widths, wsize, xsize) -> tuple[float, float]:
    """(bytes, operations) of one call through widths F -> ... -> 1: x,
    weights, biases and out once; two operations per multiply-add of the
    four layers (unpadded)."""
    macs = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    n_bytes = (B * widths[0] * xsize + S * macs * wsize
               + S * sum(widths[1:]) * xsize + B * S * xsize)
    return n_bytes, 2.0 * B * S * macs


def mlp_bound(mode: str, B: int, S: int = MLP_S,
              widths=MLP_WIDTHS) -> tuple[float, float, float, str]:
    """(bytes, operations, bound ms, what binds) of one mlp_fused call in
    mode bf16, f32 or f64: the operations at the peak of the units that do
    them (bf16 and f64 tensor cores, f32 CUDA cores)."""
    wsize, xsize, rate = MLP_MODES[mode]
    n_bytes, flops = _mlp_work(B, S, widths, wsize, xsize)
    return (n_bytes, flops) + bound_ms(n_bytes, flops, rate)


def _mlp_row(torch, K, g, wdt, B, tol, reps, warm, chunk,
             plain_reps) -> dict:
    """One mode of mlp_fused against its plain version (`chunk` lanes at a
    time) at B lanes of the DNN path's widths: agreement, the plan of the
    kernel's library, the scratch bytes the call held beyond its result
    (the allocator's peak during one call less what stays allocated after
    it), device ms summed over all the call's CUDA launches (every record of
    the profiled window must be one of its kernels, as many as the plan
    says, none missing), the launches per call that window recorded,
    TFLOP/s and the share of the bound."""
    name = {torch.bfloat16: "bf16", torch.float32: "f32",
            torch.float64: "f64"}[wdt]
    x, Ws, bs = _mlp_operands(torch, g, wdt, B)
    Ws = K.mlp_pack(Ws)
    sets = [(x, Ws, bs), (torch.randn(x.shape, generator=g, device="cuda").to(
        x.dtype), Ws, bs)]
    plain = lambda x_, W_, b_: K.mlp_fused_plain(x_, W_, b_, chunk=chunk)
    S, K1, H1 = Ws[0].shape
    plan = K.mlp_plan(wdt, B, S, K1, H1, Ws[1].shape[2], Ws[2].shape[2])
    print(f"mlp_fused {name} B={B} plan of its library: chunk {plan[0]} "
          f"lanes, {plan[1]} CUDA launches, {plan[2]} bytes of scratch")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    y = K.mlp_fused(x, Ws, bs)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    scratch = torch.cuda.max_memory_allocated() - held
    check(held - before >= y.numel() * y.element_size()
          and scratch >= plan[2],
          f"mlp_fused {name} held {scratch} bytes beyond its result, the "
          f"plan needs {plan[2]}")
    err, rel = max_rel_err(torch, y, plain(x, Ws, bs))
    del y
    print(f"mlp_fused {name} B={B} S={S} widths "
          f"{'-'.join(map(str, MLP_WIDTHS))}: max abs err {err:.3e}, rel "
          f"{rel:.3e} (tolerance {tol:g} of the largest |out|)")
    check(rel <= tol, f"mlp_fused {name} B={B} disagrees with its plain "
                      f"version")
    _, flops, b_ms, b_by = mlp_bound(name, B)
    row = dict(
        route="cuda", source="deepflame_torch/csrc/mlp_fused.cu",
        replaces=f"{PALLAS}:69 (mlp_fused_lanes)", max_abs_err=err,
        **timings(torch, K.mlp_fused, "mlp_fused_", plain, sets,
                  plain_reps=plain_reps, reps=reps, warm=warm,
                  ops_per_call=plan[1]),
        bound_ms=b_ms, bound_by=b_by, shape=[B, S, MLP_WIDTHS[0]], dtype=name)
    row.update(scratch_bytes=scratch, tflops=flops / row["ms"] / 1e9,
               bound_share=b_ms / row["ms"])
    return row


def _mlp_figures(torch, K, g) -> dict:
    """mlp_fused against its plain version, S = 8, widths 11 -> 1600 -> 800
    -> 400 -> 1: bf16 at the DNN main path's one call (B = 96^3 cells),
    f32 at B = 2^14 and at 96^3 (the f32 mode is what a DNN case built by
    the case runtime runs), f64 at B = 2^12; the plain version in 2^17-lane
    chunks. Tolerances relative to the largest |out|: bf16 2e-3 (a sum in
    another order can move one bf16 rounding of an activation), f32 1e-5,
    f64 1e-12. No single PyTorch call computes the four-layer MLP, so the
    library time is null. The yardstick is the cuBLAS chain: for f32 and
    f64 the plain version itself (four torch.matmul and three F.gelu in the
    mode's type), its device time printed again as `cublas_chain_ms`; for
    bf16, whose plain version rounds in float32, four torch.baddbmm and
    three F.gelu in bf16, 2^17 lanes at a time. The port never calls
    either. The bf16 row is the kernels line's entry; the f32 and f64 rows
    are its `modes`."""
    import torch.nn.functional as F_nn

    chunk = 1 << 17
    bf16 = _mlp_row(torch, K, g, torch.bfloat16, N_MAIN ** 3, 2e-3, reps=5,
                    warm=3, chunk=chunk, plain_reps=2)
    modes = [_mlp_row(torch, K, g, wdt, B, tol, reps, warm, chunk, plain_reps)
             for wdt, B, tol, reps, warm, plain_reps in (
                 (torch.float32, 1 << 14, 1e-5, 20, 3, 5),
                 (torch.float32, N_MAIN ** 3, 1e-5, 3, 1, 2),
                 (torch.float64, 1 << 12, 1e-12, 20, 3, 5))]
    for row in modes:
        row["cublas_chain_ms"] = row["plain_ms"]
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
    bf16["cublas_chain_ms"] = device_ms(torch, chain, [(xs,)], reps=3, warm=1)
    del xs
    for row in modes:
        print(f"mlp_fused {row['dtype']} B={row['shape'][0]} figures: "
              + json.dumps(row))
    bf16["modes"] = modes
    return bf16


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


# kernels each path must launch during its timed steps (hs and fgm check
# theirs in their phases: gj_inverse; stencil7_apply and helmholtz7_apply)
PATH_KERNELS = {"stiff": ("stencil7_apply", "helmholtz7_apply", "gj_inverse"),
                "dnn": ("stencil7_apply", "helmholtz7_apply", "mlp_fused"),
                "fl": ("ell_matvec", "gj_inverse"),
                "sjet": ("stencil7_apply", "helmholtz7_apply", "gj_inverse")}
STEP_DT = {"stiff": DT, "dnn": DT, "fl": JET_DT, "sjet": JET_DT,
           "fljet": JET_DT,
           "sjet-pasr": JET_DT}


def _build_case(path: str, n: int, dtype, device=None, **kw):
    from deepflame_torch.cases import (jet_flame_3d_les, jet_flame_3d_les_fl,
                                       reacting_tgv_3d_les,
                                       reacting_tgv_3d_les_dnn)
    build = {"stiff": reacting_tgv_3d_les, "fl": jet_flame_3d_les_fl,
             "sjet": jet_flame_3d_les, "dnn": reacting_tgv_3d_les_dnn}[path]
    return build(MECH, n=n, dtype=dtype, device=device, **kw)


def with_config(solver, **kw):
    """The solver with LowMachConfig fields replaced."""
    return dataclasses.replace(solver, config=dataclasses.replace(
        solver.config, **kw))


def _dynamic_smagorinsky(solver):
    from deepflame_torch.turbulence import dynamic_smagorinsky
    return dataclasses.replace(solver, turbulence=dynamic_smagorinsky())


# the reference phase's cases: (label, path, keyword arguments of the case
# function, change to the solver it returns)
REFERENCE_CASES = (
    ("stiff", "stiff", {}, None),
    ("dnn", "dnn", {"compute_dtype": None}, None),
    ("fl", "fl", {}, None),
    ("sjet", "sjet", {}, None),
    ("sjet mg", "sjet", {}, lambda s: with_config(s, p_precond="mg")),
    ("stiff dynamicSmagorinsky", "stiff", {}, _dynamic_smagorinsky),
)


def phase_reference(torch, K) -> None:
    """Two float64 steps of each n = 8 case on the card (kernels) against
    the port's CPU path (plain versions): the stiff TGV; the DNN case, its
    MLP in float64 (the f64 kernel) with the same seeded weights on both
    sides; the face-list jet (16 x 8 x 8 cells); the structured jet (16 x 8
    x 8) with Jacobi and with multigrid pressure preconditioning; the stiff
    TGV with the dynamic Smagorinsky model. Then a constant-volume 0D
    ignition on the card against the CPU. Every run, card or CPU, is
    host-bound and runs in one of four worker processes side by side."""
    with _pool(4) as pool:
        ign = {dev: pool.submit(_ignite_cv_worker, dev)
               for dev in ("cuda", "cpu")}
        runs = {(label, dev): pool.submit(_reference_case_worker, label, dev)
                for label, *_ in REFERENCE_CASES for dev in ("cuda", "cpu")}
        for label, path, kw, change in REFERENCE_CASES:
            card, launched = runs[label, "cuda"].result()
            ref, _ = runs[label, "cpu"].result()
            check(all(launched[k] > 0 for k in PATH_KERNELS[path]),
                  f"{label} reference step on the card did not launch "
                  f"{PATH_KERNELS[path]}")
            worst = 0.0
            for k, a in card.items():
                _, rel = max_rel_err(torch, a, ref[k])
                worst = max(worst, rel)
                # round-off: sums taken in another order on the card (see
                # tests/test_torch_low_mach.py for the same bound against
                # JAX)
                check(rel <= (1e-6 if k == "U" else 1e-8),
                      f"{label} reference {k}: {rel:.3e}")
            print(f"reference ({label}): n=8 float64, 2 steps on the card "
                  f"vs the CPU path: largest field deviation {worst:.3e} of "
                  f"the field's largest value")
        _reference_ignite(torch, ign["cuda"].result(), ign["cpu"].result())


def _reference_case(torch, label: str, dev: str):
    """Two float64 steps of REFERENCE_CASES' `label` on `dev`: (its fields
    p, T, U, Y, rho and ha on the host, the kernel launches counted)."""
    from deepflame_torch.ops import kernels as K
    _, path, kw, change = next(c for c in REFERENCE_CASES if c[0] == label)
    before = dict(K.launches)
    solver, state = _build_case(path, 8, torch.float64, device=dev, **kw)
    if change is not None:
        solver = change(solver)
    for _ in range(2):
        state, _ = solver.step(state, STEP_DT[path])
    return ({k: getattr(state, k).cpu()
             for k in ("p", "T", "U", "Y", "rho", "ha")},
            {k: K.launches[k] - before[k] for k in K.launches})


def _reference_case_worker(label: str, dev: str):
    """In a worker: _reference_case of `label` on `dev`."""
    return _reference_case(_worker_torch(), label, dev)


def _reference_ignite(torch, card, ref) -> None:
    """Constant-volume ignition of the test mechanism's H2/air at 1200 K,
    0.2 ms in 10 outputs, float64, on the card and on the CPU (card, ref:
    _ignite_cv's results): T and Y within 1e-8 of their largest values; T
    rises past 2800 K."""
    errs = [max_rel_err(torch, a, b)[1] for a, b in zip(card, ref)]
    print(f"reference (constant-volume ignite): T(end) "
          f"{float(card[0][-1]):.2f} K on the card, "
          f"{float(ref[0][-1]):.2f} K on the CPU; deviations T "
          f"{errs[0]:.3e}, Y {errs[1]:.3e} of the largest values")
    check(max(errs) <= 1e-8, "constant-volume ignite: card and CPU differ")
    check(float(card[0][-1]) > 2800.0,
          "constant-volume ignite did not ignite")


def _ignite_cv(torch, dev: str):
    """_reference_ignite's run on `dev`: (T (10,), Y (10, ns)) on the
    host."""
    from deepflame_torch.chemistry import (load_mechanism, make_kinetics,
                                           make_thermo)
    from deepflame_torch.chemistry.integrator import RosenbrockOptions
    from deepflame_torch.chemistry.reactor import ignite
    mech = load_mechanism(MECH, device=dev)
    Y0 = [0.0] * mech.n_species
    for name, y in (("H2", 0.0285), ("O2", 0.2264), ("N2", 0.7451)):
        Y0[mech.species_index(name)] = y
    _, T, Y = ignite(make_thermo(mech), make_kinetics(mech), 1200.0,
                     101325.0, Y0, 2e-4, 10, "volume",
                     RosenbrockOptions(rtol=1e-5, atol=1e-10))
    return T.cpu(), Y.cpu()


def _ignite_cv_worker(dev: str):
    return _ignite_cv(_worker_torch(), dev)


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


def build_sjet(torch, n: int):
    """The structured jet at (2n, n, n) in float32, timed."""
    t0 = time.perf_counter()
    solver, state = _build_case("sjet", n, torch.float32)
    torch.cuda.synchronize()
    print(f"sjet path: structured jet, {solver.mesh.shape} cells, built in "
          f"{time.perf_counter() - t0:.2f} s ({solver.combustion.n_bins} "
          f"chemistry bins, {len(solver.bcs_Y)} species BCs stacked on "
          f"{solver.bcs_Y_lanes[0][0].value[1].shape[0]} lanes, pressure "
          f"preconditioner {solver.config.p_precond}, dt {JET_DT:g} s)")
    return solver, state


def _check_sjet(torch, solver, state) -> None:
    """Structured jet state: shapes, Y summing to 1 in every cell, outward
    mass fluxes through the inlet (the first x faces of phi[0]) and the
    outlet (its last x faces) finite and of opposite sign."""
    sh = solver.mesh.shape
    check(state.T.shape == sh and state.Y.shape == (9,) + sh,
          "sjet: state shapes")
    check(float((state.Y.sum(0) - 1.0).abs().max()) < 1e-5,
          "sjet: mass fractions do not sum to 1")
    area = solver.mesh.dy * solver.mesh.dz
    flux = {"inlet": -float(state.phi[0][0].sum()) * area,
            "outlet": float(state.phi[0][-1].sum()) * area}
    print(f"sjet boundary mass fluxes, outward [kg/s]: {json.dumps(flux)}")
    check(all(math.isfinite(v) for v in flux.values()),
          "sjet: non-finite boundary flux")
    check(flux["inlet"] < 0.0 < flux["outlet"],
          "sjet: inlet and outlet mass fluxes are not of opposite sign")


def phase_main(torch, K, path: str, n: int, steps: int,
               profile: str | None, built=None):
    """One warm-up step (bench.py takes two on the jet) and `steps` timed
    steps of a main path in float32; returns the launch
    counts of the timed steps and (solver, state, ms/step, diagnostics of
    the last step) after them.
    `built`: (solver, state) built already."""
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
    t0 = time.perf_counter()
    state, diag = solver.step(state, dt)
    torch.cuda.synchronize()
    print(f"{path} warm-up step: {time.perf_counter() - t0:.3f} s")
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
    elif path == "sjet":
        _check_sjet(torch, solver, state)
    else:
        check(state.T.shape == (n, n, n) and state.Y.shape == (9, n, n, n),
              f"{path}: state shapes")
        check(float((state.Y.sum(0) - 1.0).abs().max()) < 1e-5,
              f"{path}: mass fractions do not sum to 1")
    if path == "dnn":
        _check_dnn_rates(torch, solver, state)
    _breakdown_step(torch, solver, state, path)
    if profile or path == "dnn":
        _profile_step(torch, solver, state, ms, profile, path)
    return counts, (solver, state, ms, diag)


def phase_sjet_mg(torch, K, solver, state, jacobi_ms, jacobi_diag,
                  jacobi_counts) -> None:
    """One more step of the structured jet's state with multigrid pressure
    preconditioning, synchronised and timed alone, printed beside the timed
    Jacobi steps (ms/step, pressure-CG iterations of the last, launches per
    step). The multigrid step must launch the Helmholtz kernel's BC form
    on every level of its hierarchy (the shapes its calls take: the CG's
    and the V-cycle's)."""
    from deepflame_torch.ops.multigrid import mg_levels

    shapes, inner = set(), K.helmholtz7_apply_bc

    def recorded(x, gamma, diag, spacing, rule):
        shapes.add(tuple(diag.shape))
        return inner(x, gamma, diag, spacing, rule)

    K.reset_launches()
    K.helmholtz7_apply_bc = recorded
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, diag = with_config(solver, p_precond="mg").step(state, JET_DT)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        K.helmholtz7_apply_bc = inner
    check(bool(torch.isfinite(new.T).all() and torch.isfinite(new.p).all()),
          "sjet multigrid step: non-finite T or p")
    out = {"jacobi": dict(ms=jacobi_ms, iters_p=int(jacobi_diag["iters_p"]),
                          launches={k: v / STEPS
                                    for k, v in jacobi_counts.items()}),
           "mg": dict(ms=ms, iters_p=int(diag["iters_p"]),
                      launches=dict(K.launches))}
    print("sjet: a step with each pressure preconditioner (jacobi: the timed "
          "steps' mean): " + json.dumps(out))
    # the hierarchy's shapes (any cell and face operands give them)
    levels = {m.shape for m, *_ in mg_levels(
        solver.mesh, state.T, tuple(state.phi))}
    print(f"sjet multigrid: Helmholtz kernel shapes in the step "
          f"{sorted(shapes)}; hierarchy {sorted(levels)}")
    check(shapes == levels, "sjet multigrid: the Helmholtz kernel did not "
                            "run on every level")
    check(all(K.launches[k] > 0 for k in PATH_KERNELS["sjet"]),
          "sjet multigrid step: a kernel of the path was not launched")


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


def _timed_inside(torch, owner, attr, run):
    """run() with owner.attr timed inside it, synchronised before and after
    each call: (seconds of run, [seconds of each call])."""
    total, spent = _timed_many(torch, [(owner, attr)], run)
    return total, spent[attr]


def _timed_many(torch, targets, run):
    """run() with each (owner, attr) of `targets` timed inside it, each
    call synchronised before and after: (seconds of run, {attr: [seconds
    of each call]})."""
    spent = {a: [] for _, a in targets}
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr in targets]
    for owner, attr, inner in saved:
        def timed(*a, _inner=inner, _attr=attr, **k):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            r = _inner(*a, **k)
            torch.cuda.synchronize()
            spent[_attr].append(time.perf_counter() - t1)
            return r
        setattr(owner, attr, timed)
    try:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, spent
    finally:
        for owner, attr, inner in saved:
            setattr(owner, attr, inner)


def _breakdown_step(torch, solver, state, path: str) -> None:
    """One more step with the chemistry call timed inside it (synchronised
    before and after), for the chemistry's share of a step: the stiff
    integrator (solve_chemistry), the DNN model's correct() or PaSR's
    correct() (its transport of Z, Zvar and Chi comes before it)."""
    import deepflame_torch.combustion.basic as basic
    from deepflame_torch.combustion import DNNChemistry, PaSR

    owner, attr = {"dnn": (DNNChemistry, "correct"),
                   "sjet-pasr": (PaSR, "correct")}.get(
                       path, (basic, "solve_chemistry"))
    total, spent = _timed_inside(torch, owner, attr,
                                 lambda: solver.step(state, STEP_DT[path]))
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


# ---------------------------------------------------------------- PaSR, EDC

JET_OPTS = dict(rtol=1e-4, atol=1e-8, max_steps=2000, grow=10.0)


def _jet_h2(torch, dev):
    from deepflame_torch.chemistry import load_mechanism
    return load_mechanism(MECH, device=dev).species_index("H2")


def _pasr_case(dtype: str):
    """The case dictionary whose factory model the PaSR phases run: PaSR
    dynamicScale with the jet's own stiff tolerances (rtol 1e-4, atol 1e-8;
    the factory's 20000 steps and growth 10)."""
    from deepflame_torch.runtime import config as C
    return C.CaseConfig(
        chemistry=C.ChemistryProperties(mechanism_file=MECH, ode_rtol=1e-4,
                                        ode_atol=1e-8),
        combustion=C.CombustionProperties(model="PaSR",
                                          pasr_mixing_scale="dynamicScale"),
        dtype=dtype)


def _mixing_jet(torch, model: str, n: int, dtype, dev):
    """The structured jet with PaSR dynamicScale (from the factory, Z fixed
    at the inlet to Y_H2 / 0.30) or EDC v2005 (the jet's stiff options)."""
    from deepflame_torch.cases import jet_flame_3d_les, jet_with_combustion
    from deepflame_torch.chemistry.integrator import RosenbrockOptions
    from deepflame_torch.combustion import EDC
    from deepflame_torch.runtime.factory import build_combustion
    solver, state = jet_flame_3d_les(MECH, n=n, dtype=dtype, device=dev)
    th, kin = solver.thermo, solver.combustion.kinetics
    if model == "PaSR":
        comb = build_combustion(_pasr_case(
            "float64" if dtype == torch.float64 else "float32"), th, kin)
    else:
        comb = EDC(th, kin, ode_opts=RosenbrockOptions(**JET_OPTS))
    return jet_with_combustion(solver, state, comb, _jet_h2(torch, dev))


class _Recorder:
    """A solver whose step is the given solver's, keeping each step's
    diagnostics (run_case calls only .step)."""

    def __init__(self, solver):
        self.solver, self.diags = solver, []

    def step(self, state, dt):
        state, diag = self.solver.step(state, dt)
        self.diags.append(diag)
        return state, diag


class _FieldSpy:
    """A function object that keeps CPU copies of named fields at each
    call (for the min/max runner-up test)."""

    def __init__(self, names):
        self.names, self.calls = names, []

    def __call__(self, time, fields):
        self.calls.append({k: fields[k].detach().double().cpu()
                           for k in self.names if k in fields})


def _run_fo(torch, solver, state, out_dir, steps, with_z, spy=None):
    """run_case over `steps` steps of JET_DT from t = 0 with the jet's
    function-object set writing every step under out_dir; (state,
    recorder, function objects)."""
    from deepflame_torch.cases import jet_fields, jet_function_objects
    from deepflame_torch.runtime.config import ControlDict
    from deepflame_torch.runtime.driver import run_case
    fo = jet_function_objects(solver, out_dir, JET_DT, with_z=with_z)
    if spy is not None:
        fo.inner.objects.append(spy)
    rec = _Recorder(solver)
    state = run_case(rec, state._replace(time=torch.zeros_like(state.time)),
                     ControlDict(end_time=steps * JET_DT, delta_t=JET_DT,
                                 write_interval=JET_DT),
                     function_objects=fo, fields_fn=jet_fields,
                     log_every=steps)
    return state, rec, fo


def _files(root: str) -> dict:
    import numpy as np
    out = {}
    for base, _, names in os.walk(root):
        for f in names:
            path = os.path.join(base, f)
            out[os.path.relpath(path, root)] = np.loadtxt(path, ndmin=2)
    return out


# fields computed from velocity gradients (and the flux): their columns
# carry the velocity's round-off, amplified where Q's or lambda2's terms
# cancel
_FLOW_FIELDS = ("Q", "lambda2", "magVorticity", "Ma", "Co", "phi_x", "U")


def _columns(obj) -> tuple[str, list]:
    """(output sub-directory, the field each column of its files holds)
    of one of the jet's function objects (None: time or coordinates)."""
    import deepflame_torch.runtime.function_objects as F
    name = os.path.basename(obj.out_dir)
    if isinstance(obj, F.FieldMinMax):
        return name, [None] + [f for f in obj.fields for _ in range(8)]
    if isinstance(obj, F.Probes):
        return name, [None] + [f for f in obj.fields for _ in obj.idx]
    if isinstance(obj, F.Histogram):
        return name, [obj.field, None]
    if isinstance(obj, (F.VolFieldValue, F.SurfaceFieldValue)):
        return name, [None] + [f for f in obj.fields for _ in obj.ops]
    return name, [None] + list(obj.fields)          # LineSample


def _compare_fo(torch, card, cpu, tol: float = 1e-10,
                tol_flow: float = 1e-8) -> dict:
    """The function-object files of the card run against the CPU run's
    (each side as _tci_side returns it):
    probe and line cells and histogram counts equal; each value within tol
    of its column's largest (tol_flow for the columns of _FLOW_FIELDS);
    min/max locations equal wherever the CPU field's runner-up differs
    from its extremum by more than the column's tolerance of the field's
    largest |value|. Returns the largest deviation of each kind."""
    import numpy as np
    a_all, b_all = _files(card["dir"]), _files(cpu["dir"])
    check(set(a_all) == set(b_all) and a_all, "tci: file sets differ")
    check(card["probe_idx"] == cpu["probe_idx"], "tci: probe cells differ")
    for fa, fb in zip(card["lines"], cpu["lines"]):
        check(bool(torch.equal(fa, fb)), "tci: line cells differ")
    cols = cpu["columns"]
    worst = {"fields": 0.0, "flow": 0.0}
    for path, B in b_all.items():
        A = a_all[path]
        check(A.shape == B.shape, f"tci: {path} shapes differ")
        names = cols[path.split(os.sep)[0]]
        flow = np.array([n in _FLOW_FIELDS for n in names])
        col_tol = np.where(flow, tol_flow, tol)
        dev = np.abs(A - B) / np.maximum(np.abs(B).max(0), 1e-300)
        if "histogram" in path:
            check(np.array_equal(A[:, 1], B[:, 1]),
                  f"tci: {path} counts differ")
        if "fieldMinMax" in path:
            for r, fields in enumerate(cpu["spy"]):
                for k, name in enumerate(cpu["minmax_fields"]):
                    f = fields[name].reshape(-1)
                    fs = float(f.abs().max())
                    c0 = 8 * k
                    for off, top in ((1, False), (5, True)):
                        v = f.sort(descending=top).values[:2]
                        c = c0 + off
                        if float((v[0] - v[1]).abs()) > col_tol[c] * fs:
                            check(np.array_equal(A[r, c + 1:c + 4],
                                                 B[r, c + 1:c + 4]),
                                  f"tci: {name} extremum location differs")
                        dev[r, c + 1:c + 4] = 0.0        # checked above
        for kind, sel in (("fields", ~flow), ("flow", flow)):
            if sel.any():
                worst[kind] = max(worst[kind], float(dev[:, sel].max()))
        bad = (dev > col_tol).any(0)
        check(not bad.any(), f"tci: {path} columns {np.nonzero(bad)[0]} "
                             f"deviate {dev.max(0)}")
    return worst


def _tci_side(torch, model: str, dev: str, out_dir: str) -> dict:
    """One side of a tci gate: the n = 8 float64 jet with `model` on `dev`,
    2 steps through run_case with the jet's function objects writing under
    out_dir. Returns, on the host: the fields and transported scalars, the
    last step's iterations, the min/max spy's field copies, the probe and
    line cells, the columns of each output directory's files, the min/max
    object's fields, the kernel launches the run counted and out_dir."""
    from deepflame_torch.ops import kernels as K
    before = dict(K.launches)
    solver, state = _mixing_jet(torch, model, 8, torch.float64, dev)
    spy = _FieldSpy(("T", "p", "Q") + (("Z",) if model == "PaSR" else ()))
    state, rec, fo = _run_fo(torch, solver, state, out_dir, 2,
                             model == "PaSR", spy)
    objs = fo.inner.objects
    return dict(
        fields={k: getattr(state, k).cpu()
                for k in ("p", "T", "U", "Y", "rho", "ha")},
        cscalars=[c.cpu() for c in state.cscalars],
        iters={k: float(v) for k, v in rec.diags[-1].items()
               if k.startswith("iters")},
        spy=spy.calls, probe_idx=objs[1].idx,
        lines=[objs[i]._flat.cpu() for i in (2, 3)],
        columns=dict(_columns(o) for o in objs if hasattr(o, "out_dir")),
        minmax_fields=objs[0].fields,
        launched={k: K.launches[k] - before[k] for k in K.launches},
        dir=out_dir)


def _tci_side_worker(model: str, dev: str, out_dir: str) -> dict:
    return _tci_side(_worker_torch(), model, dev, out_dir)


def _tci_submit(pool, tmp: str) -> dict:
    """Submit phase_tci's four runs (each model on the card and on the
    CPU), writing under tmp."""
    return {(m, dev): pool.submit(_tci_side_worker, m, dev,
                                  os.path.join(tmp, f"{m}_{dev}"))
            for m in ("EDC", "PaSR") for dev in ("cuda", "cpu")}


def phase_tci(torch, K, runs=None) -> dict:
    """The structured jet at n = 8 (16 x 8 x 8) in float64 with PaSR
    dynamicScale and with EDC v2005, 2 steps through run_case with the
    jet's function-object set, on the card and on the CPU path (each run
    in one of four worker processes side by side; `runs`: those
    _tci_submit gave, else submitted here): every
    field and the transported Z, Zvar and Chi within 1e-8 of their largest
    values (U 1e-6); the written files as _compare_fo (1e-10 of each
    column's largest, 1e-8 for the columns computed from the velocity).
    Returns {model: the card's T} (the PaSR one feeds the OpenFOAM-IO
    check)."""
    if runs is None:
        with tempfile.TemporaryDirectory() as tmp, _pool(4) as pool:
            return phase_tci(torch, K, _tci_submit(pool, tmp))
    out = {}
    for model in ("PaSR", "EDC"):
        sc, sp = runs[model, "cuda"].result(), runs[model, "cpu"].result()
        check(all(sc["launched"][k] > 0 for k in PATH_KERNELS["sjet"]),
              f"tci {model}: a kernel of the path did not launch")
        check(not any(sp["launched"].values()),
              f"tci {model}: the CPU path counted a launch")
        devs = {}
        for k, a in sc["fields"].items():
            devs[k] = max_rel_err(torch, a, sp["fields"][k])[1]
            check(devs[k] <= (1e-6 if k == "U" else 1e-8),
                  f"tci {model} {k}: {devs[k]:.3e}")
        check(len(sc["cscalars"]) == (3 if model == "PaSR" else 0),
              f"tci {model}: transported scalars")
        for name, a, b in zip(("Z", "Zvar", "Chi"), sc["cscalars"],
                              sp["cscalars"]):
            devs[name] = max_rel_err(torch, a, b)[1]
            check(devs[name] <= 1e-8, f"tci {model} {name}: "
                                      f"{devs[name]:.3e}")
        worst = max(devs.values())
        fo_worst = _compare_fo(torch, sc, sp)
        print(f"tci ({model}): n=8 float64, 2 steps through run_case on "
              f"the card vs the CPU path: largest field deviation "
              f"{worst:.3e}; function-object files, of each column's "
              f"largest: {fo_worst['fields']:.3e} (field columns), "
              f"{fo_worst['flow']:.3e} (columns from velocity "
              f"gradients and fluxes); last step "
              + json.dumps(sc["iters"])
              + f"; by field {json.dumps(devs)}")
        out[model] = sc["fields"]["T"]
    return out


def _count_trips(torch, K):
    """Context wrapper of the reactor's batched integrator that records,
    per drain, (trips run = gj_inverse launches, trips needed = the trips
    at whose start some lane was running, return_nstep)."""
    import contextlib
    import deepflame_torch.chemistry.reactor as R

    @contextlib.contextmanager
    def cm():
        inner, drains = R.rosenbrock_integrate_batched, []

        def counted(*a, **k):
            n0 = K.launches["gj_inverse"]
            y, dt, need = inner(*a, return_nstep=True, **k)
            drains.append((K.launches["gj_inverse"] - n0, need))
            return y, dt
        R.rosenbrock_integrate_batched = counted
        try:
            yield drains
        finally:
            R.rosenbrock_integrate_batched = inner
            drains[:] = [(run, int(need)) for run, need in drains]
    return cm()


def _fo_cost(torch, fo, fields, profile: bool = True) -> dict:
    """Wall ms (synchronised), bytes and transfers to the host, and device
    ms (torch.profiler) of one call of the function-object set."""
    from torch.profiler import ProfilerActivity, profile as prof_
    import deepflame_torch.runtime.function_objects as F
    torch.cuda.synchronize()
    F.reset_transfers()
    t0 = time.perf_counter()
    fo(1.0, fields)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    moved = dict(F.transfers)
    dev_ms = None
    if profile:
        with prof_(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as p:
            fo(2.0, fields)
            torch.cuda.synchronize()
        dev_ms = sum(e.time_range.elapsed_us() for e in p.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return dict(wall_ms=wall, device_ms=dev_ms, bytes=moved["bytes"],
                transfers=moved["count"])


def phase_sjet_pasr(torch, K, steps: int = STEPS):
    """The structured jet at 128 x 64 x 64 in float32 with the factory's
    PaSR dynamicScale through run_case: 1 warm-up step, then `steps` timed
    steps with the launch counts set to 0 just before and read just after,
    the function-object set writing every step. Then one more step with
    the drains' trips counted, and the function objects' cost on the final
    state. Returns (launch counts of the timed steps, ms/step, solver,
    state)."""
    import tempfile
    import numpy as np
    from deepflame_torch.cases import jet_fields, jet_function_objects
    t0 = time.perf_counter()
    solver, state = _mixing_jet(torch, "PaSR", N_JET, torch.float32, "cuda")
    torch.cuda.synchronize()
    comb = solver.combustion
    print(f"sjet-pasr: {solver.mesh.shape} cells, PaSR {comb.mixing_scale} "
          f"/ {comb.chemistry_scale} from the factory (rtol "
          f"{comb.ode_opts.rtol:g}, atol {comb.ode_opts.atol:g}, "
          f"{comb.ode_opts.max_steps} steps, {comb.n_bins} bins), built in "
          f"{time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        state, _, _ = _run_fo(torch, solver, state, os.path.join(tmp, "w"),
                              1, True)
        torch.cuda.synchronize()
        print(f"sjet-pasr warm-up: 1 step in {time.perf_counter() - t0:.2f}"
              f" s")
        T_before = state.T.clone()
        torch.cuda.reset_peak_memory_stats()
        out = os.path.join(tmp, "timed")
        K.reset_launches()
        t0 = time.perf_counter()
        state, rec, fo = _run_fo(torch, solver, state, out, steps, True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(K.launches)
        ms = wall / steps * 1e3
        n_cells = state.T.numel()
        print(f"sjet-pasr counts over {steps} steps: {json.dumps(counts)}; "
              f"per step " + json.dumps({k: v / steps
                                         for k, v in counts.items()}))
        print(f"sjet-pasr path: {ms:.2f} ms/step through run_case (the "
              f"function objects included), {n_cells / (wall / steps):.4e} "
              f"cell-updates/s ({n_cells} cells), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        print("sjet-pasr diagnostics of the last step: " + json.dumps(
            {k: float(v) for k, v in rec.diags[-1].items()}))
        check(all(counts[k] > 0 for k in PATH_KERNELS["sjet"]),
              f"a kernel of the sjet-pasr path was not launched: {counts}")
        check(bool(torch.isfinite(state.T).all()
                   and torch.isfinite(state.p).all()), "sjet-pasr: non-finite")
        check(float((state.T - T_before).abs().max()) > 0.0,
              "sjet-pasr: T did not change")
        T_lo, T_hi = float(state.T.min()), float(state.T.max())
        check(200.0 <= T_lo and T_hi <= 3500.0,
              f"sjet-pasr: T in [{T_lo}, {T_hi}]")
        check(float(state.cscalars[0].max()) > 0.5,
              "sjet-pasr: no fuel-stream mixture fraction")
        _check_fo_files(torch, solver, fo, out, steps)
        with _count_trips(torch, K) as drains:
            t0 = time.perf_counter()
            state2, diag = solver.step(state, JET_DT)
            torch.cuda.synchronize()
        run = sum(d[0] for d in drains)
        need = sum(d[1] for d in drains)
        print(f"sjet-pasr trips: one more step ({(time.perf_counter() - t0) * 1e3:.2f} ms "
              f"with the counting) ran {len(drains)} drains, gj_inverse "
              f"trips run {run}, needed {need}; by drain (run, needed) "
              f"{drains}")
        _breakdown_step(torch, solver, state2, "sjet-pasr")
        cost = _fo_cost(torch, fo, jet_fields(state2))
        print("sjet-pasr function objects per write: " + json.dumps(cost)
              + f"; {cost['wall_ms'] / ms:.4f} of a step")
        check(cost["transfers"] == 9, "sjet-pasr: the function objects did "
                                      "not move one row an object")
    return counts, ms, solver, state2


def _check_fo_files(torch, solver, fo, out: str, writes: int) -> None:
    """Every file of the set exists with one row (time series) or one
    snapshot (line, histogram) per write, finite; line coordinates equal
    the cell centres."""
    import numpy as np
    files = _files(out)
    series = [p for p in files if "line_" not in p and "histogram" not in p]
    snaps = [p for p in files if p not in series]
    print(f"sjet-pasr function-object files: {len(series)} time series, "
          f"{len(snaps)} snapshots: {sorted(files)}")
    check(len(series) == 6 and len(snaps) == 3 * writes,
          "sjet-pasr: function-object files missing")
    for p, a in files.items():
        check(bool(np.isfinite(a).all()), f"sjet-pasr: {p} not finite")
        if p in series:
            check(a.shape[0] == writes, f"sjet-pasr: {p} has {a.shape[0]} "
                                        f"rows for {writes} writes")
    X, Yc, _ = (c.cpu().numpy() for c in solver.mesh.cell_centers())
    for p, a in files.items():
        if p.startswith("sample_axis"):
            check(np.array_equal(a[:, 0], X[:, 0, 0]), "line x coordinates")
        if p.startswith("sample_y30"):
            check(np.array_equal(a[:, 0], Yc[0, :, 0]), "line y coordinates")


def phase_sjet_edc(torch, K):
    """One step of the structured jet at 128 x 64 x 64 in float32 with EDC
    v2005 (the jet's stiff options: 2000 steps at most) from its initial
    state, with the launch counts set to 0 just before it and the drains'
    trips counted."""
    t0 = time.perf_counter()
    solver, state = _mixing_jet(torch, "EDC", N_JET, torch.float32, "cuda")
    torch.cuda.synchronize()
    print(f"sjet-edc: {solver.mesh.shape} cells, EDC "
          f"{solver.combustion.version}, built in "
          f"{time.perf_counter() - t0:.2f} s")
    K.reset_launches()
    with _count_trips(torch, K) as drains:
        t0 = time.perf_counter()
        new, diag = solver.step(state, JET_DT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = dict(K.launches)
    run = sum(d[0] for d in drains)
    need = sum(d[1] for d in drains)
    print(f"sjet-edc path: one step {wall * 1e3:.2f} ms, "
          f"{new.T.numel() / wall:.4e} cell-updates/s; counts "
          f"{json.dumps(counts)}; {len(drains)} drains, gj_inverse trips run "
          f"{run}, needed {need}; by drain {drains}")
    print("sjet-edc diagnostics: " + json.dumps(
        {k: float(v) for k, v in diag.items()}))
    check(all(counts[k] > 0 for k in PATH_KERNELS["sjet"]),
          f"a kernel of the sjet-edc path was not launched: {counts}")
    check(bool(torch.isfinite(new.T).all()), "sjet-edc: non-finite T")
    check(200.0 <= float(new.T.min()) and float(new.T.max()) <= 3500.0,
          "sjet-edc: T out of range")
    return counts, wall * 1e3


def phase_light(torch, K, sjet_state, sjet_solver, T_tci) -> None:
    """Card against CPU: the PR real-gas tables (make_real_gas) on the
    9-species mechanism at 10 MPa over the 96^3 TGV fields, float64 (rho,
    psi(p=), Z and h_departure within 1e-12 of each one's largest value);
    set_r_delta_t on the PaSR jet's float32 state (1e-6 of the largest);
    an OpenFOAM field file written from the n = 8 jet's T (float64) and
    read back onto the card, equal."""
    import tempfile
    import numpy as np
    from deepflame_torch.chemistry import load_mechanism, make_thermo
    from deepflame_torch.chemistry.real_gas import make_real_gas
    from deepflame_torch.ops.lts import set_r_delta_t
    from deepflame_torch.runtime.openfoam_io import read_openfoam_field
    t0 = time.perf_counter()
    _, tgv = _build_case("stiff", N_MAIN, torch.float64, device="cuda")
    res = {}
    for dev in ("cuda", "cpu"):
        mech = load_mechanism(MECH, device=dev)
        rg = make_real_gas(mech, make_thermo(mech))
        T, Yt = tgv.T.to(dev), torch.movedim(tgv.Y, 0, -1).to(dev)
        p = torch.full_like(T, 1e7)
        res[dev] = dict(rho=rg.rho(p, T, Yt), psi=rg.psi(T, Yt, p=p),
                        Z=rg.Z(p, T, Yt), h_departure=rg.h_departure(p, T, Yt))
    errs = {k: max_rel_err(torch, res["cuda"][k].cpu(), res["cpu"][k])[1]
            for k in res["cpu"]}
    print(f"real gas at 10 MPa on the {N_MAIN}^3 TGV fields, card vs CPU, "
          f"float64: " + json.dumps(errs) + f"; Z in "
          f"[{float(res['cpu']['Z'].min()):.5f}, "
          f"{float(res['cpu']['Z'].max()):.5f}]")
    check(max(errs.values()) <= 1e-12, "real gas: card and CPU differ")
    del tgv, res
    bcs = sjet_solver.bcs_coeff
    phi_cpu = tuple(f.cpu() for f in sjet_state.phi)
    from deepflame_torch.mesh import StructuredMesh
    m = sjet_solver.mesh
    m_cpu = StructuredMesh(m.nx, m.ny, m.nz, m.dx, m.dy, m.dz, m.x0, m.y0,
                           m.z0, device=torch.device("cpu"))
    a = set_r_delta_t(sjet_state.phi, sjet_state.rho, bcs, m)
    b = set_r_delta_t(phi_cpu, sjet_state.rho.cpu(), bcs, m_cpu)
    _, rel = max_rel_err(torch, a.cpu(), b)
    print(f"set_r_delta_t on the sjet-pasr state, card vs CPU, float32: "
          f"{rel:.3e} of the largest; rDeltaT in [{float(b.min()):.4e}, "
          f"{float(b.max()):.4e}] 1/s")
    check(rel <= 1e-6, "set_r_delta_t: card and CPU differ")
    T = T_tci.cpu().numpy()
    nx, ny, nz = T.shape
    flat = T.transpose(2, 1, 0).reshape(-1)       # blockMesh order, x fastest
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "T")
        with open(path, "w") as f:
            f.write("FoamFile\n{\n    class volScalarField;\n    object T;\n"
                    "}\ninternalField   nonuniform List<scalar>\n"
                    f"{flat.size}\n(\n" + "\n".join(repr(float(v))
                                                    for v in flat)
                    + "\n)\n;\n")
        back = read_openfoam_field(path, (nx, ny, nz), device="cuda")
    check(back.device.type == "cuda" and bool(torch.equal(back.cpu(),
                                                          T_tci.cpu())),
          "OpenFOAM field read back onto the card differs")
    print(f"OpenFOAM field file of the n=8 jet's T ({flat.size} cells) read "
          f"back onto the card: equal ({time.perf_counter() - t0:.1f} s for "
          f"the light checks)")


# ------------------------------------------------ density-based solver, FGM

AIR = os.path.join(HERE, "tests", "data", "air.yaml")
FGM_TABLE = os.path.join(HERE, "data", "flare_CH4_drm19_SandiaD_4D.tbl")
FGM_TABLE_NC41 = os.path.join(HERE, "data",
                              "flare_CH4_drm19_SandiaD_4D_nc41.tbl")
HS_NX, HS_NY, HS_STEPS = 2000, 100, 1      # the reference's 2D channel
FGM_NX, FGM_NY, FGM_STEPS = 1024, 512, 2   # the structured jet's cell count
FGM_DT = 4e-6 * 96 / FGM_NX                # the example's Courant number
FGM_LX = 0.12           # sandia_d_fgm_2d's slab length: spacing FGM_LX / nx
AACHEN_NXZ, AACHEN_NY = 41, 100            # the reference's 3D chamber
# lanes of one drain bin of the chamber (its Laminar model's 32 bins) and
# the most cells above 500 K in the mist's timed steps (2-3 a step)
AACHEN_BIN_LANES = -(-AACHEN_NXZ * AACHEN_NY * AACHEN_NXZ // 32)
MIST_SPLIT_LANES = 3
SOD_RUNS = (("HLLC", "vanLeer"), ("HLLCP", "vanLeer"), ("AUSMDV", "vanLeer"),
            ("Kurganov", "vanLeer"), ("Tadmor", "vanLeer"), ("HLLC", "WENO5"))
HS_FIELDS = ("rho", "rhoU", "rhoE", "rhoY", "T")
FGM_FIELDS = ("rho", "p", "Z", "Zvar", "c", "cvar", "T", "He")


def _pool(workers: int):
    """Worker processes for the hs and fgm gates, card and CPU sides, which
    are host-bound and so run side by side (spawned, so that no CUDA state
    is inherited; each opens its own context on the card; shut down by the
    caller before anything is timed)."""
    import concurrent.futures
    import multiprocessing
    return concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))


def _worker_torch():
    sys.path.insert(0, HERE)
    import torch
    torch.set_num_threads(2)
    return torch


def _as_numpy(state, fields) -> dict:
    return {k: (tuple(t.cpu().numpy() for t in getattr(state, k))
                if isinstance(getattr(state, k), tuple)
                else getattr(state, k).cpu().numpy()) for k in fields}


def _field_devs(torch, a, b, fields) -> dict:
    """{field: largest deviation of a from b over b's largest magnitude}
    (dicts of numpy arrays or tuples of them)."""
    errs = {}
    for k in fields:
        xs = a[k] if isinstance(a[k], tuple) else (a[k],)
        ys = b[k] if isinstance(b[k], tuple) else (b[k],)
        errs[k] = max(max_rel_err(torch, torch.as_tensor(u),
                                  torch.as_tensor(v))[1]
                      for u, v in zip(xs, ys))
    return errs


def _field_gate(torch, label, a, b, fields, tol, flow=(), flow_tol=None,
                what="card vs CPU"):
    """Card fields a against CPU fields b (dicts of numpy arrays; `what`
    names the two sides): each field's largest deviation over its largest
    magnitude within tol (flow fields within flow_tol)."""
    errs = _field_devs(torch, a, b, fields + flow)
    print(f"{label}: {what}, largest deviation over largest value "
          + json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()}))
    for k, v in errs.items():
        check(v <= (flow_tol if k in flow else tol), f"{label}: {k} {v:.3e}")
    return errs


def _hs_case():
    from deepflame_torch.runtime import config as C
    return C.CaseConfig(
        chemistry=C.ChemistryProperties(mechanism_file=MECH, ode_rtol=1e-4,
                                        ode_atol=1e-8),
        schemes=C.Schemes(flux_scheme="HLLC", limiter="vanLeer", rk_order=2),
        dtype="float32")


def _hs_submit(pool) -> dict:
    """Submit phase_hs's gate runs: cj_speed, the 64 x 8 detonation and
    the Sod runs, card and CPU sides."""
    runs = {"cj": pool.submit(_cj)}
    runs.update({("det", dev): pool.submit(_hs_detonation, dev)
                 for dev in ("cuda", "cpu")})
    runs.update({("sod", run, dev): pool.submit(_hs_sod, dev, *run)
                 for run in SOD_RUNS for dev in ("cuda", "cpu")})
    return runs


def phase_hs(torch, K, runs=None):
    """The density-based solver. First, side by side in worker processes
    (card and CPU sides, all host-bound): the 2D detonation at 64 x 8 in
    float64 (igniters over the lower half so that cells burn), 2 steps,
    card against CPU within 1e-8; the Sod tube (air.yaml, 400 cells) per
    flux scheme and with WENO5 in float64, card against CPU within 1e-8 and
    the plateau within 3 % of the exact p* and u*; cj_speed on the card.
    Then, the workers gone, the reference's 2000 x 100 channel in float32
    from factory.build_high_speed_solver through run_case: 1 warm-up and
    HS_STEPS timed steps (launch counts set to 0 just before, read just
    after); the chemistry split timed in one more step; one split with
    every cell active (the case's composition at 1500 K and 20 atm, a
    labelled measurement). `runs`: those _hs_submit gave (done), else
    submitted here. Returns (launch counts of the timed steps, ms/step)."""
    if runs is None:
        with _pool(7) as pool:
            runs = _hs_submit(pool)
    t0 = time.perf_counter()
    (card, diag), (ref, _) = (runs["det", "cuda"].result(),
                              runs["det", "cpu"].result())
    _field_gate(torch, "hs detonation 64 x 8 float64, 2 steps", card, ref,
                HS_FIELDS, 1e-8)
    check(diag["chem_lanes"] > 0, "hs: no cell burned at 64 x 8")
    print(f"hs detonation gate: {diag['chem_lanes']} active lanes, "
          f"{diag['chem_trips']} trips in the last step; "
          f"{time.perf_counter() - t0:.1f} s waited")
    for run in SOD_RUNS:
        (card, star), (ref, _) = (runs["sod", run, "cuda"].result(),
                                  runs["sod", run, "cpu"].result())
        _field_gate(torch, "hs Sod {}/{}".format(*run), card, ref,
                    HS_FIELDS, 1e-8)
        print("hs Sod {}/{}: ".format(*run) + star["line"])
        check(star["ok"], "hs Sod {}/{}: star state off by more than 3 "
                          "%".format(*run))
    D, T_cj, p_cj, line = runs["cj"].result()
    print(line)
    check(1500.0 < D < 2500.0 and 2000.0 < T_cj < 3500.0,
          f"hs: cj_speed out of range ({D}, {T_cj})")
    return _hs_path(torch, K)



def _hs_detonation(dev: str):
    """The 64 x 8 float64 detonation after 2 steps on `dev` (a worker):
    (fields as numpy, {active lanes, trips of the last step})."""
    torch = _worker_torch()
    from deepflame_torch.cases import detonation_2d_h2, detonation_dt
    solver, s = detonation_2d_h2(MECH, nx=64, ny=8, dtype=torch.float64,
                                 device=dev, igniters=((0.0, 0.05),))
    for _ in range(2):
        s, diag = solver.step(s, detonation_dt(solver))
    return _as_numpy(s, HS_FIELDS), dict(chem_lanes=diag["chem_lanes"],
                                         chem_trips=int(diag["chem_trips"]))


def _hs_sod(dev: str, flux: str, lim: str):
    """The Sod tube (400 cells, float64) run to its end on `dev` (a
    worker): (fields as numpy, the plateau's p and u against the exact star
    state: {"ok": within 3 %, "line": what to print})."""
    torch = _worker_torch()
    from deepflame_torch.cases import sod_shock_tube
    t0 = time.perf_counter()
    solver, s, plan = sod_shock_tube(AIR, n=400, flux=flux, limiter=lim,
                                     device=dev)
    for _ in range(plan["n_steps"]):
        s, _ = solver.step(s, plan["dt"])
    rho, U, p, T, _ = solver.primitives(s)
    X = solver.mesh.cell_centers(torch.float64)[0].squeeze()
    m = (X > plan["window"][0]) & (X < plan["window"][1])
    ps = float(p.squeeze()[m].mean())
    us = float(U[0].squeeze()[m].mean())
    star = dict(
        ok=(abs(ps - plan["p_star"]) < 0.03 * plan["p_star"]
            and abs(us - plan["u_star"]) < 0.03 * plan["u_star"]),
        line=(f"{plan['n_steps']} steps, p* {ps:.1f} Pa (exact "
              f"{plan['p_star']:.1f}), u* {us:.3f} m/s (exact "
              f"{plan['u_star']:.3f}), {time.perf_counter() - t0:.1f} s on "
              f"{dev}"))
    return _as_numpy(s, HS_FIELDS), star


def _hs_path(torch, K):
    """The reference's 2000 x 100 channel (see phase_hs)."""
    from deepflame_torch.cases import detonation_2d_h2, detonation_dt
    from deepflame_torch.runtime.config import ControlDict
    from deepflame_torch.runtime.driver import run_case
    from deepflame_torch.solvers.high_speed import HighSpeedSolver
    t0 = time.perf_counter()
    solver, state = detonation_2d_h2(MECH, nx=HS_NX, ny=HS_NY,
                                     dtype=torch.float32, device="cuda",
                                     case=_hs_case())
    torch.cuda.synchronize()
    Y_case = state.rhoY / state.rho
    dt = detonation_dt(solver)
    n_cells = state.T.numel()
    print(f"hs path: {HS_NX} x {HS_NY} float32 detonation channel from "
          f"factory.build_high_speed_solver ({solver.config.flux}, RK"
          f"{solver.config.rk_order}, {solver.config.limiter}, rtol "
          f"{solver.config.ode_opts.rtol:g}, atol "
          f"{solver.config.ode_opts.atol:g}), dt {dt:.6e} s, "
          f"{int((state.T > 500.0).sum())} hot cells, built in "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    state = run_case(solver, state, ControlDict(end_time=dt, delta_t=dt,
                                                write_interval=1.0),
                     log_every=1)
    torch.cuda.synchronize()
    print(f"hs warm-up: 1 step in {time.perf_counter() - t0:.2f} s")
    rec = _Recorder(solver)
    T_before = state.T.clone()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    state = run_case(rec, state._replace(time=torch.zeros_like(state.time)),
                     ControlDict(end_time=HS_STEPS * dt, delta_t=dt,
                                 write_interval=1.0), log_every=HS_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launches)
    ms = wall / HS_STEPS * 1e3
    check(len(rec.diags) == HS_STEPS, f"hs: run_case took {len(rec.diags)} "
                                      f"steps, not {HS_STEPS}")
    lanes = [d["chem_lanes"] for d in rec.diags]
    need = [int(d["chem_trips"]) for d in rec.diags]
    print(f"hs path counts over {HS_STEPS} steps: {json.dumps(counts)}; per "
          f"step " + json.dumps({k: v / HS_STEPS for k, v in counts.items()}))
    print(f"hs path: {ms:.2f} ms/step through run_case, "
          f"{n_cells / (wall / HS_STEPS):.4e} cell-updates/s ({n_cells} "
          f"cells), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"hs chemistry: active lanes per step {lanes}; gj_inverse trips "
          f"run {counts['gj_inverse']} in {HS_STEPS} steps, needed "
          f"{sum(need)} (per step {need})")
    rho, U, p, T, _ = solver.primitives(state)
    ix = int(p.amax(dim=(1, 2)).argmax())
    x_pmax = solver.mesh.x0 + (ix + 0.5) * solver.mesh.dx
    print(f"hs state: T_max {float(T.max()):.2f} K, p_max "
          f"{float(p.max()):.6e} Pa at x = {x_pmax * 1e3:.2f} mm, u_max "
          f"{float(rec.diags[-1]['u_max']):.2f} m/s")
    check(counts["gj_inverse"] > 0, f"hs: gj_inverse was not launched: "
                                    f"{counts}")
    check(bool(torch.isfinite(state.rhoE).all() and torch.isfinite(T).all()),
          "hs: non-finite state")
    check(float((state.T - T_before).abs().max()) > 0.0, "hs: T did not change")
    check(float(p.min()) > 0 and float(rho.min()) > 0, "hs: p or rho <= 0")
    check(float((state.rhoY.sum(0) - state.rho).abs().max())
          <= 1e-4 * float(state.rho.max()), "hs: rhoY does not sum to rho")

    total, spent = _timed_inside(torch, HighSpeedSolver, "_chemistry_split",
                                 lambda: solver.step(state, dt))
    print(f"hs breakdown step: {total * 1e3:.2f} ms, of which the chemistry "
          f"split {spent[0] * 1e3:.2f} ms ({spent[0] / total:.3f})")

    # a labelled measurement: the split with every cell active
    full = solver.initial_state(torch.full_like(state.T, 20 * 101325.0),
                                torch.full_like(state.T, 1500.0), Y_case)
    stats = {}
    n0 = K.launches["gj_inverse"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver._chemistry_split(full, dt, stats)
    torch.cuda.synchronize()
    print(f"hs split, every cell active (labelled, not the path; 1500 K, 20 "
          f"atm, the case's composition): {stats['chem_lanes']} lanes, "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms, gj_inverse trips run "
          f"{K.launches['gj_inverse'] - n0}, needed {int(stats['chem_trips'])}")
    check(stats["chem_lanes"] == n_cells, "hs: not every lane was active")
    return counts, ms


def _cj():
    """cj_speed on the card (a worker) for the test mechanism:
    stoichiometric H2-air at 1 atm and 300 K (the reference's 1D
    detonation), three Hugoniot points with the test's options (its
    default options take some 3,000 trips a relaxation and more, at about
    60 ms a trip). Returns (D, T, p, the line to print)."""
    import numpy as np
    _worker_torch()
    import deepflame_torch.chemistry as tc
    from deepflame_torch.chemistry.integrator import RosenbrockOptions
    from deepflame_torch.utils.cj import cj_speed
    mech = tc.load_mechanism(MECH, device="cuda")
    Y0 = np.zeros(mech.n_species)
    iH2, iO2, iN2, iH2O = (mech.species_index(s)
                           for s in ("H2", "O2", "N2", "H2O"))
    Y0[iH2], Y0[iO2], Y0[iN2] = 0.02851, 0.226, 0.745
    Y0 /= Y0.sum()
    Yb = Y0.copy()
    wO2 = Y0[iH2] / 2.016 * 0.5 * 31.998
    Yb[iH2O] = Y0[iH2] + wO2
    Yb[iO2] -= wO2
    Yb[iH2] = 0.0
    args = dict(x_range=(0.52, 0.60), n_x=3, relax_time=3e-6,
                opts=RosenbrockOptions(rtol=1e-4, atol=1e-8, max_steps=20000))
    t0 = time.perf_counter()
    D, T_cj, p_cj = cj_speed(tc.make_thermo(mech), tc.make_kinetics(mech),
                             Y0, Yb, 101325.0, 300.0, **args)
    shown = dict(args, opts=args["opts"]._asdict())
    return D, T_cj, p_cj, (
        f"hs cj_speed ({json.dumps(shown)}): D_CJ {D:.4f} m/s, T_CJ "
        f"{T_cj:.2f} K, p_CJ {p_cj:.6e} Pa, {time.perf_counter() - t0:.2f} "
        f"s wall on the card, under contention: in a worker beside the six "
        f"gate workers (no anchor: H2_Li is not in the repository)")


def _seeded_deep_fgm(device, dtype):
    """A DeepFGM of seeded weights (hidden 64, 64, 32) whose outputs stay
    near a burnt manifold's (T about 1200 K)."""
    import numpy as np
    from deepflame_torch.convert import deep_fgm_from_numpy
    rng = np.random.default_rng(2)
    sizes = (4, 64, 64, 32, 8)
    params = [(rng.normal(0, (2.0 / sizes[i]) ** 0.5, (sizes[i], sizes[i + 1])),
               rng.normal(0, 0.1, sizes[i + 1])) for i in range(4)]
    norm = (np.array([0.3, 0.5, 0.1, 0.1]), np.array([0.3, 0.3, 0.1, 0.1]),
            np.array([50.0, 5.0, 1.0, 1500.0, 25.0, -1e4, 1200.0, 5e-5]),
            np.array([5.0, 0.5, 0.1, 10.0, 0.2, 1e3, 20.0, 1e-6]))
    return deep_fgm_from_numpy(params, *norm, dtype=dtype, device=device)


def _fgm_gate_case(dev: str, deep: bool):
    """The Sandia D jet at the example's 96 x 48 in float64 after 2 steps of
    4e-6 s on `dev` (a worker), with the table or a seeded DeepFGM: its
    fields as numpy."""
    torch = _worker_torch()
    from deepflame_torch.cases import sandia_d_fgm_2d
    net = _seeded_deep_fgm(dev, torch.float64) if deep else None
    solver, s = sandia_d_fgm_2d(FGM_TABLE, nx=96, ny=48, dtype=torch.float64,
                                device=dev, deepfgm=net)
    for _ in range(2):
        s, _ = solver.step(s, 4e-6)
    return _as_numpy(s, FGM_FIELDS + ("U", "phi"))


def _fgm_submit(pool) -> dict:
    """Submit phase_fgm's gate runs, card and CPU sides."""
    return {(deep, dev): pool.submit(_fgm_gate_case, dev, deep)
            for deep in (False, True) for dev in ("cuda", "cpu")}


def phase_fgm(torch, K, runs=None):
    """The flareFGM solver. Gates first, in worker processes: the Sandia D
    jet at the example's 96 x 48 in float64, 2 steps, card against CPU,
    with the table and with a seeded DeepFGM (fields within 1e-8, velocity
    and fluxes 1e-6); the
    native and the Python parser's seconds on the 4.3 MB nc41 table. Then
    FGM_NX x FGM_NY in float32 on the Sandia D table, 1 warm-up and
    FGM_STEPS timed steps of FGM_DT (launch counts set to 0 just before,
    read just after). `runs`: those _fgm_submit gave (done), else
    submitted here. Returns (launch counts of the timed steps, ms/step)."""
    from deepflame_torch.cases import sandia_d_fgm_2d
    from deepflame_torch.combustion.fgm import read_flare_table
    t0 = time.perf_counter()
    if runs is None:
        with _pool(4) as pool:
            runs = _fgm_submit(pool)
    for deep in (False, True):
        label = "DeepFGM" if deep else "table"
        _field_gate(torch, f"fgm 96 x 48 float64 {label}, 2 steps",
                    runs[deep, "cuda"].result(),
                    runs[deep, "cpu"].result(), FGM_FIELDS, 1e-8,
                    ("U", "phi"), 1e-6)
    print(f"fgm gates: {time.perf_counter() - t0:.1f} s")
    secs = {}
    for native in (True, False):
        t0 = time.perf_counter()
        tb = read_flare_table(FGM_TABLE_NC41, dtype=torch.float32,
                              use_native=native, device="cuda")
        torch.cuda.synchronize()
        secs["native" if native else "python"] = time.perf_counter() - t0
    print(f"fgm parsers on {os.path.basename(FGM_TABLE_NC41)} "
          f"({os.path.getsize(FGM_TABLE_NC41)} bytes, shape {tb.shape}): "
          f"native {secs['native']:.3f} s (g++ build included), Python "
          f"{secs['python']:.3f} s")

    t0 = time.perf_counter()
    solver, state = sandia_d_fgm_2d(FGM_TABLE, nx=FGM_NX, ny=FGM_NY,
                                    dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    n_cells = state.T.numel()
    print(f"fgm path: Sandia D jet {FGM_NX} x {FGM_NY} float32 on "
          f"{os.path.basename(FGM_TABLE)}, dt {FGM_DT:g} s, built in "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    state, diag = solver.step(state, FGM_DT)
    torch.cuda.synchronize()
    print(f"fgm warm-up step: {time.perf_counter() - t0:.3f} s")
    T_before = state.T.clone()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    iters = []
    t0 = time.perf_counter()
    for _ in range(FGM_STEPS):
        state, diag = solver.step(state, FGM_DT)
        iters.append(diag)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launches)
    ms = wall / FGM_STEPS * 1e3
    print(f"fgm path counts over {FGM_STEPS} steps: {json.dumps(counts)}; "
          f"per step " + json.dumps({k: v / FGM_STEPS
                                     for k, v in counts.items()}))
    print(f"fgm path: {ms:.2f} ms/step, "
          f"{n_cells / (wall / FGM_STEPS):.4e} cell-updates/s ({n_cells} "
          f"cells), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    keys = [k for k in iters[0] if k.startswith("iters_")]
    print("fgm solver iterations per timed step: " + json.dumps(
        {k: [int(d[k]) for d in iters] for k in keys}))
    from deepflame_torch.solvers.fgm import FGMSolver
    total, spent = _timed_inside(torch, FGMSolver, "_lookup_state",
                                 lambda: solver.step(state, FGM_DT))
    print(f"fgm breakdown step: {total * 1e3:.2f} ms, of which {len(spent)} "
          f"table lookups of the state {sum(spent) * 1e3:.2f} ms "
          f"({sum(spent) / total:.3f})")
    print(f"fgm state: T_max {float(state.T.max()):.2f} K, c_max "
          f"{float(state.c.max()):.4f}, Z_max {float(state.Z.max()):.4f}")
    check(counts["stencil7_apply"] > 0 and counts["helmholtz7_apply"] > 0,
          f"fgm: a kernel of the path was not launched: {counts}")
    check(bool(torch.isfinite(state.T).all() and torch.isfinite(state.p).all()),
          "fgm: non-finite T or p")
    check(float((state.T - T_before).abs().max()) > 0.0, "fgm: T did not change")
    check(0.0 <= float(state.c.min()) and float(state.c.max()) <= 1.0,
          "fgm: c out of [0, 1]")
    return counts, ms


# ------------------------------------------- RAS and the Lagrangian spray

MIST_N, MIST_PARCELS, MIST_NP = 700, 80_000, 275.0   # its manualInjection
SPRAY_STEPS = 2
SPRAY_FIELDS = ("rho", "U", "p", "ha", "Y", "T", "turb")
PARCEL_FIELDS = ("pos", "vel", "d", "T")
MIST_FIELDS = ("rho", "rhoU", "rhoE", "rhoY", "T")


def _recording_draws(log: list):
    """Route the cloud's draws through a recorder: each draw is kept (as
    numpy) in `log`, in order."""
    from deepflame_torch.lagrangian import cloud as C
    orig = C.draw

    def draw(generator, dist, shape, dtype, low=0.0, high=1.0):
        out = orig(generator, dist, shape, dtype, low, high)
        log.append((dist, out.cpu().numpy()))
        return out
    C.draw = draw


def _replaying_draws(torch, log: list):
    """Route the cloud's draws through a replay of `log` (what
    _recording_draws kept), checking each draw's kind and shape."""
    from deepflame_torch.lagrangian import cloud as C

    def draw(generator, dist, shape, dtype, low=0.0, high=1.0):
        want, arr = log.pop(0)
        check(want == dist and arr.shape == tuple(shape),
              f"replayed draw {want} {arr.shape} asked as {dist} {shape}")
        return torch.as_tensor(arr, dtype=dtype, device=generator.device)
    C.draw = draw


def _spray_gate_case(dev: str, draws=None):
    """The aachenBomb chamber at 11 x 20 x 11 in float64 after 2 steps on
    `dev` (a worker). On the card the cloud's draws are recorded; on the
    CPU `draws` (the card's) are replayed. Returns (gas fields, parcel
    fields, the draws recorded, active parcels)."""
    torch = _worker_torch()
    from deepflame_torch.cases import AACHEN_DT, aachen_bomb_3d
    log = []
    if draws is None:
        _recording_draws(log)
    else:
        _replaying_draws(torch, list(draws))
    solver, s = aachen_bomb_3d(MECH, n_xz=11, n_y=20, dtype=torch.float64,
                               device=dev)
    for _ in range(2):
        s, diag = solver.step(s, AACHEN_DT)
    return (_as_numpy(s.gas, SPRAY_FIELDS), _as_numpy(s.cloud, PARCEL_FIELDS),
            log, int(diag["cloud_n_active"]))


def _ras_gate_case(dev: str):
    """tests/test_wall_functions.py's channel (air.yaml, 4 x 16 x 1, a wall
    at y = 0) with KOmegaSST and WallFunctions in float64, 2 steps of 2e-5
    s on `dev` (a worker): its fields as numpy."""
    torch = _worker_torch()
    import deepflame_torch.chemistry as tc
    from deepflame_torch.combustion import NoCombustion
    from deepflame_torch.mesh import (StructuredMesh, cyclic, empty,
                                      fixed_value, zero_gradient)
    from deepflame_torch.solvers import LowMachConfig, LowMachSolver
    from deepflame_torch.turbulence import (KOmegaSST, WallFunctions,
                                            wall_distance)
    mech = tc.load_mechanism(AIR, device=dev)
    th = tc.make_thermo(mech)
    mesh = StructuredMesh.box([0.1, 0.02, 0.02], [4, 16, 1], device=dev)
    e = (empty(), empty())
    bU = ((cyclic(), cyclic()), (fixed_value(0.0), zero_gradient()), e)
    bS = ((cyclic(), cyclic()), (zero_gradient(), zero_gradient()), e)
    model = KOmegaSST(y=wall_distance(mesh, [(1, 0)]),
                      wall_fns=WallFunctions.for_walls(mesh, [(1, 0)],
                                                       dtype=torch.float64))
    solver = LowMachSolver(
        mesh=mesh, thermo=th, transport=tc.make_transport(mech),
        combustion=NoCombustion(th, tc.make_kinetics(mech)),
        bcs_U=(bU, bU, bU), bcs_p=bS, bcs_h=bS, bcs_Y=bS, bcs_rho=bS,
        config=LowMachConfig(chemistry=False), turbulence=model)
    _, Yg, _ = mesh.cell_centers()
    U = torch.stack([15.0 * torch.sqrt(Yg / 0.02), torch.zeros_like(Yg),
                     torch.zeros_like(Yg)])
    full = lambda v: torch.full(mesh.shape, v, dtype=torch.float64,
                                device=dev)
    s = solver.initial_state(full(101325.0), full(300.0),
                             torch.ones((1,) + mesh.shape, device=dev), U,
                             k0=0.1, eps0=1.0)
    for _ in range(2):
        s, _ = solver.step(s, 2e-5)
    return _as_numpy(s, SPRAY_FIELDS)


def _mist_gate_case(dev: str):
    """The water-mist tube at 64 cells with 400 parcels in float64, the
    mist released in the first step, 2 steps on `dev` (a worker): the
    fields and parcels as numpy, and the chemistry lanes of the last step."""
    torch = _worker_torch()
    from deepflame_torch.cases import detonation_dt, watermist_detonation_1d
    solver, s = watermist_detonation_1d(MECH, n=64, n_parcels=400, soi=1e-9,
                                        dtype=torch.float64, device=dev)
    dt = detonation_dt(solver.gas_solver, a_bound=3500.0)
    for _ in range(2):
        s, diag = solver.step(s, dt)
    return (_as_numpy(s.gas, MIST_FIELDS), _as_numpy(s.cloud, PARCEL_FIELDS),
            int(diag["chem_lanes"]))


def spray_gates(torch, card=None):
    """The card-against-CPU gates of the spray and mist phases, side by side
    in worker processes (all host-bound), before anything is timed: the
    aachenBomb at 11 x 20 x 11 (the CPU replays the card's draws; gas
    fields within 1e-8 of their largest value, parcel position, velocity,
    diameter and temperature within 1e-8), the RAS channel (KOmegaSST with
    wall functions, 1e-8) and the mist tube (1e-8). `card`: the future of
    the aachenBomb's card side submitted in an earlier window of workers
    (_spray_gate_case on "cuda"), else submitted here."""
    t0 = time.perf_counter()
    with _pool(5) as pool:
        if card is None:
            card = pool.submit(_spray_gate_case, "cuda")
        ras = {d: pool.submit(_ras_gate_case, d) for d in ("cuda", "cpu")}
        mist = {d: pool.submit(_mist_gate_case, d) for d in ("cuda", "cpu")}
        g_card, p_card, draws, n_act = card.result()
        cpu = pool.submit(_spray_gate_case, "cpu", draws)
        _field_gate(torch, "spray RAS channel KOmegaSST + wall functions "
                    "float64, 2 steps", ras["cuda"].result(),
                    ras["cpu"].result(), SPRAY_FIELDS, 1e-8)
        (mg_card, mp_card, lanes), (mg_cpu, mp_cpu, _) = (
            mist["cuda"].result(), mist["cpu"].result())
        _field_gate(torch, "mist 64 cells, 400 parcels, float64, 2 steps",
                    mg_card, mg_cpu, MIST_FIELDS, 1e-8)
        _field_gate(torch, "mist parcels", mp_card, mp_cpu, PARCEL_FIELDS,
                    1e-8)
        g_cpu, p_cpu, _, n_cpu = cpu.result()
        _field_gate(torch, "spray aachenBomb 11 x 20 x 11 float64, 2 steps "
                    f"({len(draws)} draws replayed on the CPU)", g_card,
                    g_cpu, SPRAY_FIELDS, 1e-8)
        _field_gate(torch, "spray parcels", p_card, p_cpu, PARCEL_FIELDS,
                    1e-8)
        check(n_act == n_cpu > 0, f"spray gate: {n_act} parcels on the card, "
                                  f"{n_cpu} on the CPU")
        check(lanes > 0, "mist gate: no chemistry lane above 500 K")
    print(f"spray and mist gates: {time.perf_counter() - t0:.1f} s "
          f"({n_act} parcels in the chamber, {lanes} chemistry lanes in "
          "the tube)")


def _timed_steps(torch, K, solver, state, dt, steps):
    """`steps` timed steps (launch counts set to 0 just before, read just
    after): (state, diag of the last step, counts, wall seconds)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, diag = solver.step(state, dt)
    torch.cuda.synchronize()
    return state, diag, dict(K.launches), time.perf_counter() - t0


def phase_spray(torch, K):
    """The aachenBomb through SpraySolver at the reference's 41 x 100 x 41
    in float32 (kEpsilon RAS, Laminar chemistry, water spray): 2 warm-up
    and SPRAY_STEPS timed steps; the stencil and Helmholtz kernels must
    launch. Then one step with the cloud's evolve, the RAS advance and the
    chemistry timed inside it; one evolve with all 32,768 slots active and
    one chemistry solve with every cell in the drain's bins (labelled
    measurements, not the path; phase_kernels holds the kernels at the
    chamber's shapes). Returns (launch counts of the timed steps,
    ms/step)."""
    from deepflame_torch.cases import AACHEN_DT, aachen_bomb_3d
    from deepflame_torch.chemistry.reactor import solve_chemistry
    from deepflame_torch.combustion import Laminar
    from deepflame_torch.lagrangian.cloud import SprayCloud
    from deepflame_torch.turbulence import KEpsilon
    t0 = time.perf_counter()
    solver, state = aachen_bomb_3d(MECH, n_xz=AACHEN_NXZ, n_y=AACHEN_NY,
                                   dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    gas, cloud = solver.gas_solver, solver.cloud
    n_cells = state.gas.T.numel()
    print(f"spray path: aachenBomb {AACHEN_NXZ} x {AACHEN_NY} x {AACHEN_NXZ} "
          f"float32, water into the test mechanism's air, kEpsilon, "
          f"{gas.combustion.n_bins} chemistry bins, dt {AACHEN_DT:g} s, "
          f"{cloud.max_parcels} parcel slots, built in "
          f"{time.perf_counter() - t0:.2f} s")
    for i in range(2):
        t0 = time.perf_counter()
        state, diag = solver.step(state, AACHEN_DT)
        torch.cuda.synchronize()
        print(f"spray warm-up step {i + 1}: {time.perf_counter() - t0:.3f} s")
    T_before = state.gas.T.clone()
    state, diag, counts, wall = _timed_steps(torch, K, solver, state,
                                             AACHEN_DT, SPRAY_STEPS)
    ms = wall / SPRAY_STEPS * 1e3
    print(f"spray path counts over {SPRAY_STEPS} steps: {json.dumps(counts)}; "
          f"per step " + json.dumps({k: v / SPRAY_STEPS
                                     for k, v in counts.items()}))
    print(f"spray path: {ms:.2f} ms/step, "
          f"{n_cells / (wall / SPRAY_STEPS):.4e} cell-updates/s ({n_cells} "
          f"cells), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    g, c = state.gas, state.cloud
    act = c.active > 0
    n_act = int(act.sum())
    tip = float(c.pos[1][act].min()) if n_act else float("nan")
    iv = solver.fuel_index
    print(f"spray state: {n_act} active parcels, k_max "
          f"{float(diag['k_max']):.6f}, T_min {float(g.T.min()):.3f} K, "
          f"max Y_H2O {float(g.Y[iv].max()):.6e}, liquid tip at y = "
          f"{tip * 1e3:.3f} mm (penetration {(0.0995 - tip) * 1e3:.3f} mm "
          f"below the injector), liquid mass "
          f"{float(diag['cloud_liquid_mass']):.6e} kg, injected "
          f"{float(c.m_injected):.6e} kg")
    print("spray solver iterations of the last step: " + json.dumps(
        {k: int(v) for k, v in diag.items() if k.startswith("iters_")}))
    check(counts["stencil7_apply"] > 0 and counts["helmholtz7_apply"] > 0,
          f"spray: a kernel of the path was not launched: {counts}")
    check(bool(torch.isfinite(g.T).all() and torch.isfinite(g.p).all()
               and all(torch.isfinite(t).all() for t in g.turb)),
          "spray: non-finite gas state")
    check(float((g.T - T_before).abs().max()) > 0.0, "spray: T did not change")
    check(n_act > 0 and float(g.Y[iv].max()) > 0.0,
          "spray: no parcels, or no vapour in the gas")
    check(float(g.turb[0].min()) > 0.0 and float(g.turb[1].min()) > 0.0,
          "spray: k or epsilon not positive")
    check(float((g.Y.sum(0) - 1.0).abs().max()) < 1e-5,
          "spray: mass fractions do not sum to 1")

    total, spent = _timed_many(
        torch, [(SprayCloud, "evolve"), (KEpsilon, "advance"),
                (Laminar, "correct")],
        lambda: solver.step(state, AACHEN_DT))
    spent = {k: sum(v) for k, v in spent.items()}
    print(f"spray breakdown step: {total * 1e3:.2f} ms; cloud evolve "
          f"{spent['evolve'] * 1e3:.2f} ms ({spent['evolve'] / total:.3f}), "
          f"RAS advance {spent['advance'] * 1e3:.2f} ms "
          f"({spent['advance'] / total:.3f}), chemistry "
          f"{spent['correct'] * 1e3:.2f} ms ({spent['correct'] / total:.3f})")

    # a labelled measurement: the cloud's evolve with every slot active
    N = cloud.max_parcels
    gen = torch.Generator(device="cuda").manual_seed(1)
    u = lambda *sh: torch.rand(sh, generator=gen, device="cuda")
    lo = torch.tensor([-0.01, 0.0, -0.01], device="cuda")[:, None]
    ext = torch.tensor([0.02, 0.1, 0.02], device="cuda")[:, None]
    full = c._replace(pos=lo + u(3, N) * ext, vel=(u(3, N) - 0.5) * 100.0,
                      d=5e-6 + u(N) * 1e-4, T=320.0 + u(N) * 20.0,
                      n_part=1.0 + u(N) * 100.0,
                      active=torch.ones(N, device="cuda"))
    fields = dict(rho=g.rho, U=g.U, T=g.T, mu=torch.full_like(g.T, 3.5e-5),
                  p=g.p, Yv=g.Y[iv])
    cloud.evolve(full, fields, AACHEN_DT, g.time)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        out, _ = cloud.evolve(full, fields, AACHEN_DT, g.time)
    torch.cuda.synchronize()
    ev_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"spray cloud evolve with all {N} slots active (labelled, not the "
          f"path): {ev_ms:.3f} ms per call, against "
          f"{spent['evolve'] * 1e3:.3f} ms with {n_act} active in the path")
    check(bool(torch.isfinite(out.d).all()), "spray: full evolve non-finite")

    # a labelled measurement: the chemistry with every cell in the bins
    # (the fast tier off), the drain the path's inert chamber never needs
    Yt = torch.movedim(g.Y, 0, -1)
    n0 = K.launches["gj_inverse"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_chemistry(gas.thermo, gas.combustion.kinetics, g.T, g.p, Yt,
        AACHEN_DT, opts=gas.combustion.ode_opts, T_threshold=280.0,
        n_bins=gas.combustion.n_bins, fast_tier=False,
        sort=gas.combustion.sort)
    torch.cuda.synchronize()
    drain_launches = K.launches["gj_inverse"] - n0
    bin_lanes = -(-n_cells // gas.combustion.n_bins)
    print(f"spray chemistry with every cell in its bins (labelled, not the "
          f"path; fast tier off): {n_cells} lanes in "
          f"{gas.combustion.n_bins} bins of {bin_lanes}, "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms, gj_inverse launches "
          f"{drain_launches}")
    check(bool(torch.isfinite(res.T).all()), "spray: drain non-finite")
    check(bin_lanes == AACHEN_BIN_LANES, f"spray: {bin_lanes} lanes a bin, "
                                         f"phase_kernels timed {AACHEN_BIN_LANES}")
    return counts, ms


def phase_mist(torch, K):
    """The water-mist detonation through HighSpeedSpraySolver: MIST_N cells
    with MIST_PARCELS parcels of MIST_NP droplets in float32, the mist
    released in the first step (soi at half a step); 1 warm-up and
    SPRAY_STEPS timed steps (gj_inverse must launch); one step with the
    cloud's evolve and the chemistry split timed inside it (phase_kernels
    holds gj_inverse at the split's lanes). Returns (launch counts of the
    timed steps, ms/step)."""
    from deepflame_torch.cases import detonation_dt, watermist_detonation_1d
    from deepflame_torch.lagrangian.cloud import SprayCloud
    from deepflame_torch.solvers.high_speed import HighSpeedSolver
    t0 = time.perf_counter()
    dt = 0.3 * (1.4 / MIST_N) / 3500.0
    solver, state = watermist_detonation_1d(
        MECH, n=MIST_N, n_parcels=MIST_PARCELS, n_particle=MIST_NP,
        soi=0.5 * dt, dtype=torch.float32, device="cuda")
    check(abs(detonation_dt(solver.gas_solver, a_bound=3500.0) - dt) < 1e-15,
          "mist: step")
    torch.cuda.synchronize()
    print(f"mist path: {MIST_N}-cell tube float32, {MIST_PARCELS} parcels x "
          f"{MIST_NP:g}, soi {0.5 * dt:.4e} s (inside the first step), dt "
          f"{dt:.6e} s, built in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    state, diag = solver.step(state, dt)
    torch.cuda.synchronize()
    print(f"mist warm-up step: {time.perf_counter() - t0:.3f} s")
    rec = _Recorder(solver)
    state, diag, counts, wall = _timed_steps(torch, K, rec, state, dt,
                                             SPRAY_STEPS)
    ms = wall / SPRAY_STEPS * 1e3
    lanes = [int(d["chem_lanes"]) for d in rec.diags]
    print(f"mist path counts over {SPRAY_STEPS} steps: {json.dumps(counts)}; "
          f"per step " + json.dumps({k: v / SPRAY_STEPS
                                     for k, v in counts.items()}))
    print(f"mist path: {ms:.2f} ms/step, "
          f"{MIST_N / (wall / SPRAY_STEPS):.4e} cell-updates/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; chemistry "
          f"lanes per step {lanes}")
    rho, U, p, T, _ = solver.gas_solver.primitives(state.gas)
    ix = int(p.reshape(-1).argmax())
    n_act = int(state.cloud.active.sum())
    print(f"mist state: {n_act} active parcels, p_max {float(p.max()):.6e} Pa "
          f"at x = {(ix + 0.5) * 1.4 / MIST_N * 1e3:.2f} mm, T_max "
          f"{float(T.max()):.2f} K, injected "
          f"{float(state.cloud.m_injected):.6e} kg")
    check(counts["gj_inverse"] > 0, f"mist: gj_inverse was not launched: "
                                    f"{counts}")
    check(n_act == MIST_PARCELS, f"mist: {n_act} active parcels")
    check(bool(torch.isfinite(state.gas.rhoE).all() and torch.isfinite(T).all()),
          "mist: non-finite state")
    check(float(p.min()) > 0 and float(rho.min()) > 0, "mist: p or rho <= 0")
    total, spent = _timed_many(
        torch, [(SprayCloud, "evolve"), (HighSpeedSolver, "_chemistry_split")],
        lambda: solver.step(state, dt))
    spent = {k: sum(v) for k, v in spent.items()}
    print(f"mist breakdown step: {total * 1e3:.2f} ms; cloud evolve "
          f"{spent['evolve'] * 1e3:.2f} ms ({spent['evolve'] / total:.3f}), "
          f"chemistry split {spent['_chemistry_split'] * 1e3:.2f} ms "
          f"({spent['_chemistry_split'] / total:.3f})")
    check(max(lanes) <= MIST_SPLIT_LANES, f"mist: {max(lanes)} split lanes, "
                                          f"phase_kernels timed "
                                          f"{MIST_SPLIT_LANES}")
    return counts, ms



# ------------------------------------------- the face-list backend's paths

FL_STEPS = 2                 # timed steps of hsfl, fgmfl and sprayfl
FL_FIELDS = ("p", "T", "rho", "ha", "Y")
FGMFL_FIELDS = ("rho", "p", "Z", "Zvar", "c", "cvar", "T", "He", "k", "eps")


def _flat_np(a):
    """A structured field as flat cells, components last (numpy)."""
    if a.ndim == 3:
        return a.reshape(-1)
    return a.reshape(a.shape[0], -1).T


def _flat_fields(d: dict) -> dict:
    return {k: (tuple(_flat_np(x) for x in v) if isinstance(v, tuple)
                else _flat_np(v)) for k, v in d.items()}


def _without_plan(solver):
    """The solver with every FaceListMesh's shift plan taken away (gathers,
    ELL sums and the index-form matvec)."""
    from deepflame_torch.mesh.facelist import FaceListMesh
    nop = lambda m: dataclasses.replace(m, plan=None)
    kw = {}
    for f in dataclasses.fields(solver):
        v = getattr(solver, f.name)
        if isinstance(v, FaceListMesh):
            kw[f.name] = nop(v)
        elif f.name == "m_U":
            kw[f.name] = tuple(nop(m) for m in v)
        elif f.name == "m_Y_groups" and v is not None:
            kw[f.name] = tuple((nop(m), g) for m, g in v)
    return dataclasses.replace(solver, **kw)


def _fljet_gate_case(dev: str, which: str):
    """The jet at n = 8 (16 x 8 x 8 cells) in float64 after 2 steps of
    JET_DT on `dev` (a worker): `which` is "plan" (jet_flame_3d_les_plan),
    "noplan" (the same meshes without their plans) or "sjet" (the
    structured jet_flame_3d_les). Returns (flat fields, pressure
    iterations of the last step)."""
    torch = _worker_torch()
    from deepflame_torch.cases import jet_flame_3d_les, jet_flame_3d_les_plan
    if which == "sjet":
        solver, s = jet_flame_3d_les(MECH, n=8, dtype=torch.float64,
                                     device=dev)
    else:
        solver, s = jet_flame_3d_les_plan(MECH, n=8, dtype=torch.float64,
                                          device=dev)
        if which == "noplan":
            solver = _without_plan(solver)
    for _ in range(2):
        s, diag = solver.step(s, JET_DT)
    out = _as_numpy(s, FL_FIELDS + ("U",))
    return (_flat_fields(out) if which == "sjet" else out,
            int(diag["iters_p"]))


def _fl_timed(torch, K, solver, state, dt, warm, steps, label, n_cells):
    """`warm` warm-up and `steps` timed steps (launch counts set to 0 just
    before, read just after), printed: ms/step, cell-updates/s, peak
    memory, launches per step. Returns (state, diag, counts, ms/step)."""
    for i in range(warm):
        t0 = time.perf_counter()
        state, diag = solver.step(state, dt)
        torch.cuda.synchronize()
        print(f"{label} warm-up step {i + 1}: {time.perf_counter() - t0:.3f} s")
    state, diag, counts, wall = _timed_steps(torch, K, solver, state, dt,
                                             steps)
    ms = wall / steps * 1e3
    print(f"{label} path counts over {steps} steps: {json.dumps(counts)}; "
          f"per step " + json.dumps({k: v / steps for k, v in counts.items()}))
    print(f"{label} path: {ms:.2f} ms/step, "
          f"{n_cells / (wall / steps):.4e} cell-updates/s ({n_cells} cells), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"{label} diagnostics of the last step: " + json.dumps(
        {k: float(v) for k, v in diag.items()}))
    return state, diag, counts, ms


def _fljet_submit(pool) -> dict:
    """Submit phase_fljet's gate runs."""
    return {(dev, w): pool.submit(_fljet_gate_case, dev, w)
            for dev, w in (("cuda", "plan"), ("cpu", "plan"),
                           ("cuda", "noplan"), ("cuda", "sjet"),
                           ("cpu", "sjet"))}


def phase_fljet(torch, K, runs=None):
    """The structured jet on the face-list backend with shift plans
    (deepflame_torch.cases.jet_flame_3d_les_plan). Gates first, in worker
    processes, in float64 at n = 8 (16 x 8 x 8), 2 steps: the plan step on
    the card against the plan step on the CPU and against the same meshes
    without their plans on the card (every field within 1e-8 of its
    largest value, U 1e-6); and its deviation from the structured step
    (jet_flame_3d_les) on the card equal, within 1e-8, to the same
    deviation on the CPU path (the JAX package's two backends disagree as
    much at the jet's inlet profiles, ROADMAP section C). Then 128 x 64 x
    64 in float32, dt 5e-7 s, 1 warm-up and STEPS timed steps: stencil7_apply
    and gj_inverse must launch, ell_matvec must not. Then the AMG setup of
    its pressure mesh, timed, and one step of the timed state with the
    AMG-preconditioned pressure CG beside one with Jacobi: fewer pressure
    iterations, and p, rho and T apart by no more than 2 p_rel_tol of the
    step's change (each CG stops within p_rel_tol of its initial residual).
    Returns (launch counts of the timed steps, ms/step)."""
    from deepflame_torch.cases import jet_flame_3d_les_plan
    from deepflame_torch.ops.amg_fl import make_amg_fl
    t0 = time.perf_counter()
    if runs is None:
        with _pool(5) as pool:
            runs = _fljet_submit(pool)
    r = {k: v.result()[0] for k, v in runs.items()}
    _field_gate(torch, "fljet n=8 float64, plan on the card vs the CPU",
                r["cuda", "plan"], r["cpu", "plan"], FL_FIELDS, 1e-8,
                ("U",), 1e-6)
    _field_gate(torch, "fljet n=8 float64 on the card, plan vs no plan",
                r["cuda", "plan"], r["cuda", "noplan"], FL_FIELDS, 1e-8,
                ("U",), 1e-6)
    devs = {}
    for dev in ("cuda", "cpu"):
        devs[dev] = {k: max_rel_err(torch, torch.as_tensor(r[dev, "sjet"][k]),
                                    torch.as_tensor(r[dev, "plan"][k]))[1]
                     for k in FL_FIELDS + ("U",)}
    print("fljet n=8 float64, plan vs structured jet (largest deviation over "
          "largest value): card " + json.dumps(devs["cuda"]) + ", CPU "
          + json.dumps(devs["cpu"]))
    for k in devs["cuda"]:
        check(abs(devs["cuda"][k] - devs["cpu"][k]) <= 1e-8,
              f"fljet: plan vs structured {k} differs on the card from the "
              f"CPU path")
    print(f"fljet gates: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    solver, state = jet_flame_3d_les_plan(MECH, n=N_JET, dtype=torch.float32,
                                          device="cuda")
    torch.cuda.synchronize()
    n_cells = state.T.numel()
    print(f"fljet path: {2 * N_JET} x {N_JET} x {N_JET} float32 jet on "
          f"from_structured meshes (shift plan {solver.m_p.plan.shape}, "
          f"{solver.m_p.n_faces} interior faces, "
          f"{len(solver.m_Y_groups)} species BC groups, "
          f"{solver.combustion.n_bins} chemistry bins, dt {JET_DT:g} s), "
          f"built in {time.perf_counter() - t0:.2f} s")
    T_before = state.T.clone()
    state, diag, counts, ms = _fl_timed(torch, K, solver, state, JET_DT, 1,
                                        STEPS, "fljet", n_cells)
    check(counts["stencil7_apply"] > 0 and counts["gj_inverse"] > 0
          and counts["ell_matvec"] == 0,
          f"fljet: launches {counts} (stencil7_apply and gj_inverse must "
          f"launch, ell_matvec must not)")
    check(bool(torch.isfinite(state.T).all() and torch.isfinite(state.p).all()),
          "fljet: non-finite T or p")
    check(float((state.T - T_before).abs().max()) > 0.0, "fljet: T did not change")
    check(float((state.Y.sum(1) - 1.0).abs().max()) < 1e-5,
          "fljet: mass fractions do not sum to 1")
    _breakdown_step(torch, solver, state, "fljet")

    t0 = time.perf_counter()
    amg = make_amg_fl(solver.m_p)
    setup = time.perf_counter() - t0
    print(f"fljet AMG setup at {n_cells} cells: {setup:.2f} s on the host, "
          f"{len(amg.levels)} levels down to {amg.n_coarsest} cells")
    out = {}
    for label, sol in (("jacobi", solver),
                       ("amg", dataclasses.replace(solver, p_mg=amg))):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s1, d1 = sol.step(state, JET_DT)
        torch.cuda.synchronize()
        out[label] = (s1, int(d1["iters_p"]), time.perf_counter() - t1)
    print(f"fljet one step from the timed state: Jacobi {out['jacobi'][1]} "
          f"pressure iterations, {out['jacobi'][2] * 1e3:.2f} ms; AMG "
          f"{out['amg'][1]}, {out['amg'][2] * 1e3:.2f} ms")
    check(out["amg"][1] < out["jacobi"][1],
          "fljet: AMG took no fewer pressure iterations than Jacobi")
    # both CGs stop within p_rel_tol of the step's initial residual, so
    # their p and rho may differ by up to that share of the step's change
    tol = 2.0 * solver.config.p_rel_tol
    for k in ("p", "rho", "T"):
        a, b = getattr(out["amg"][0], k), getattr(out["jacobi"][0], k)
        change = float((b - getattr(state, k)).abs().max())
        dev = float((a - b).abs().max())
        print(f"fljet AMG vs Jacobi {k}: largest deviation {dev:.3e} against "
              f"the step's largest change {change:.3e} (bound "
              f"{tol:g} of it)")
        check(dev <= tol * change, f"fljet: AMG vs Jacobi {k} deviation "
                                   f"{dev:.3e} > {tol:g} x {change:.3e}")
    return counts, ms


def _hsfl_gate_case(dev: str, which: str):
    """The face-list detonation ("fl") or the structured one ("sjet") at
    64 x 8 in float64 (igniters over the lower half), 2 steps on `dev` (a
    worker): (flat fields, active lanes of the last step)."""
    torch = _worker_torch()
    from deepflame_torch.cases import (detonation_2d_h2, detonation_2d_h2_fl,
                                       detonation_dt)
    build = detonation_2d_h2_fl if which == "fl" else detonation_2d_h2
    solver, s = build(MECH, nx=64, ny=8, dtype=torch.float64, device=dev,
                      igniters=((0.0, 0.05),))
    for _ in range(2):
        s, diag = solver.step(s, detonation_dt(solver))
    out = _as_numpy(s, HS_FIELDS)
    return (out if which == "fl" else _flat_fields(out)), diag["chem_lanes"]


def _hsfl_submit(pool) -> dict:
    """Submit phase_hsfl's gate runs."""
    return {k: pool.submit(_hsfl_gate_case, *k)
            for k in (("cuda", "fl"), ("cpu", "fl"), ("cuda", "sjet"))}


def phase_hsfl(torch, K, runs=None):
    """The 2D detonation channel on the face-list backend
    (deepflame_torch.cases.detonation_2d_h2_fl, shift plan). Gates first,
    in workers: 64 x 8 float64, 2 steps, the card against the CPU within
    1e-8, and against the structured step (detonation_2d_h2) on the card
    within 5e-3 (the JAX package's bound for its two backends, whose
    boundary-adjacent gradient stencils differ). Then 2000 x 100 in float32
    (HLLC, RK2, vanLeer, split chemistry), 1 warm-up and FL_STEPS timed
    steps (gj_inverse must launch); the chemistry split timed inside one
    more step. Returns (launch counts of the timed steps, ms/step)."""
    from deepflame_torch.cases import detonation_2d_h2_fl, detonation_dt
    from deepflame_torch.solvers.high_speed_fl import HighSpeedSolverFL
    t0 = time.perf_counter()
    if runs is None:
        with _pool(3) as pool:
            runs = _hsfl_submit(pool)
    r = {k: v.result() for k, v in runs.items()}
    _field_gate(torch, "hsfl 64 x 8 float64, 2 steps, card vs CPU",
                r["cuda", "fl"][0], r["cpu", "fl"][0], HS_FIELDS, 1e-8)
    _field_gate(torch, "hsfl 64 x 8 float64 on the card, face-list vs "
                "structured", r["cuda", "fl"][0], r["cuda", "sjet"][0],
                HS_FIELDS, 5e-3)
    check(r["cuda", "fl"][1] > 0, "hsfl: no cell burned at 64 x 8")
    print(f"hsfl gates: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    solver, state = detonation_2d_h2_fl(MECH, nx=HS_NX, ny=HS_NY,
                                        dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    dt = detonation_dt(solver)
    n_cells = state.T.numel()
    print(f"hsfl path: {HS_NX} x {HS_NY} float32 detonation channel on "
          f"from_structured meshes ({solver.config.flux}, RK"
          f"{solver.config.rk_order}, {solver.config.limiter}, split "
          f"chemistry), dt {dt:.6e} s, built in "
          f"{time.perf_counter() - t0:.2f} s")
    state, diag, counts, ms = _fl_timed(torch, K, solver, state, dt, 1,
                                        FL_STEPS, "hsfl", n_cells)
    check(counts["gj_inverse"] > 0, f"hsfl: gj_inverse was not launched: "
                                    f"{counts}")
    rho, U, p, T, _ = solver.primitives(state)
    check(bool(torch.isfinite(T).all() and torch.isfinite(p).all()),
          "hsfl: non-finite T or p")
    check(float(T.max()) > 1500.0, "hsfl: the igniters went out")
    total, spent = _timed_inside(torch, HighSpeedSolverFL, "_chemistry_split",
                                 lambda: solver.step(state, dt))
    print(f"hsfl breakdown step: {total * 1e3:.2f} ms, of which the "
          f"chemistry split {spent[0] * 1e3:.2f} ms ({spent[0] / total:.3f})")
    return counts, ms


def _fgmfl_gate_case(dev: str, which: str):
    """The Sandia D jet at 96 x 48 in float64 after 2 steps of 4e-6 s on
    `dev` (a worker): "fl" the face-list form without RAS, "ras" with RNG
    k-epsilon, "sjet" the structured FGMSolver. Flat fields."""
    torch = _worker_torch()
    from deepflame_torch.cases import sandia_d_fgm_2d, sandia_d_fgm_2d_fl
    if which == "sjet":
        solver, s = sandia_d_fgm_2d(FGM_TABLE, nx=96, ny=48,
                                    dtype=torch.float64, device=dev)
    else:
        solver, s = sandia_d_fgm_2d_fl(FGM_TABLE, nx=96, ny=48,
                                       dtype=torch.float64, device=dev,
                                       ras=which == "ras")
    for _ in range(2):
        s, _ = solver.step(s, 4e-6)
    fields = FGM_FIELDS + ("U",) + (("k", "eps") if which == "ras" else ())
    out = _as_numpy(s, fields)
    return _flat_fields(out) if which == "sjet" else out


def _fgmfl_submit(pool) -> dict:
    """Submit phase_fgmfl's gate runs."""
    return {k: pool.submit(_fgmfl_gate_case, *k)
            for k in (("cuda", "fl"), ("cpu", "fl"), ("cuda", "sjet"),
                      ("cuda", "ras"), ("cpu", "ras"))}


def phase_fgmfl(torch, K, runs=None):
    """The Sandia D jet on the face-list backend
    (deepflame_torch.cases.sandia_d_fgm_2d_fl, shift plan). Gates first, in
    workers, 96 x 48 float64, 2 steps: without RAS, the card against the
    CPU and against the structured FGMSolver on the card; with RNG
    k-epsilon, the card against the CPU (every field within 1e-8, U 1e-6).
    Then a DeepFGM distilled on the card from the table by train_deep_fgm
    (its seconds, and Tf's RMS deviation from the table at 20,000 seeded
    points), and FGM_NX x FGM_NY in float32 with RNG k-epsilon and the
    DeepFGM manifold, 1 warm-up and FL_STEPS timed steps (stencil7_apply
    must launch); the manifold reads and the RAS advance timed inside one
    more step. Returns (launch counts of the timed steps, ms/step)."""
    import numpy as np
    from deepflame_torch.cases import sandia_d_fgm_2d_fl
    from deepflame_torch.combustion.fgm import (lookup, read_flare_table,
                                                train_deep_fgm)
    from deepflame_torch.solvers.fgm_fl import FGMSolverFL
    t0 = time.perf_counter()
    if runs is None:
        with _pool(5) as pool:
            runs = _fgmfl_submit(pool)
    r = {k: v.result() for k, v in runs.items()}
    _field_gate(torch, "fgmfl 96 x 48 float64, 2 steps, card vs CPU",
                r["cuda", "fl"], r["cpu", "fl"], FGM_FIELDS, 1e-8, ("U",),
                1e-6)
    _field_gate(torch, "fgmfl 96 x 48 float64 on the card, face-list vs "
                "structured", r["cuda", "fl"], r["cuda", "sjet"], FGM_FIELDS,
                1e-8, ("U",), 1e-6)
    _field_gate(torch, "fgmfl 96 x 48 float64 RNG k-epsilon, card vs CPU",
                r["cuda", "ras"], r["cpu", "ras"], FGM_FIELDS + ("k", "eps"),
                1e-8, ("U",), 1e-6)
    print(f"fgmfl gates: {time.perf_counter() - t0:.1f} s")

    table = read_flare_table(FGM_TABLE, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = train_deep_fgm(table)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    ax = [np.asarray(table.axes[i]) for i in (1, 2, 3, 4)]
    pts = [torch.as_tensor(rng.uniform(a.min(), a.max(), 20000),
                           dtype=torch.float32, device="cuda") for a in ax]
    T_nn = net.query(*pts)["Tf"]
    T_tb = lookup(table, "Tf", (None, *pts, None))
    rms = float(torch.sqrt(((T_nn - T_tb) ** 2).mean()) / T_tb.mean())
    print(f"fgmfl DeepFGM: train_deep_fgm on the card (20,000 samples, 200 "
          f"epochs, hidden 64-64-32) {train_s:.2f} s; Tf RMS deviation from "
          f"the table {rms:.4f} of its mean at 20,000 seeded points")
    check(math.isfinite(rms) and rms < 0.2, f"fgmfl: DeepFGM Tf RMS {rms}")

    t0 = time.perf_counter()
    solver, state = sandia_d_fgm_2d_fl(FGM_TABLE, nx=FGM_NX, ny=FGM_NY,
                                       dtype=torch.float32, device="cuda",
                                       ras=True, deepfgm=net, table=table)
    torch.cuda.synchronize()
    n_cells = state.T.numel()
    print(f"fgmfl path: Sandia D {FGM_NX} x {FGM_NY} float32 on "
          f"from_structured meshes, RNG k-epsilon (C1 {solver.C1}), the "
          f"DeepFGM manifold, dt {FGM_DT:g} s, built in "
          f"{time.perf_counter() - t0:.2f} s")
    T_before = state.T.clone()
    state, diag, counts, ms = _fl_timed(torch, K, solver, state, FGM_DT, 1,
                                        FL_STEPS, "fgmfl", n_cells)
    check(counts["stencil7_apply"] > 0, f"fgmfl: stencil7_apply was not "
                                        f"launched: {counts}")
    check(bool(torch.isfinite(state.T).all() and torch.isfinite(state.p).all()
               and torch.isfinite(state.k).all()), "fgmfl: non-finite state")
    check(float((state.T - T_before).abs().max()) > 0.0,
          "fgmfl: T did not change")
    check(float(state.k.min()) > 0.0 and 0.0 <= float(state.c.min())
          and float(state.c.max()) <= 1.0, "fgmfl: k or c out of range")
    total, spent = _timed_many(
        torch, [(FGMSolverFL, "_lookup_state"), (FGMSolverFL, "_keps_advance")],
        lambda: solver.step(state, FGM_DT))
    spent = {k: sum(v) for k, v in spent.items()}
    print(f"fgmfl breakdown step: {total * 1e3:.2f} ms; manifold reads "
          f"{spent['_lookup_state'] * 1e3:.2f} ms "
          f"({spent['_lookup_state'] / total:.3f}), RAS advance "
          f"{spent['_keps_advance'] * 1e3:.2f} ms "
          f"({spent['_keps_advance'] / total:.3f})")
    return counts, ms


SPRAYFL_FIELDS = ("rho", "U", "p", "ha", "Y", "T", "turb")


def _sprayfl_gate_case(dev: str, draws=None):
    """The face-list aachenBomb at 11 x 20 x 11 in float64 after 2 steps on
    `dev` (a worker). On the card the cloud's draws are recorded; on the
    CPU `draws` (the card's) are replayed. Returns (gas fields, the active
    parcels' fields, the draws recorded, the active mask)."""
    torch = _worker_torch()
    from deepflame_torch.cases import AACHEN_DT, aachen_bomb_3d_fl
    log = []
    if draws is None:
        _recording_draws(log)
    else:
        _replaying_draws(torch, list(draws))
    solver, s = aachen_bomb_3d_fl(MECH, n_xz=11, n_y=20, dtype=torch.float64,
                                  device=dev)
    for _ in range(2):
        s, diag = solver.step(s, AACHEN_DT)
    act = s.cloud.active.cpu().numpy() > 0
    return (_as_numpy(s.gas, SPRAYFL_FIELDS),
            {k: v[..., act] for k, v in
             _as_numpy(s.cloud, PARCEL_FIELDS).items()}, log, act)


def build_chamber(torch):
    """The aachenBomb chamber's blockMesh (AACHEN_NXZ x AACHEN_NY x
    AACHEN_NXZ, one hex block), timed: (GeneralMesh, ELL connectivity of
    its pressure mesh)."""
    from deepflame_torch.cases import AACHEN_WALLS, aachen_blockmesh_dict
    from deepflame_torch.mesh import (build_blockmesh, parse_blockmesh_dict,
                                      zero_gradient)
    t0 = time.perf_counter()
    gm = build_blockmesh(parse_blockmesh_dict(
        aachen_blockmesh_dict(AACHEN_NXZ, AACHEN_NY)))
    m = gm.with_bcs({w: zero_gradient() for w in AACHEN_WALLS},
                    torch.float32, device="cuda")
    conn = m.ell_connectivity()
    print(f"sprayfl: blockMesh of the chamber, {gm.n_cells} cells and "
          f"{gm.owner.shape[0]} interior faces, built in "
          f"{time.perf_counter() - t0:.2f} s")
    return gm, conn


def phase_sprayfl(torch, K, gm):
    """The aachenBomb chamber on a general mesh
    (deepflame_torch.cases.aachen_bomb_3d_fl: the blockMesh hex block, no
    shift plan, kEpsilon with face-list wall functions, the cloud on an
    overlay at the chamber's resolution). Gate first, in workers: 11 x 20
    x 11 float64, 2 steps, the CPU replaying the card's draws: gas fields
    and the active parcels within 1e-8 (the empty slots are evolved too,
    but hold no droplets: their values are no result). Then AACHEN_NXZ x AACHEN_NY x AACHEN_NXZ in
    float32 on `gm`, 1 warm-up and FL_STEPS timed steps, 50 parcels a step
    (ell_matvec must launch; gj_inverse must not: the inert chamber's RK23
    fast tier accepts every cell); the cloud's evolve, the RAS advance and
    the chemistry timed inside one more step. Returns (launch counts of
    the timed steps, ms/step)."""
    from deepflame_torch.cases import AACHEN_DT, aachen_bomb_3d_fl
    from deepflame_torch.combustion import Laminar
    from deepflame_torch.lagrangian.overlay import OverlaySprayCloud
    from deepflame_torch.solvers import LowMachSolverFL
    t0 = time.perf_counter()
    with _pool(2) as pool:
        g_card, p_card, draws, act = pool.submit(_sprayfl_gate_case,
                                                 "cuda").result()
        g_cpu, p_cpu, _, act_cpu = pool.submit(_sprayfl_gate_case, "cpu",
                                               draws).result()
    check((act == act_cpu).all() and act.sum() > 0,
          f"sprayfl gate: {act.sum()} parcels on the card, {act_cpu.sum()} "
          f"on the CPU, or other slots")
    _field_gate(torch, "sprayfl aachenBomb 11 x 20 x 11 float64, 2 steps "
                f"({len(draws)} draws replayed on the CPU)", g_card, g_cpu,
                SPRAYFL_FIELDS, 1e-8)
    _field_gate(torch, f"sprayfl the {act.sum()} active parcels", p_card,
                p_cpu, PARCEL_FIELDS, 1e-8)
    print(f"sprayfl gate: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    solver, state = aachen_bomb_3d_fl(MECH, n_xz=AACHEN_NXZ, n_y=AACHEN_NY,
                                      dtype=torch.float32, device="cuda",
                                      mesh=gm)
    torch.cuda.synchronize()
    n_cells = state.gas.T.numel()
    print(f"sprayfl path: aachenBomb {AACHEN_NXZ} x {AACHEN_NY} x "
          f"{AACHEN_NXZ} float32 on the blockMesh mesh, kEpsilon with wall "
          f"functions, overlay {solver.cloud.cloud.mesh.shape}, "
          f"{solver.cloud.cloud.max_parcels} parcel slots, dt "
          f"{AACHEN_DT:g} s, built in {time.perf_counter() - t0:.2f} s")
    T_before = state.gas.T.clone()
    state, diag, counts, ms = _fl_timed(torch, K, solver, state, AACHEN_DT, 1,
                                        FL_STEPS, "sprayfl", n_cells)
    check(counts["ell_matvec"] > 0 and counts["gj_inverse"] == 0,
          f"sprayfl: launches {counts} (ell_matvec must launch, gj_inverse "
          f"must not)")
    g = state.gas
    iv = solver.fuel_index
    n_act = int(state.cloud.active.sum())
    check(bool(torch.isfinite(g.T).all() and torch.isfinite(g.p).all()
               and all(torch.isfinite(t).all() for t in g.turb)),
          "sprayfl: non-finite gas state")
    check(float((g.T - T_before).abs().max()) > 0.0, "sprayfl: T did not change")
    check(n_act > 0 and float(g.Y[:, iv].max()) > 0.0,
          "sprayfl: no parcels, or no vapour in the gas")
    check(float(g.turb[0].min()) > 0.0, "sprayfl: k not positive")
    print(f"sprayfl state: {n_act} active parcels, k_max "
          f"{float(diag['k_max']):.6f}, max Y_H2O "
          f"{float(g.Y[:, iv].max()):.6e}")
    total, spent = _timed_many(
        torch, [(OverlaySprayCloud, "evolve"),
                (LowMachSolverFL, "_keps_advance"), (Laminar, "correct")],
        lambda: solver.step(state, AACHEN_DT))
    spent = {k: sum(v) for k, v in spent.items()}
    print(f"sprayfl breakdown step: {total * 1e3:.2f} ms; cloud evolve "
          f"{spent['evolve'] * 1e3:.2f} ms ({spent['evolve'] / total:.3f}), "
          f"RAS advance {spent['_keps_advance'] * 1e3:.2f} ms "
          f"({spent['_keps_advance'] / total:.3f}), chemistry "
          f"{spent['correct'] * 1e3:.2f} ms ({spent['correct'] / total:.3f})")
    return counts, ms


# --------------------------------------------------------------------- amr

AMR_STEPS = 1                  # timed coarse steps of the 2D row patches
AMR_1D_WARM, AMR_1D_STEPS = 1, 1   # the 1D nest's warm-up and timed steps
AMR_1D_N = 300                 # the 1D tube's coarse cells (the example's)
AMR_GATES = ("front", "curved", "moving", "nested")
AMR_CURVED_STEPS = 10          # the curved front's steps (its rows move)


def _amr_gate(kind: str, dev: str):
    """One AMR gate in float64 on `dev` (a worker): "front" FrontPatchAMR2D
    on the 64 x 8 channel (2 rows, pc 16, ratio 2, buffer_c 2, buffer_y 2,
    igniters over the lower half), 2 coarse steps; "curved" FrontPatchAMR2D
    on tests/test_patch_amr.py's curved front in air (64 x 12 cells, 3 rows,
    pc 24, ratio 2, buffer_c 3, buffer_y 2, no chemistry), AMR_CURVED_STEPS
    steps, in which the rows move by different amounts; "moving"
    MovingPatchAMR with reflux and "nested" NestedPatchAMR (2 levels,
    criteria, reflux) on the 1D tube at 100 coarse cells (_amr_gate_tube),
    2 coarse steps. Returns (the state as flat numpy leaves in the JAX
    package's layout, {coarse and fine drains' lanes, the offsets after
    each step})."""
    torch = _worker_torch()
    from deepflame_torch.cases import detonation_2d_h2_amr, detonation_dt
    from deepflame_torch.convert import (patch_state_to_numpy,
                                         row_patch_state_to_numpy)
    steps = 2
    if kind == "front":
        amr, ps = detonation_2d_h2_amr(
            MECH, nx=64, ny=8, pc=16, n_rows=2, ratio=2, buffer_c=2,
            buffer_y=2, dtype=torch.float64, device=dev,
            igniters=((0.0, 0.05),))
        dt = detonation_dt(amr.coarse)
    elif kind == "curved":
        amr, ps = _amr_gate_curved(torch, dev)
        dt, steps = 8e-6, AMR_CURVED_STEPS
    else:
        amr, ps = _amr_gate_tube(torch, dev, levels=1 if kind == "moving"
                                 else 2)
        dt = detonation_dt(amr.coarse, a_bound=3500.0)
    offsets = []
    for _ in range(steps):
        ps, diag = amr.step(ps, dt)
        offsets.append(
            diag["patch_offsets"].tolist() if "patch_offsets" in diag
            else [int(diag["patch_offset"])])
    rows = kind in ("front", "curved")
    tree = row_patch_state_to_numpy(ps) if rows else patch_state_to_numpy(ps)
    return _flat_tree(tree), dict(
        lanes=diag.get("chem_lanes"),
        fine_lanes=list(diag.get("fine_chem_lanes", ())), offsets=offsets)


def _amr_gate_curved(torch, dev):
    """tests/test_patch_amr.py's curved front: the one-species air gas on
    1 m x 0.25 m in 64 x 12 cells (zeroGradient, HLLC, RK2, vanLeer, no
    chemistry), 8 atm behind x = 0.30 + 0.04 sin(2 pi y / 0.25), 1 atm
    ahead, 300 K; FrontPatchAMR2D with 3 rows of pc 24, ratio 2, buffer_c
    3, buffer_y 2. Returns (amr, state)."""
    from deepflame_torch import chemistry as tc
    from deepflame_torch import mesh as tm
    from deepflame_torch.mesh.patch_amr import FrontPatchAMR2D
    from deepflame_torch.solvers.high_speed import (HighSpeedConfig,
                                                    HighSpeedSolver)
    mech = tc.load_mechanism(AIR, device=dev)
    zg, e = (tm.zero_gradient(),) * 2, (tm.empty(),) * 2
    b = (zg, zg, e)
    solver = HighSpeedSolver(
        mesh=tm.StructuredMesh.box([1.0, 0.25, 1.0 / 64], [64, 12, 1],
                                   device=mech.device),
        thermo=tc.make_thermo(mech, torch.float64),
        kinetics=tc.make_kinetics(mech, torch.float64), bcs_rho=b,
        bcs_U=(b,) * 3, bcs_p=b, bcs_Y=b,
        config=HighSpeedConfig(flux="HLLC", rk_order=2, limiter="vanLeer",
                               chemistry="none"))
    amr = FrontPatchAMR2D.build(solver, pc=24, n_rows=3, ratio=2,
                                buffer_c=3, buffer_y=2)
    X, Yg, _ = solver.mesh.cell_centers(torch.float64)
    xj = 0.30 + 0.04 * torch.sin(2.0 * math.pi * Yg / 0.25)
    p = torch.where(X < xj, 8.0 * 101325.0, 101325.0).to(torch.float64)
    return amr, amr.initial_state(p, torch.full_like(p, 300.0),
                                  torch.ones((1,) + tuple(p.shape),
                                             dtype=torch.float64,
                                             device=p.device))


def _amr_gate_tube(torch, dev, levels: int):
    """cases.detonation_1d_amr's tube (its mixture, BCs, schemes, patch and
    criteria) at 100 coarse cells of the example's spacing (2 m over
    AMR_1D_N cells, so 0.67 m) with a 4 mm driver (one cell, as at 300
    cells), in float64 with the 2D channel's chemistry options (rtol 1e-4,
    atol 1e-8: the example's float64 ones take some 300 trips a drain
    here). levels 1: MovingPatchAMR; 2: NestedPatchAMR; both with reflux.
    Returns (amr, state)."""
    import numpy as np
    from deepflame_torch import chemistry as tc
    from deepflame_torch import mesh as tm
    from deepflame_torch.cases import DET1D_BUFFER, DET1D_PC, DET1D_RATIO
    from deepflame_torch.chemistry.integrator import RosenbrockOptions
    from deepflame_torch.mesh.amr import RefinementCriteria
    from deepflame_torch.mesh.patch_amr import MovingPatchAMR, NestedPatchAMR
    from deepflame_torch.solvers.high_speed import (HighSpeedConfig,
                                                    HighSpeedSolver)
    f64, n = torch.float64, 100
    length = 2.0 * n / AMR_1D_N
    mech = tc.load_mechanism(MECH, device=dev)
    e = (tm.empty(),) * 2
    b = ((tm.zero_gradient(),) * 2, e, e)
    b_un = ((tm.symmetry(negate=True), tm.zero_gradient()), e, e)
    coarse = HighSpeedSolver(
        mesh=tm.StructuredMesh.box([length, length / n, length / n],
                                   [n, 1, 1], device=mech.device),
        thermo=tc.make_thermo(mech, f64), kinetics=tc.make_kinetics(mech, f64),
        bcs_rho=b, bcs_U=(b_un, b, b), bcs_p=b, bcs_Y=b,
        config=HighSpeedConfig(
            flux="HLLC", rk_order=2, limiter="vanLeer", chemistry="ode",
            ode_opts=RosenbrockOptions(rtol=1e-4, atol=1e-8, max_steps=5000),
            T_threshold=500.0))
    if levels == 1:
        amr = MovingPatchAMR.build(coarse, pc=DET1D_PC, ratio=DET1D_RATIO,
                                   buffer_c=DET1D_BUFFER, reflux=True)
    else:
        amr = NestedPatchAMR.build(
            coarse, pcs=(DET1D_PC,) * 2, ratio=2, buffer_c=DET1D_BUFFER,
            isotropic=False, reflux=True, criteria=RefinementCriteria(
                gradients=(("rho", 0.03),), fields=(("p", 3e5, 1e9),),
                n_buffer=2))
    Yv = np.zeros(mech.n_species)
    for name, y in (("H2", 0.02851), ("O2", 0.226), ("N2", 0.745)):
        Yv[mech.species_index(name)] = y
    X, _, _ = coarse.mesh.cell_centers(f64)
    drv = X < 0.004
    T = torch.where(drv, 2000.0, 300.0).to(f64)
    p = torch.where(drv, 90.0 * 101325.0, 101325.0).to(f64)
    Y = torch.as_tensor(Yv / Yv.sum(), dtype=f64, device=X.device)
    Y = Y[:, None, None, None].expand((mech.n_species,) + coarse.mesh.shape)
    return amr, amr.initial_state(p, T, Y.contiguous(), offset=0)


def _flat_tree(tree, prefix="") -> dict:
    """Nested dicts of arrays as one dict keyed by dotted paths."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _tree_gate(torch, label, a, b, tol):
    """Card leaves a against CPU leaves b: every float leaf within tol of
    its largest value, every integer leaf (the patch offsets) equal."""
    import numpy as np
    ints = [k for k in a if a[k].dtype.kind in "iu"]
    for k in ints:
        check(np.array_equal(a[k], b[k]), f"{label}: {k} {a[k]} != {b[k]}")
    _field_gate(torch, label, a, b, tuple(k for k in a if k not in ints),
                tol)
    print(f"{label}: offsets equal " + json.dumps(
        {k: a[k].tolist() for k in ints}))


class _DrainSpy:
    """Every chemistry drain (HighSpeedSolver._chemistry_split) by solver,
    labelled by `names` {id(solver): label}: its active lanes and the
    gj_inverse launches it made; with `timed`, also every
    HighSpeedSolver.step call's seconds by solver, synchronised before and
    after."""

    def __init__(self, torch, K, names, timed=False):
        from deepflame_torch.solvers.high_speed import HighSpeedSolver
        self.torch, self.K, self.names, self.timed = torch, K, names, timed
        self.cls, self.drains, self.steps = HighSpeedSolver, [], []

    def __enter__(self):
        spy, cls = self, self.cls
        self.split, self.step = cls._chemistry_split, cls.step

        def split(solver, s, dt, stats=None):
            st = {} if stats is None else stats
            n0 = spy.K.launches["gj_inverse"]
            out = spy.split(solver, s, dt, st)
            spy.drains.append((spy.names.get(id(solver), "other"),
                               st["chem_lanes"],
                               spy.K.launches["gj_inverse"] - n0))
            return out

        def step(solver, s, dt):
            spy.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = spy.step(solver, s, dt)
            spy.torch.cuda.synchronize()
            spy.steps.append((spy.names.get(id(solver), "other"),
                              time.perf_counter() - t0))
            return out

        cls._chemistry_split = split
        if self.timed:
            cls.step = step
        return self

    def __exit__(self, *exc):
        self.cls._chemistry_split, self.cls.step = self.split, self.step

    def by(self, label):
        """(lanes of each drain, launches of each drain) of one solver."""
        rows = [(n, g) for who, n, g in self.drains if who == label]
        return [n for n, _ in rows], [g for _, g in rows]


def _amr_submit(pool) -> dict:
    """Submit phase_amr's gate runs, card and CPU sides."""
    return {(k, d): pool.submit(_amr_gate, k, d)
            for k in AMR_GATES for d in ("cuda", "cpu")}


def phase_amr(torch, K, runs=None):
    """AMR on the density-based solver. Gates first, side by side in worker
    processes (card and CPU, float64; see _amr_gate): FrontPatchAMR2D on
    the 64 x 8 channel and on the curved front, MovingPatchAMR with reflux
    and NestedPatchAMR (2 levels, criteria, reflux) on the 1D tube at 100
    cells; every conserved field of coarse and fine within 1e-8 of its
    largest value, the offsets equal after every step; fine cells burn in
    the reacting gates, and the curved front's rows move, by different
    amounts. Then the two AMR paths in float32 (_amr_path, _amr_tube), and
    gj_inverse against its plain version and the library at the smallest
    and the largest fine drain of the row patches' timed steps
    (_gj_rows_fresh). `runs`: those _amr_submit gave (done), else
    submitted here. Returns
    ({path: launch counts of its timed steps}, {path: ms per coarse step},
    [those gj_inverse rows])."""
    t0 = time.perf_counter()
    if runs is None:
        with _pool(2 * len(AMR_GATES)) as pool:
            runs = _amr_submit(pool)
    for kind in AMR_GATES:
        (card, dc), (ref, dr) = (runs[kind, "cuda"].result(),
                                 runs[kind, "cpu"].result())
        _tree_gate(torch, f"amr {kind} gate float64, "
                          f"{len(dc['offsets'])} steps, card vs CPU",
                   card, ref, 1e-8)
        print(f"amr {kind} gate: offsets after each step "
              f"{dc['offsets']}; last step's drains, coarse "
              f"{dc['lanes']} lanes, fine {dc['fine_lanes']}")
        check(dc["offsets"] == dr["offsets"],
              f"amr {kind}: the card's offsets {dc['offsets']} are not "
              f"the CPU's {dr['offsets']}")
        if kind == "curved":
            seen = [tuple(o) for o in dc["offsets"]]
            check(len(set(seen)) > 1 and any(len(set(o)) > 1
                                             for o in seen),
                  f"amr curved: the rows did not move, or moved alike: "
                  f"{seen}")
        else:
            check(min(dc["fine_lanes"]) > 0,
                  f"amr {kind}: no fine cell burned in the gate")
    print(f"amr gates: {time.perf_counter() - t0:.1f} s")
    counts, ms = {}, {}
    counts["amr"], ms["amr"], fine_lanes = _amr_path(torch, K)
    counts["amr1d"], ms["amr1d"] = _amr_tube(torch, K)
    lanes = sorted({min(fine_lanes), max(fine_lanes)})
    with _pool(1) as pool:
        rows = pool.submit(_gj_rows_fresh, lanes).result()
    for L, row in zip(lanes, rows):
        row["path"] = "amr fine drain"
        print(f"gj_inverse n=10 L={L} f32 (amr fine drain): "
              + json.dumps(row))
    return counts, ms, rows


def _gj_rows_fresh(lanes):
    """_gj_row at n = 10, float32, at each of `lanes`, in a worker (the amr
    and dist phases' drains): a fresh process, as the kernels phase times
    the other drains' lanes early in its own. Late in the whole smoke, torch.linalg.inv's profiled windows
    once held 192 device operations for 20 calls (16 calls' worth of its
    12), in every attempt; fresh, after 300 other windows and with 60 GiB
    of the card held they hold 240 (tools/profiler_window_counts.py)."""
    torch = _worker_torch()
    from deepflame_torch.ops import kernels as K
    g = torch.Generator(device="cuda").manual_seed(0)
    return [_gj_row(torch, K, g, 10, L, torch.float32) for L in lanes]


def _amr_path(torch, K):
    """detonation_2d_h2_amr at HS_NX x HS_NY coarse cells in float32, the
    hs path's solver (factory.build_high_speed_solver with _hs_case()):
    5 row patches of 96 x 26 fine cells, ratio 4. 1 warm-up and AMR_STEPS
    timed coarse steps (launch counts set to 0 just before, read just
    after; gj_inverse must launch in the coarse and in the fine drains);
    then the fine substeps timed inside one more step, one step of the
    uniform channel from the same state, and, labelled, one step of the
    uniform x-refined (4 HS_NX) x HS_NY channel at dt / 4. Returns (launch
    counts, ms per coarse step, the fine drains' lanes)."""
    from deepflame_torch.cases import (detonation_2d_h2, detonation_2d_h2_amr,
                                       detonation_dt)
    t0 = time.perf_counter()
    amr, ps = detonation_2d_h2_amr(MECH, nx=HS_NX, ny=HS_NY,
                                   dtype=torch.float32, device="cuda",
                                   case=_hs_case())
    torch.cuda.synchronize()
    dt = detonation_dt(amr.coarse)
    r, pc, rows, by = amr.ratio, amr.pc, amr.n_rows, amr.buffer_y
    cu_amr = HS_NX * HS_NY + rows * (pc * r) * (HS_NY // rows + 2 * by) * r
    cu_fine = (HS_NX * r) * HS_NY * r
    print(f"amr path: {HS_NX} x {HS_NY} float32 channel with "
          f"FrontPatchAMR2D, {rows} row patches of "
          f"{amr.fine.mesh.nx} x {amr.fine.mesh.ny} fine cells (pc {pc}, "
          f"ratio {r}, buffer_c {amr.buffer_c}, buffer_y {by}), dt "
          f"{dt:.6e} s, the fine substeps dt / {r}; offsets "
          f"{ps.offsets.tolist()}; built in {time.perf_counter() - t0:.2f} s")
    print(f"amr cell-updates per coarse step (examples/detonation_2d.py"
          f":116-120): {cu_amr}, uniform x-fine {cu_fine} "
          f"({cu_fine / cu_amr:.2f}x)")
    t0 = time.perf_counter()
    ps, _ = amr.step(ps, dt)
    torch.cuda.synchronize()
    print(f"amr warm-up: 1 coarse step in {time.perf_counter() - t0:.2f} s")
    names = {id(amr.coarse): "coarse", id(amr.fine): "fine"}
    T_before = ps.coarse.T.clone()
    offsets = []
    with _DrainSpy(torch, K, names) as spy:
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        for _ in range(AMR_STEPS):
            ps, diag = amr.step(ps, dt)
            offsets.append(diag["patch_offsets"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(K.launches)
    ms = wall / AMR_STEPS * 1e3
    lanes_c, gj_c = spy.by("coarse")
    lanes_f, gj_f = spy.by("fine")
    print(f"amr path counts over {AMR_STEPS} coarse steps: "
          f"{json.dumps(counts)}; per step " + json.dumps(
              {k: v / AMR_STEPS for k, v in counts.items()}))
    print(f"amr path: {ms:.2f} ms per coarse step, {cu_amr / (ms / 1e3):.4e} "
          f"cell-updates/s by the example's count, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"amr drains per coarse step: {len(lanes_c) / AMR_STEPS:g} coarse, "
          f"{len(lanes_f) / AMR_STEPS:g} fine (one per substep, every row "
          f"in it); gj_inverse launches per step: coarse "
          f"{sum(gj_c) / AMR_STEPS:g}, fine {sum(gj_f) / AMR_STEPS:g}")
    print(f"amr drains: coarse lanes {lanes_c}, launches {gj_c}; fine lanes "
          f"{lanes_f}, launches {gj_f}")
    offsets = [o.tolist() for o in offsets]
    fronts = amr._fronts(ps.coarse.rho).tolist()
    print(f"amr row offsets after each step {offsets}; the rows' fronts "
          f"(coarse x-index of max |d rho/dx|) after the last {fronts}")
    check(len(lanes_f) == AMR_STEPS * r, f"amr: {len(lanes_f)} fine drains "
                                         f"in {AMR_STEPS} steps, not one a "
                                         f"substep")
    check(counts["gj_inverse"] > 0 and sum(gj_c) > 0 and sum(gj_f) > 0,
          f"amr: gj_inverse did not launch in the coarse and the fine "
          f"drains: {counts}, {gj_c}, {gj_f}")
    check(counts["gj_inverse"] == sum(gj_c) + sum(gj_f),
          f"amr: launches outside the drains: {counts}")
    check(offsets[-1] == [min(max(f - pc // 2, 0), HS_NX - pc)
                          for f in fronts],
          "amr: the offsets are not the rows' recentred fronts")
    c = ps.coarse
    rho, U, p, T, _ = amr.coarse.primitives(c)
    check(bool(torch.isfinite(c.rhoE).all() and torch.isfinite(T).all()
               and torch.isfinite(ps.fine.rhoE).all()),
          "amr: non-finite state")
    check(float((c.T - T_before).abs().max()) > 0.0, "amr: T did not change")
    check(float(p.min()) > 0 and float(rho.min()) > 0, "amr: p or rho <= 0")
    check(float(T.max()) > 1500.0, "amr: the igniters went out")
    check(float((c.rhoY.sum(0) - c.rho).abs().max())
          <= 1e-4 * float(c.rho.max()), "amr: rhoY does not sum to rho")

    with _DrainSpy(torch, K, names, timed=True) as spy:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        amr.step(ps, dt)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    fine_s = sum(t for who, t in spy.steps if who == "fine")
    coarse_s = sum(t for who, t in spy.steps if who == "coarse")
    print(f"amr breakdown step: {total * 1e3:.2f} ms, of which the {r} fine "
          f"substeps {fine_s * 1e3:.2f} ms ({fine_s / total:.3f}) and the "
          f"coarse step {coarse_s * 1e3:.2f} ms ({coarse_s / total:.3f})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    amr.coarse.step(ps.coarse, dt)
    torch.cuda.synchronize()
    print(f"amr: one step of the uniform {HS_NX} x {HS_NY} channel from the "
          f"same state {(time.perf_counter() - t0) * 1e3:.2f} ms, beside "
          f"{ms:.2f} ms per AMR coarse step")

    # a labelled measurement: the uniform resolution the patches stand in
    # for along x
    solver, state = detonation_2d_h2(MECH, nx=r * HS_NX, ny=HS_NY,
                                     dtype=torch.float32, device="cuda",
                                     case=_hs_case())
    state, _ = solver.step(state, dt / r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, d = solver.step(state, dt / r)
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    print(f"amr labelled measurement (not a path): one step of the uniform "
          f"x-refined {r * HS_NX} x {HS_NY} channel at dt / {r} after one "
          f"warm-up, {one * 1e3:.2f} ms ({d['chem_lanes']} drain lanes); "
          f"{r} such steps cover one coarse step: {r * one * 1e3:.2f} ms")
    check(bool(torch.isfinite(state.rhoE).all()), "amr: x-fine non-finite")
    del solver, state
    return counts, ms, lanes_f


def _amr_tube(torch, K):
    """detonation_1d_amr(levels=2, reflux=True) at AMR_1D_N coarse cells in
    float32: AMR_1D_WARM warm-up and AMR_1D_STEPS timed coarse steps
    (launch counts set to 0 just before, read just after; gj_inverse must
    launch). Returns (launch counts, ms per coarse step)."""
    from deepflame_torch.cases import detonation_1d_amr, detonation_dt
    t0 = time.perf_counter()
    amr, ps = detonation_1d_amr(MECH, n=AMR_1D_N, levels=2, reflux=True,
                                dtype=torch.float32, device="cuda")
    dt = detonation_dt(amr.coarse, a_bound=3500.0)
    print(f"amr1d path: {AMR_1D_N}-cell tube, NestedPatchAMR 2 levels of pc "
          f"{amr.pc} (fine arrays {amr.fine.mesh.nx} and "
          f"{amr.child.fine.mesh.nx} cells), ratio 2 a level, criteria, "
          f"reflux, float32, dt {dt:.6e} s; built in "
          f"{time.perf_counter() - t0:.2f} s")
    for _ in range(AMR_1D_WARM):
        ps, _ = amr.step(ps, dt)
    names = {id(amr.coarse): "coarse", id(amr.fine): "level 1",
             id(amr.child.fine): "level 2"}
    offsets = []
    with _DrainSpy(torch, K, names) as spy:
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(AMR_1D_STEPS):
            ps, diag = amr.step(ps, dt)
            offsets.append((diag["patch_offset"], ps.fine.offset))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(K.launches)
    ms = wall / AMR_1D_STEPS * 1e3
    per = {lvl: spy.by(lvl) for lvl in ("coarse", "level 1", "level 2")}
    print(f"amr1d path: {ms:.2f} ms per coarse step; counts over "
          f"{AMR_1D_STEPS} steps {json.dumps(counts)}; drains per step "
          + json.dumps({k: len(v[0]) / AMR_1D_STEPS for k, v in per.items()})
          + "; gj_inverse launches per step "
          + json.dumps({k: sum(v[1]) / AMR_1D_STEPS for k, v in per.items()})
          + "; lanes " + json.dumps({k: v[0] for k, v in per.items()}))
    print("amr1d offsets (level 1, level 2) after each step "
          + json.dumps([[int(a), int(b)] for a, b in offsets]))
    check(counts["gj_inverse"] > 0, f"amr1d: gj_inverse was not launched: "
                                    f"{counts}")
    check(bool(torch.isfinite(ps.coarse.rhoE).all()
               and torch.isfinite(ps.fine.fine.rhoE).all()),
          "amr1d: non-finite state")
    _, _, p, T, _ = amr.coarse.primitives(ps.coarse)
    check(float(T.max()) > 1500.0 and float(p.min()) > 0,
          "amr1d: the driver went out or p <= 0")
    return counts, ms


# ------------------------------------------------------------- dist phase

DIST_RANKS = 4                 # ranks of the dist phase, all on cuda:0
DIST_JOIN_S = 420              # seconds before the ranks are killed
DIST_PG_S = 120                # seconds a collective may wait
DIST_DT = {"tgv": DT, "sjet": JET_DT, "fljet": JET_DT}
DIST_LABEL = f"{DIST_RANKS} ranks sharing one H100 (gloo)"
DIST_SPLIT_TOL = 1e-9          # distributed vs single-device, both on the card


def _dist_case(case: str, dev, dtype, n: int = 8, mesh=None):
    """(solver, state) of a dist-phase case: the stiff TGV, the structured
    jet ((2n, n, n)) or the blockMesh face-list jet."""
    from deepflame_torch import cases
    if case == "tgv":
        return cases.reacting_tgv_3d_les(MECH, n=n, dtype=dtype, device=dev)
    if case == "sjet":
        return cases.jet_flame_3d_les(MECH, n=n, dtype=dtype, device=dev)
    return cases.jet_flame_3d_les_fl(MECH, n=n, dtype=dtype, device=dev,
                                     mesh=mesh)


def _dist_fields(state, fl: bool) -> dict:
    keys = ["rho", "U", "p", "ha", "Y", "T"] + (["phi_b"] if fl else [])
    out = {k: (tuple(t.cpu().numpy() for t in getattr(state, k))
               if isinstance(getattr(state, k), tuple)
               else getattr(state, k).cpu().numpy()) for k in keys}
    out["phi"] = (state.phi.cpu().numpy() if fl
                  else tuple(t.cpu().numpy() for t in state.phi))
    return out


def _dist_diag(d: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in d.items()}


def _dist_chem_inputs(n_cells: int):
    """(T, p, Y) numpy: cold cells but a hot front in the first rank's
    quarter (the JAX package's test_chem_dlb front)."""
    import numpy as np
    from deepflame_torch.chemistry import load_mechanism
    mech = load_mechanism(MECH, device="cpu")
    rng = np.random.default_rng(7)
    T = np.full(n_cells, 320.0)
    q = n_cells // DIST_RANKS
    T[: q // 2] = rng.uniform(1400.0, 2200.0, q // 2)
    Yf = np.zeros(mech.n_species)
    for s_, v in (("H2", 0.0285), ("O2", 0.2264), ("N2", 0.7451)):
        Yf[mech.species_index(s_)] = v
    return T, np.full(n_cells, 101325.0), np.tile(Yf, (n_cells, 1))


def _dist_ref(case: str, dev: str):
    """A reference of a float64 gate: two single-device steps on `dev`
    (fields, diagnostics per step), in a worker process."""
    torch = _worker_torch()
    t0 = time.perf_counter()
    solver, state = _dist_case(case, dev, torch.float64)
    diags = []
    for _ in range(2):
        state, d = solver.step(state, DIST_DT[case])
        diags.append(_dist_diag(d))
    return _dist_fields(state, case == "fljet"), diags, \
        time.perf_counter() - t0


def _dist_gate(torch, case: str, mesh_shape, group, dev):
    """Two float64 steps of a gate case on this rank's block."""
    from deepflame_torch.parallel import (DistributedLowMach,
                                          DistributedLowMachFL)
    import torch.distributed as tdist
    t0 = time.perf_counter()
    solver, state = _dist_case(case, dev, torch.float64)
    if case == "fljet":
        dist = DistributedLowMachFL(solver, group=group, device=dev)
    else:
        dist = DistributedLowMach(solver, mesh_shape=mesh_shape,
                                  group=group, device=dev)
    ds = dist.shard_state(state)
    diags = []
    for _ in range(2):
        ds, d = dist.step(ds, DIST_DT[case])
        diags.append(_dist_diag(d))
    s = dist.gather_state(ds)
    lead = tdist.get_rank(group) == 0
    return dict(fields=_dist_fields(s, case == "fljet") if lead else None,
                diags=diags, seconds=time.perf_counter() - t0)


def _dist_chem(torch, rank: int, dev) -> dict:
    """solve_chemistry(cross_shard=True) of this rank's quarter of 4,096
    cells on the card, and on rank 0 the global solve of all of them."""
    from deepflame_torch.chemistry import (load_mechanism, make_kinetics,
                                           make_thermo)
    from deepflame_torch.chemistry.integrator import RosenbrockOptions
    from deepflame_torch.chemistry.reactor import solve_chemistry
    from deepflame_torch.parallel import ShardGroup, shard_axis
    from deepflame_torch.parallel.context import comm_stats
    mech = load_mechanism(MECH, device=dev)
    th = make_thermo(mech, torch.float64)
    kin = make_kinetics(mech, torch.float64)
    opts = RosenbrockOptions(rtol=1e-6, atol=1e-10, max_steps=2000)
    T, p, Y = (torch.as_tensor(a, device=dev) for a in _dist_chem_inputs(4096))
    q = T.shape[0] // DIST_RANKS
    sl = slice(rank * q, (rank + 1) * q)
    a2a = comm_stats["all_to_all"]
    with shard_axis(ShardGroup((DIST_RANKS,), ("x",))):
        r = solve_chemistry(th, kin, T[sl], p[sl], Y[sl], 1e-6, opts,
                            n_bins=8, cross_shard=True)
    out = dict(local=tuple(t.cpu().numpy() for t in (r.T, r.Y, r.RR)),
               all_to_all=comm_stats["all_to_all"] - a2a, ref=None)
    if rank == 0:
        g = solve_chemistry(th, kin, T, p, Y, 1e-6, opts, n_bins=32)
        out["ref"] = tuple(t.cpu().numpy() for t in (g.T, g.Y, g.RR))
    return out


class _LaunchArgs:
    """The shape arguments of every kernel launch inside the block
    (ops.kernels._launch wrapped): table() = {kernel: {(form, dtype, the
    launch's trailing size arguments): launches}}, the trailing arguments
    of helmholtz7_apply's padded form (nx, ny, nz, 1/hx^2, 1/hy^2,
    1/hz^2), gj_inverse's (n, L) and ell_matvec's (n, w); other forms by
    their name alone."""
    TAIL = {"helmholtz7_apply": 6, "gj_inverse": 2, "ell_matvec": 2}

    def __init__(self, K):
        self.K = K
        self.seen = collections.defaultdict(collections.Counter)

    def __enter__(self):
        launch = self.launch = self.K._launch
        seen, tails = self.seen, self.TAIL

        def spy(name, dtype, device, *args, form=""):
            tail = tails.get(name) if form == "" else None
            seen[name][(form, str(dtype).replace("torch.", ""),
                        tuple(args[-tail:]) if tail else ())] += 1
            return launch(name, dtype, device, *args, form=form)

        self.K._launch = spy
        return self

    def __exit__(self, *exc):
        self.K._launch = self.launch

    def table(self) -> dict:
        return {k: dict(v) for k, v in self.seen.items()}


def _dist_timed(torch, K, dist, ds, dt, steps: int):
    """`steps` timed steps of every rank (launch and collective counts set
    to 0 just before, read just after; rank 0's wall time closed by
    synchronize and a barrier); `shapes`: _LaunchArgs' table of them."""
    import torch.distributed as tdist
    from deepflame_torch.parallel.context import comm_stats, reset_comm_stats
    torch.cuda.synchronize()
    tdist.barrier()
    K.reset_launches()
    reset_comm_stats()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _LaunchArgs(K) as spy:
        for _ in range(steps):
            ds, diag = dist.step(ds, dt)
    torch.cuda.synchronize()
    tdist.barrier()
    wall = time.perf_counter() - t0
    return ds, diag, dict(
        ms=wall / steps * 1e3, launches=dict(K.launches),
        shapes=spy.table(),
        comm={k: v / steps for k, v in comm_stats.items()},
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def _dist_tgv96(torch, K, dev) -> dict:
    """The 96^3 stiff TGV over (4, 1, 1) ranks in float32: 1 warm-up and STEPS
    timed steps, then one step with the cross-shard chemistry balance."""
    from deepflame_torch.parallel import DistributedLowMach
    t0 = time.perf_counter()
    solver, state = _dist_case("tgv", dev, torch.float32, n=N_MAIN)
    dist = DistributedLowMach(solver, mesh_shape=(DIST_RANKS, 1, 1),
                              device=dev)
    ds = dist.shard_state(state)
    del state
    build = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds, _ = dist.step(ds, DT)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    T0 = ds.T.clone()
    ds, diag, timed = _dist_timed(torch, K, dist, ds, DT, STEPS)
    finite = bool(torch.isfinite(ds.T).all() and torch.isfinite(ds.p).all())
    changed = float((ds.T - T0).abs().max()) > 0.0
    dlb = DistributedLowMach(dataclasses.replace(
        solver, combustion=dataclasses.replace(solver.combustion,
                                               dlb_cross_shard=True)),
        mesh_shape=(DIST_RANKS, 1, 1), device=dev)
    ds, diag_dlb, timed_dlb = _dist_timed(torch, K, dlb, ds, DT, 1)
    return dict(build_s=build, warm_s=warm, timed=timed, dlb=timed_dlb,
                diag={k: float(v) for k, v in diag.items()},
                diag_dlb={k: float(v) for k, v in diag_dlb.items()},
                finite=finite and bool(torch.isfinite(ds.T).all()),
                changed=changed, block=tuple(ds.T.shape))


def _dist_fl128(torch, K, dev, mesh_path: str) -> dict:
    """The 128 x 64 x 64 blockMesh jet over 4 ranks in float32, cells in
    (1, 2, 2) blocks across the jet axis: 1 warm-up and 1 timed step."""
    import pickle
    from deepflame_torch.parallel import DistributedLowMachFL, block_order
    deadline = time.monotonic() + 240
    while not os.path.exists(mesh_path):
        check(time.monotonic() < deadline, "the jet's blockMesh never came")
        time.sleep(0.5)
    t0 = time.perf_counter()
    with open(mesh_path, "rb") as f:
        gm = pickle.load(f)
    solver, state = _dist_case("fljet", dev, torch.float32, n=N_JET, mesh=gm)
    dist = DistributedLowMachFL(solver, device=dev,
                                order=block_order(gm.centers, (1, 2, 2)))
    ds = dist.shard_state(state)
    del state, gm
    build = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds, _ = dist.step(ds, JET_DT)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    T0 = ds.T.clone()
    ds, diag, timed = _dist_timed(torch, K, dist, ds, JET_DT, 1)
    own = dist.w_own > 0
    # rank 0's own ELL connectivity (side, nbr), for the kernels line
    conn = (tuple(t.cpu().numpy() for t in dist.local_solver.p_ell[1:])
            if dist.shard.rank == 0 else None)
    return dict(build_s=build, warm_s=warm, timed=timed, conn=conn,
                diag={k: float(v) for k, v in diag.items()},
                finite=bool(torch.isfinite(ds.T).all()
                            and torch.isfinite(ds.p).all()),
                changed=float((ds.T - T0)[own].abs().max()) > 0.0,
                n_loc=dist.decomp.n_loc, owned=int(own.sum()))


def _dist_rank(rank: int, world: int, store: str, out_dir: str,
               mesh_path: str) -> None:
    """One rank of the dist phase: gloo over the file store, cuda:0."""
    import datetime
    import pickle
    import traceback
    torch = _worker_torch()
    torch.set_num_threads(1)
    import torch.distributed as tdist
    result = {}
    try:
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        tdist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=DIST_PG_S))
        from deepflame_torch.ops import kernels as K
        result["backend"] = str(tdist.get_backend())
        pairs = [tdist.new_group([0, 1]), tdist.new_group([2, 3])]
        t0 = time.perf_counter()
        if rank < 2:
            result["tgv-211"] = _dist_gate(torch, "tgv", (2, 1, 1),
                                           pairs[0], dev)
        else:
            result["sjet-211"] = _dist_gate(torch, "sjet", (2, 1, 1),
                                            pairs[1], dev)
        result["tgv-221"] = _dist_gate(torch, "tgv", (2, 2, 1), None, dev)
        result["fljet-4"] = _dist_gate(torch, "fljet", None, None, dev)
        result["chem"] = _dist_chem(torch, rank, dev)
        result["gates_s"] = time.perf_counter() - t0
        result["tgv96"] = _dist_tgv96(torch, K, dev)
        result["fl128"] = _dist_fl128(torch, K, dev, mesh_path)
        tdist.barrier()
        tdist.destroy_process_group()
        result["ok"] = True
    except BaseException:
        result["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _dist_iters_gate(label, diags_by_rank, ref_diags):
    """Diagnostics bit-equal across ranks; per-solve iteration counts
    equal across ranks and within 1 of the single-device step's."""
    import numpy as np
    d0 = diags_by_rank[0]
    for r, d in enumerate(diags_by_rank[1:], 1):
        for step, (a, b) in enumerate(zip(d, d0)):
            check(a.keys() == b.keys(), f"{label}: diagnostic keys, rank {r}")
            for k in a:
                check(np.array_equal(a[k], b[k]),
                      f"{label}: diagnostic {k} of step {step + 1} differs "
                      f"on rank {r}: {a[k]} vs {b[k]}")
    worst = 0
    for a, b in zip(d0, ref_diags):
        for k in a:
            if k.startswith("iters"):
                dev = int(np.abs(np.asarray(a[k], np.int64)
                                 - np.asarray(b[k], np.int64)).max())
                worst = max(worst, dev)
                check(dev <= 1, f"{label}: {k} {a[k]} vs single-device "
                                f"{b[k]}")
    its = {k: v.tolist() for k, v in d0[-1].items() if k.startswith("iters")}
    print(f"{label}: diagnostics equal on every rank; iteration counts of "
          f"the last step {json.dumps(its)}, largest deviation from the "
          f"single-device step's {worst}")


def phase_dist(torch, K):
    """The distributed paths on ranks sharing the card over gloo (module
    docstring, phase 15). Returns ({path: rank 0's launch counts}, the
    kernels' rows at the paths' shapes: _dist_kernel_rows)."""
    import pickle
    import shutil
    import tempfile
    import multiprocessing
    import numpy as np
    from deepflame_torch import native
    t_phase = time.perf_counter()
    native.build()
    tmp = tempfile.mkdtemp(prefix="dist-")
    mesh_path = os.path.join(tmp, "jet64.pkl")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_dist_rank, daemon=True,
                         args=(r, DIST_RANKS, os.path.join(tmp, "store"),
                               tmp, mesh_path))
             for r in range(DIST_RANKS)]
    try:
        for p in procs:
            p.start()
        with _pool(6) as pool:
            refs = {(c, d): pool.submit(_dist_ref, c, d)
                    for c in ("fljet", "sjet", "tgv") for d in ("cpu", "cuda")}
            # the full-width jet's blockMesh, built here while the ranks
            # run their gates (the ranks load it for the 128 x 64 x 64 path)
            t0 = time.perf_counter()
            from deepflame_torch.cases import jet_blockmesh_dict
            from deepflame_torch.mesh.blockmesh import (build_blockmesh,
                                                        parse_blockmesh_dict)
            gm = build_blockmesh(parse_blockmesh_dict(jet_blockmesh_dict(N_JET)))
            with open(mesh_path + ".tmp", "wb") as f:
                pickle.dump(gm, f, protocol=5)
            os.replace(mesh_path + ".tmp", mesh_path)
            del gm
            print(f"dist: the {2 * N_JET} x {N_JET} x {N_JET} jet's blockMesh "
                  f"built by the parent in {time.perf_counter() - t0:.1f} s")
            refs = {c: f.result() for c, f in refs.items()}
        deadline = time.monotonic() + DIST_JOIN_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        results = []
        for r in range(DIST_RANKS):
            path = os.path.join(tmp, f"rank{r}.pkl")
            res = {}
            if os.path.exists(path):
                with open(path, "rb") as f:
                    res = pickle.load(f)
            results.append(res)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    check(not hung, f"dist: ranks {hung} still running after {DIST_JOIN_S} "
                    "s (killed)")
    for r, res in enumerate(results):
        check(res.get("ok"), f"dist: rank {r} failed (exit code "
                             f"{procs[r].exitcode}):\n{res.get('error')}")
    staged = results[0]["tgv96"]["timed"]["comm"]["staged"]
    print(f"dist: {DIST_LABEL}: backend {results[0]['backend']}, halo "
          f"planes staged through the host: {staged:.0f} a TGV step "
          f"(all_reduce, all_gather and all_to_all take the card's "
          f"tensors); gates {results[0]['gates_s']:.1f} s on rank 0; "
          "single-device references " + json.dumps(
              {"/".join(c): round(v[2], 1) for c, v in refs.items()}) + " s")

    # ---- float64 gates: card (distributed) against CPU (single device)
    for label, case, ranks in (("tgv (2,1,1)", "tgv", (0, 1)),
                               ("tgv (2,2,1)", "tgv", (0, 1, 2, 3)),
                               ("sjet (2,1,1)", "sjet", (2, 3)),
                               ("fljet 4 ranks", "fljet", (0, 1, 2, 3))):
        key = {"tgv (2,1,1)": "tgv-211", "tgv (2,2,1)": "tgv-221",
               "sjet (2,1,1)": "sjet-211", "fljet 4 ranks": "fljet-4"}[label]
        got = [results[r][key] for r in ranks]
        ref_fields, ref_diags, _ = refs[case, "cpu"]
        card_fields = refs[case, "cuda"][0]
        flow = ("U", "phi") + (("phi_b",) if case == "fljet" else ())
        jet = case != "tgv"
        scalars = ("rho", "p", "ha", "Y", "T")
        _field_gate(torch, f"dist {label}", got[0]["fields"], ref_fields,
                    scalars + (() if jet else flow),
                    1e-8, flow=flow if jet else (), flow_tol=1e-6)
        _field_gate(torch, f"dist {label}", got[0]["fields"], card_fields,
                    scalars + flow, DIST_SPLIT_TOL,
                    what="distributed vs single-device, both on the card")
        print(f"dist {label}: beside it, the single-device step on the card "
              "vs the CPU's: " + json.dumps(
                  {k: float(f"{v:.3e}") for k, v in _field_devs(
                      torch, card_fields, ref_fields, scalars + flow).items()}))
        _dist_iters_gate(f"dist {label}", [g["diags"] for g in got],
                         ref_diags)
    chem = [res["chem"] for res in results]
    loc = [np.concatenate([c["local"][i] for c in chem]) for i in range(3)]
    ref = chem[0]["ref"]
    errs = [float(np.abs(a - b).max() / np.abs(b).max())
            for a, b in zip(loc, ref)]
    print(f"dist chemistry: cross_shard solve of 4,096 cells on "
          f"{DIST_RANKS} ranks against the global solve on the card: T, Y, "
          f"RR deviation {errs[0]:.3e}, {errs[1]:.3e}, {errs[2]:.3e} of the "
          f"largest value; all_to_alls per solve "
          f"{[c['all_to_all'] for c in chem]}")
    check(errs[0] <= 1e-10 and errs[1] <= 1e-10 and errs[2] <= 1e-8,
          f"dist chemistry: cross-shard solve deviates {errs}")
    check(all(c["all_to_all"] == 2 for c in chem), "dist chemistry: "
          "all_to_all count")

    # ---- full-width paths
    counts = {}
    for key, label, need, cells in (
            ("tgv96", f"dist stiff TGV {N_MAIN}^3 (4,1,1)",
             ("helmholtz7_apply", "gj_inverse"), N_MAIN ** 3),
            ("fl128", f"dist face-list jet {2 * N_JET} x {N_JET} x {N_JET} "
             "(1,2,2) blocks", ("ell_matvec", "gj_inverse"),
             2 * N_JET ** 3)):
        runs = [res[key] for res in results]
        r0 = runs[0]
        ms = r0["timed"]["ms"]
        print(f"{label}, float32, {DIST_LABEL}: built in "
              f"{r0['build_s']:.1f} s, warm-up step {r0['warm_s']:.2f} s; "
              f"{ms:.2f} ms/step, {cells / (ms / 1e3):.4e} cell-updates/s "
              f"({cells} cells)")
        for r, run in enumerate(runs):
            t = run["timed"]
            comm = {k: round(v, 1) for k, v in t["comm"].items()}
            print(f"  rank {r}: launches per step " + json.dumps(
                {k: v / (STEPS if key == "tgv96" else 1)
                 for k, v in t["launches"].items()})
                  + f"; collectives per step {json.dumps(comm)}; peak "
                  f"{t['peak_gib']:.2f} GiB")
            check(run["finite"] and run["changed"],
                  f"{label}: rank {r}: non-finite or unchanged T")
        if key == "tgv96":
            for r, run in enumerate(runs):
                d = run["dlb"]
                print(f"  rank {r}, one step with dlb_cross_shard: "
                      f"{d['ms']:.2f} ms, launches " + json.dumps(
                          d["launches"]) + ", all_to_alls "
                      f"{d['comm']['all_to_all']:.0f} "
                      f"({d['comm']['all_to_all_bytes'] / 2**20:.2f} MiB)")
            # the sphere lies in the middle ranks' blocks: stiff cells
            # reach every rank through the balanced step
            for r, run in enumerate(runs):
                t, d = run["timed"]["launches"], run["dlb"]["launches"]
                check(t["helmholtz7_apply"] > 0 and d["helmholtz7_apply"] > 0,
                      f"{label}: helmholtz7_apply did not launch on rank {r}")
                check(t["gj_inverse"] + d["gj_inverse"] > 0,
                      f"{label}: gj_inverse did not launch on rank {r}")
            print(f"  diagnostics: " + json.dumps(r0["diag"]) + "; with "
                  "the balance: " + json.dumps(r0["diag_dlb"]))
        else:
            for r, run in enumerate(runs):
                t = run["timed"]["launches"]
                check(all(t[k] > 0 for k in need),
                      f"{label}: {need} did not launch on rank {r}: {t}")
            print(f"  diagnostics: " + json.dumps(r0["diag"])
                  + f"; {r0['owned']} owned cells of {r0['n_loc']} slots "
                  "on rank 0")
        counts[f"dist-{key}"] = dict(r0["timed"]["launches"])
    rows = _dist_kernel_rows(torch, K, results)
    print(f"dist phase: {time.perf_counter() - t_phase:.1f} s")
    return counts, rows


def _dist_kernel_rows(torch, K, results) -> dict:
    """Each kernel against its plain version at the shapes the full-width
    paths launched it with on the ranks (_LaunchArgs): helmholtz7_apply's
    padded form at every shape of the TGV's timed steps (the 24 x 96 x 96
    rank block; float32, _helmholtz_row), ell_matvec on rank 0's own
    connectivity of the face-list jet (its halo rows, pad faces left out;
    _ell_figures), and gj_inverse (n = 10, float32) at
    the smallest and largest drain over all ranks of the TGV's timed
    steps, of its balanced step and of the jet's timed step. Returns
    {"helmholtz": [rows], "ell": row, "gj": [rows]}, each row labelled
    with its path; the rows are measured in a fresh worker
    (_dist_rows_fresh)."""
    out = {"helmholtz": [], "gj": []}
    padded = set()
    for res in results:
        for (form, dt, args) in res["tgv96"]["timed"]["shapes"].get(
                "helmholtz7_apply", {}):
            check(form == "" and dt == "float32",
                  f"dist TGV: a helmholtz7_apply launch of form {form!r} "
                  f"in {dt}")
            padded.add(args)
    check(padded, "dist TGV: no padded helmholtz7_apply launch recorded")
    side, nbr = results[0]["fl128"]["conn"]
    launched = {args for (_, dt, args) in results[0]["fl128"]["timed"][
        "shapes"].get("ell_matvec", {})}
    check(launched == {tuple(nbr.shape)}, f"dist face-list jet: rank 0's "
          f"ell_matvec launches {launched}, its connectivity "
          f"{tuple(nbr.shape)}")

    paths = {}
    for key, sub, label in (("tgv96", "timed", "dist TGV drain"),
                            ("tgv96", "dlb", "dist TGV balanced drain"),
                            ("fl128", "timed", "dist face-list jet drain")):
        lanes = []
        for res in results:
            for (_, dt, (n, L)) in res[key][sub]["shapes"].get(
                    "gj_inverse", {}):
                check(n == 10 and dt == "float32", f"{label}: gj_inverse "
                      f"n = {n} in {dt}")
                lanes.append(int(L))
        check(lanes, f"{label}: no gj_inverse launch on any rank")
        print(f"{label}: gj_inverse launched at {len(set(lanes))} lane "
              f"counts over the ranks, {min(lanes)} to {max(lanes)}")
        for L in {min(lanes), max(lanes)}:
            paths.setdefault(L, []).append(label)
    with _pool(1) as pool:
        hh, ell, gj = pool.submit(_dist_rows_fresh, sorted(padded), side,
                                  nbr, sorted(paths)).result()
    for row in hh:
        row["path"] = "dist stiff TGV, (4, 1, 1) rank block"
        print("helmholtz7_apply at the dist TGV's rank block: "
              + json.dumps(row))
        out["helmholtz"].append(row)
    ell["path"] = "dist face-list jet, rank 0's connectivity"
    ell["owned_rows"] = results[0]["fl128"]["owned"]
    print("ell_matvec at the dist face-list jet's rank 0: " + json.dumps(ell))
    out["ell"] = ell
    for L, row in zip(sorted(paths), gj):
        row["path"] = ", ".join(paths[L])
        print(f"gj_inverse n=10 L={L} f32 ({row['path']}): " + json.dumps(row))
        out["gj"].append(row)
    return out


def _dist_rows_fresh(padded, side, nbr, lanes):
    """In a fresh worker (see _gj_rows_fresh; late in the whole smoke the
    plain Helmholtz's profiled windows also lost records, 367 of 380 in
    every attempt): helmholtz7_apply's padded form at each of `padded`
    (launch arguments nx, ny, nz, 1/hx^2, 1/hy^2, 1/hz^2), ell_matvec on
    the connectivity (side, nbr) (numpy) and gj_inverse at each of
    `lanes`. Returns (helmholtz rows, the ell row, gj rows)."""
    torch = _worker_torch()
    import numpy as np
    from deepflame_torch.ops import kernels as K
    g = torch.Generator(device="cuda").manual_seed(15)
    hh = []
    for args in padded:
        shape = tuple(int(v) for v in args[:3])
        spacing = tuple(ih ** -0.5 if ih > 0 else 1.0 for ih in args[3:])
        hh.append(_helmholtz_row(torch, K, _helmholtz_sets(torch, g, shape,
                                                           spacing)))
    side_t, nbr_t = (torch.as_tensor(np.ascontiguousarray(a), device="cuda")
                     for a in (side, nbr))
    ell = _ell_figures(torch, K, g, (None, side_t, nbr_t))
    gj = [_gj_row(torch, K, g, 10, L, torch.float32) for L in lanes]
    return hh, ell, gj


# ------------------- DF-ODENet training and the closed-loop DNN flame

DNNLOOP_N = 512                 # the Tu500K-Phi1 flame's cells
DNNLOOP_SAMPLES, DNNLOOP_EPOCHS, DNNLOOP_BATCH = 2048, 2, 512
# timed steps of the DNN (after 1 warm-up) and of the stiff model (none);
# the stiff step takes 17 drains of 8 or more trips (about 5 s)
DNNLOOP_STEPS, DNNLOOP_ODE_STEPS = 10, 2
DNNLOOP_GATE_N, DNNLOOP_GATE_LANES = 64, 256
DNNLOOP_GATE_HIDDEN = (32, 16, 8)
# the data sets' options: the script's draws, ranges and delta_t with a
# pre-burn of at most 1 us (the script's 100 us drains its stiffest lane
# through thousands of trips of about 30 ms); the float64 gate's data set
# at rtol 1e-4 and atol 1e-8 (the script's: 1e-7 and 1e-13)
DNNLOOP_DATA = dict(pre_burn_max=1e-6)
DNNLOOP_GATE_DATA = dict(pre_burn_max=1e-6, rtol=1e-4, atol=1e-8)
# the gate's closed-loop net: seeded narrow nets, inputs scaled to the
# flame's range, small targets (tests/test_torch_flame_1d.py's scales)
DNNLOOP_GATE_STATS = dict(x_mean=[1500.0, 101325.0] + [-5.0] * 9,
                          x_std=[700.0, 1e3] + [3.0] * 9,
                          y_mean=[0.0] * 8, y_std=[1e-4] * 8)
DNNLOOP_FIELDS = ("rho", "U", "p", "ha", "Y", "T", "phi")


def _dnnloop_burnt(torch):
    """The burnt composition every dnnloop flame starts from: the closed
    loop's 5 ms ignition from 1400 K (rtol 1e-4, atol 1e-8) in float64 on
    the CPU, read at 4 output times where the examples read 200 (the state
    at 5 ms is the same equilibrium within the tolerance; 200 reads take
    about 1,700 trips on one lane, 4 about 210). Every flame worker computes
    it alike, so the card and the CPU sides of a gate start from the same
    numbers. Returns numpy (ns,)."""
    from deepflame_torch.cases import FLAME_IGNITION_TIME, _premixed
    from deepflame_torch.chemistry import (load_mechanism, make_kinetics,
                                           make_thermo)
    from deepflame_torch.chemistry.integrator import RosenbrockOptions
    from deepflame_torch.chemistry.reactor import ignite
    mech = load_mechanism(MECH, device="cpu")
    _, _, Yb = ignite(make_thermo(mech), make_kinetics(mech), 1400.0,
                      101325.0, torch.as_tensor(_premixed(mech, "H2", 1.0)),
                      FLAME_IGNITION_TIME, n_out=4,
                      opts=RosenbrockOptions(rtol=1e-4, atol=1e-8,
                                             max_steps=20000))
    return Yb[-1].numpy()


def _dnnloop_data_gate(dev: str):
    """In a worker: the data set of DNNLOOP_GATE_LANES states in float64 on
    `dev` (seed 0, DNNLOOP_GATE_DATA), then 3 Adam steps (1 epoch, batch
    DNNLOOP_GATE_LANES // 3) on nets of DNNLOOP_GATE_HIDDEN from a CPU
    generator seeded with 0, trained in float64 on its Xn, Dn. Returns
    numpy arrays: the data set's, the trained weights, the losses."""
    torch = _worker_torch()
    from deepflame_torch.chemistry import (load_mechanism, make_kinetics,
                                           make_thermo)
    from deepflame_torch.chemistry.dnn import init_params
    from deepflame_torch.chemistry.dnn_train import (make_dfodenet_dataset,
                                                     train_dfodenet)
    t0 = time.perf_counter()
    mech = load_mechanism(MECH, device=dev)
    d = make_dfodenet_dataset(mech, make_thermo(mech), make_kinetics(mech),
                              DNNLOOP_GATE_LANES, device=dev,
                              **DNNLOOP_GATE_DATA)
    nets = init_params(torch.Generator().manual_seed(0), mech.n_species,
                       DNNLOOP_GATE_HIDDEN, dtype=torch.float64, device=dev)
    trained, losses = train_dfodenet(
        nets, d.Xn.double(), d.Dn.double(), epochs=1,
        batch=DNNLOOP_GATE_LANES // 3, seed=d.rng)
    out = {k: getattr(d, k).cpu().numpy()
           for k in ("X", "D", "x_mean", "x_std", "y_mean", "y_std")}
    out["W"] = [t.cpu().numpy() for net in trained for W, b in net
                for t in (W, b)]
    out["losses"] = losses
    out["seconds"] = time.perf_counter() - t0
    return out


def _dnnloop_flame_gate(dev: str, which: str):
    """In a worker: 2 float64 steps on `dev` at DNNLOOP_GATE_N cells from
    _dnnloop_burnt's composition, of the anchored flame ("anchored", Laminar) or of one model of
    the closed loop ("ode" or "dnn"; the DNN's nets from a CPU generator
    seeded with 1 at DNNLOOP_GATE_HIDDEN, DNNLOOP_GATE_STATS). Laminar
    drains every cell in one bin (n_bins 1): a lane's result does not
    depend on its bin, and the default 32 bins of 2 cells take 3,300-3,700
    trips for the 2 steps (157 s on a CPU) where one bin takes about 240.
    Returns (fields as numpy, the last step's Krylov iterations, seconds,
    the burnt composition)."""
    torch = _worker_torch()
    from deepflame_torch.cases import dnn_closed_loop_flame, flame_1d_anchored
    from deepflame_torch.chemistry.dnn import DFODENet, init_params
    t0 = time.perf_counter()
    Y_burnt = _dnnloop_burnt(torch)
    f64 = torch.float64
    if which == "anchored":
        solver, s, dt, _ = flame_1d_anchored(MECH, n=DNNLOOP_GATE_N,
                                             dtype=f64, device=dev,
                                             Y_burnt=Y_burnt)
    else:
        t = lambda v: torch.as_tensor(v, dtype=f64, device=dev)
        net = DFODENet(
            nets=init_params(torch.Generator().manual_seed(1), 9,
                             DNNLOOP_GATE_HIDDEN, dtype=f64, device=dev),
            **{k: t(v) for k, v in DNNLOOP_GATE_STATS.items()},
            delta_t=1e-6)
        solvers, s, dt, _ = dnn_closed_loop_flame(
            MECH, net, n=DNNLOOP_GATE_N, dtype=f64, device=dev,
            Y_burnt=Y_burnt)
        solver = solvers[which]
    if which != "dnn":
        solver = dataclasses.replace(solver, combustion=dataclasses.replace(
            solver.combustion, n_bins=1))
    for _ in range(2):
        s, diag = solver.step(s, dt)
    iters = {k: int(v) for k, v in diag.items() if k.startswith("iters")}
    return (_as_numpy(s, DNNLOOP_FIELDS), iters, time.perf_counter() - t0,
            Y_burnt)


def _dnnloop_submit_gates(pool) -> dict:
    """Submit the float64 gates, card and CPU sides (_dnnloop_check_gates)."""
    jobs = {("data", dev): pool.submit(_dnnloop_data_gate, dev)
            for dev in ("cuda", "cpu")}
    jobs.update({(w, dev): pool.submit(_dnnloop_flame_gate, dev, w)
                 for w in ("anchored", "ode", "dnn")
                 for dev in ("cuda", "cpu")})
    return jobs


def _dnnloop_check_gates(torch, jobs):
    """The float64 gates, card against the port's CPU path, each side in a
    worker: the data set (every array within 1e-10 of its largest value)
    and 3 Adam steps (every weight within 1e-9 of its tensor's largest
    |W|, losses 1e-10 relative); the anchored flame and both models of the
    closed loop at DNNLOOP_GATE_N cells, 2 steps, every field and face flux
    within 1e-8 of its largest value and the Krylov iterations equal.
    Returns the flames' burnt composition."""
    import numpy as np
    card, ref = jobs["data", "cuda"].result(), jobs["data", "cpu"].result()
    _field_gate(torch, f"dnnloop data set, {DNNLOOP_GATE_LANES} lanes "
                f"float64", card, ref,
                ("X", "D", "x_mean", "x_std", "y_mean", "y_std"), 1e-10)
    w_dev = max(float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(card["W"], ref["W"]))
    l_dev = max(abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                    ref["losses"]))
    print(f"dnnloop Adam, 3 steps at {DNNLOOP_GATE_HIDDEN} float64: "
          f"weights within {w_dev:.3e} of each tensor's largest, loss "
          f"{l_dev:.3e} relative ({card['losses']}); data set and training "
          f"{card['seconds']:.1f} s on the card, {ref['seconds']:.1f} s on "
          f"the CPU")
    check(w_dev <= 1e-9 and l_dev <= 1e-10, "dnnloop: Adam steps")
    check(float(np.abs(ref["D"]).max()) > 1e-3, "dnnloop: the data set's "
          "targets are all zero")
    burnt = []
    for w in ("anchored", "ode", "dnn"):
        (a, ia, sa, ya), (b, ib, sb, yb) = (jobs[w, "cuda"].result(),
                                            jobs[w, "cpu"].result())
        _field_gate(torch, f"dnnloop {w} flame at {DNNLOOP_GATE_N} cells "
                    f"float64, 2 steps", a, b, DNNLOOP_FIELDS, 1e-8)
        print(f"dnnloop {w} flame gate: iterations {json.dumps(ia)}; "
              f"{sa:.1f} s on the card, {sb:.1f} s on the CPU (the burnt "
              f"composition's ignition included)")
        check(ia == ib, f"dnnloop {w}: iterations {ia} vs {ib}")
        burnt += [ya, yb]
    check(all(np.array_equal(y, burnt[0]) for y in burnt),
          "dnnloop: the workers' burnt compositions differ")
    print("dnnloop burnt composition (5 ms ignition from 1400 K, 4 reads, "
          "float64 on the CPU): Y " + json.dumps(
              [float(f"{v:.6e}") for v in burnt[0]]))
    return burnt[0]


def phase_dnnloop(torch, K):
    """DF-ODENet training and the closed-loop DNN flame (module docstring,
    phase 16): the float64 gates (_dnnloop_gates), then in float32 at the
    DNN TGV's widths: the data set of DNNLOOP_SAMPLES states, DNNLOOP_EPOCHS
    epochs of Adam at batch DNNLOOP_BATCH (one untimed step first), the
    checkpoint written and served; the Tu500K-Phi1 closed loop at
    DNNLOOP_N cells, DNNLOOP_ODE_STEPS timed steps of the stiff model, 1
    warm-up and DNNLOOP_STEPS of the DNN (compared after DNNLOOP_ODE_STEPS
    steps of each); the kernels at the path's shapes. Returns ({path:
    launch counts}, {kernel: rows at the path's shapes}, {path: ms per
    step})."""
    with _pool(1) as rows_pool:
        # a fresh process for the kernel rows (_dnnloop_rows_fresh),
        # started now so that it is up when the rows are due
        rows_pool.submit(_worker_ready)
        with _pool(8) as pool:
            jobs = _dnnloop_submit_gates(pool)
            # the data set is built beside the gate workers: its seconds
            # are printed, not a metric of the path
            data = _dnnloop_data(torch, K)
            Yb = _dnnloop_check_gates(torch, jobs)
        return _dnnloop_path(torch, K, rows_pool, Yb, data)


def _worker_ready() -> None:
    """A job that only starts a worker process (and imports torch there)."""
    _worker_torch()


def _dnnloop_data(torch, K):
    """The full-width data set: DNNLOOP_SAMPLES states in float32 on the
    card (DNNLOOP_DATA). Returns (the data set, its launch counts, the
    gj_inverse lane counts it launched at)."""
    from deepflame_torch.chemistry import (load_mechanism, make_kinetics,
                                           make_thermo)
    from deepflame_torch.chemistry.dnn_train import make_dfodenet_dataset
    mech = load_mechanism(MECH, device="cuda")
    th, kin = make_thermo(mech, torch.float32), make_kinetics(mech,
                                                            torch.float32)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    with _LaunchArgs(K) as spy:
        data = make_dfodenet_dataset(mech, th, kin, DNNLOOP_SAMPLES,
                                     device="cuda", **DNNLOOP_DATA)
        torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = dict(K.launches)
    lanes = sorted({int(a[1]) for (_, _, a) in
                    spy.table().get("gj_inverse", {})})
    print(f"dnnloop data set: {DNNLOOP_SAMPLES} states float32, pre-burn "
          f"to {DNNLOOP_DATA['pre_burn_max']:g} s then {data.delta_t:g} s, "
          f"{gen_s:.2f} s beside the gate workers; launches "
          f"{json.dumps(counts)}; gj_inverse lanes {lanes}")
    check(counts["gj_inverse"] > 0, "dnnloop: the data set launched no "
          "gj_inverse")
    check(bool(torch.isfinite(data.Xn).all() and torch.isfinite(data.Dn)
               .all()), "dnnloop: non-finite data set")
    return data, counts, lanes


def _dnnloop_path(torch, K, rows_pool, Yb, data_run):
    """phase_dnnloop after its gates and data set: training, the
    checkpoint, the closed loop from the burnt composition Yb, the kernel
    rows."""
    import tempfile
    from deepflame_torch.cases import closed_loop_compare, dnn_closed_loop_flame
    from deepflame_torch.chemistry.dnn import init_params, load_npz_checkpoint
    from deepflame_torch.chemistry.dnn_train import (save_npz_checkpoint,
                                                     train_dfodenet)

    data, data_counts, data_lanes = data_run
    counts, ms = {"dnnloop-data": data_counts}, {}
    check(not torch.backends.cuda.matmul.allow_tf32, "dnnloop: TF32 matmuls "
          "are on; training is to run in float32")
    widths = MLP_WIDTHS[1:-1]
    ns = data.X.shape[1] - 2
    nets = init_params(torch.Generator().manual_seed(0), ns, widths,
                       dtype=torch.float32, device="cuda")
    train_dfodenet(nets, data.Xn, data.Dn, epochs=1, batch=DNNLOOP_BATCH,
                   seed=1 << 20)                        # untimed: one step
    n_steps = DNNLOOP_EPOCHS * (DNNLOOP_SAMPLES // DNNLOOP_BATCH)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    trained, losses = train_dfodenet(nets, data.Xn, data.Dn,
                                     epochs=DNNLOOP_EPOCHS,
                                     batch=DNNLOOP_BATCH, seed=data.rng)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts["dnnloop-train"] = dict(K.launches)
    ms["dnnloop-adam"] = train_s / n_steps * 1e3
    print(f"dnnloop training: {ns - 1} nets "
          f"{'-'.join(map(str, MLP_WIDTHS))} float32, {DNNLOOP_EPOCHS} "
          f"epochs of {DNNLOOP_SAMPLES // DNNLOOP_BATCH} steps at batch "
          f"{DNNLOOP_BATCH}: {ms['dnnloop-adam']:.3f} ms per Adam step, "
          f"{n_steps * DNNLOOP_BATCH / train_s:.1f} samples/s; epoch losses "
          f"{losses}; launches {json.dumps(counts['dnnloop-train'])}")
    check(all(v == 0 for v in counts["dnnloop-train"].values()),
          "dnnloop: training launched a kernel (it runs the plain MLP)")
    check(all(math.isfinite(v) for v in losses), "dnnloop: non-finite loss")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dfodenet.npz")
        save_npz_checkpoint(path, trained, data.x_mean, data.x_std,
                            data.y_mean, data.y_std, data.delta_t)
        served = load_npz_checkpoint(path, dtype=torch.float32,
                                     device="cuda")
        check(all(torch.equal(W, Ws) for net, net_s in zip(trained,
                                                            served.nets)
                  for (W, _), (Ws, _) in zip(net, net_s)),
              "dnnloop: the checkpoint read back other weights")
        solvers, s0, dt, info = dnn_closed_loop_flame(
            MECH, path, n=DNNLOOP_N, dtype=torch.float32, device="cuda",
            Y_burnt=Yb)
    print(f"dnnloop closed loop: Tu500K-Phi1, {DNNLOOP_N} cells float32 over "
          f"{info['length'] * 1e3:g} mm, u_in {info['u_in']:g} m/s, T_b "
          f"{info['T_b']:.1f} K, dt {dt:.6e} s; DNN from the checkpoint, "
          f"frozen_T {solvers['dnn'].combustion.net.frozen_T:g} K")
    # per model: warm-up steps, timed steps up to the compared state (the
    # same step count for both), timed steps after it. The Laminar step
    # takes no warm-up: on an H100 its first step was no slower than the
    # next ones (5.01-6.22 s against 4.92-6.11 s a step; PERF.md)
    plan = {"ode": (0, DNNLOOP_ODE_STEPS, 0),
            "dnn": (1, DNNLOOP_ODE_STEPS - 1,
                    DNNLOOP_STEPS - DNNLOOP_ODE_STEPS + 1)}
    final, gj_lanes = {}, []
    for name, solver in solvers.items():
        n_warm, n_cmp, n_more = plan[name]
        t0 = time.perf_counter()
        s = s0
        for _ in range(n_warm):
            s, _ = solver.step(s, dt)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        key = f"dnnloop-{name}"
        with _LaunchArgs(K) as spy:
            s, diag, c, wall = _timed_steps(torch, K, solver, s, dt, n_cmp)
            final[name] = s
            if n_more:
                s, diag, c2, wall2 = _timed_steps(torch, K, solver, s, dt,
                                                  n_more)
                c = {k: v + c2[k] for k, v in c.items()}
                wall += wall2
        steps = n_cmp + n_more
        counts[key], ms[key] = c, wall / steps * 1e3
        if name == "ode":
            gj_lanes = sorted({int(a[1]) for (_, _, a) in
                               spy.table().get("gj_inverse", {})})
        print(f"dnnloop {name}: {n_warm} warm-up step(s) {warm:.3f} s, "
              f"{ms[key]:.2f} ms/step "
              f"over {steps} steps, "
              f"{DNNLOOP_N / (wall / steps):.4e} cell-updates/s, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches {json.dumps(c)}; T [{float(s.T.min()):.1f}, "
              f"{float(s.T.max()):.1f}] K; iterations "
              + json.dumps({k: int(v) for k, v in diag.items()
                            if k.startswith("iters")}))
        check(all(bool(torch.isfinite(getattr(s, k)).all())
                  for k in ("T", "Y", "U", "p", "rho")),
              f"dnnloop {name}: non-finite fields")
        check(float(s.T.min()) > 0.0, f"dnnloop {name}: T <= 0")
        need = ("stencil7_apply", "helmholtz7_apply",
                "gj_inverse" if name == "ode" else "mlp_fused")
        check(all(c[k] > 0 for k in need), f"dnnloop {name}: a kernel of "
              f"the path did not launch: {c}")
    check(counts["dnnloop-dnn"]["mlp_fused"] == DNNLOOP_STEPS,
          "dnnloop dnn: mlp_fused not once a step")
    cmp = closed_loop_compare(final, info, ms_per_step={
        "ode": ms["dnnloop-ode"], "dnn": ms["dnnloop-dnn"]})
    print(f"dnnloop accuracy after {DNNLOOP_ODE_STEPS} steps of each "
          f"model (printed, not gated: {DNNLOOP_EPOCHS} epochs train no "
          f"converged net): " + json.dumps(cmp))
    print(f"dnnloop drains of the Laminar steps: gj_inverse lanes "
          f"{gj_lanes}")

    lanes = {}
    for L, label in ([(L, "dnnloop data set drain") for L in
                      {min(data_lanes), max(data_lanes)}]
                     + [(L, "dnnloop Laminar flame drain") for L in
                        ({min(gj_lanes), max(gj_lanes)} if gj_lanes
                         else ())]):
        lanes.setdefault(L, []).append(label)
    rows = rows_pool.submit(_dnnloop_rows_fresh, sorted(lanes),
                          info["dx"]).result()
    for row in rows["mlp_fused"]:
        print(f"mlp_fused f32 B={row['shape'][0]} (dnnloop): "
              + json.dumps(row))
    for row in rows["stencil7_apply"]:
        print("stencil7_apply at the flame's shape: " + json.dumps(row))
    for row in rows["helmholtz7_apply"]:
        print("helmholtz7_apply_bc at the flame's shape: " + json.dumps(row))
    for L, row in zip(sorted(lanes), rows["gj_inverse"]):
        row["path"] = ", ".join(lanes[L])
        print(f"gj_inverse n=10 L={L} f32 ({row['path']}): "
              + json.dumps(row))
    return counts, rows, ms


def _dnnloop_rows_fresh(lanes, dx: float) -> dict:
    """In the fresh worker of phase_dnnloop (see _dist_rows_fresh): each
    kernel against its plain version at the path's shapes, float32:
    mlp_fused at B = DNNLOOP_N and 2 DNNLOOP_N (DF-ODENet's widths), the
    stencil at 1, 3 and 9 lanes of DNNLOOP_N x 1 x 1 with open boundaries,
    the Helmholtz BC form on that lattice with the flame's pressure BCs
    (spacing dx), gj_inverse (n = 10) at each of `lanes`."""
    torch = _worker_torch()
    from deepflame_torch.mesh import empty, fixed_value, zero_gradient
    from deepflame_torch.ops import kernels as K
    g = torch.Generator(device="cuda").manual_seed(16)
    rows = {"mlp_fused": [], "stencil7_apply": []}
    for B in (DNNLOOP_N, 2 * DNNLOOP_N):
        row = _mlp_row(torch, K, g, torch.float32, B, 1e-5, reps=20, warm=3,
                       chunk=1 << 17, plain_reps=5)
        row["path"] = "dnnloop closed loop" if B == DNNLOOP_N else "dnnloop"
        rows["mlp_fused"].append(row)
    for n_lanes in (1, 3, 9):
        row = _stencil_row(torch, K, g, (n_lanes, DNNLOOP_N, 1, 1), True)
        row["path"] = "dnnloop flame"
        rows["stencil7_apply"].append(row)
    zg, e = zero_gradient(), (empty(), empty())
    row = _helmholtz_bc_row(torch, K, _helmholtz_bc_sets(
        torch, g, (DNNLOOP_N, 1, 1), (dx, dx, dx),
        ((zg, fixed_value(101325.0)), e, e)),
        "flame bcs_p: zeroGradient inlet, fixedValue outlet, empty y, z")
    row["path"] = "dnnloop flame"
    rows["helmholtz7_apply"] = [row]
    rows["gj_inverse"] = [_gj_row(torch, K, g, 10, L, torch.float32)
                          for L in lanes]
    return rows

# ------------------------- the examples' own families (A16-A21 of ROADMAP)

EX_GATE_STEPS = 2
# float64 gates: (builder, its small-size options)
EX_GATES = {
    "flame_1d": dict(n=32),
    "reacting_tgv_2d": dict(n=8),
    # cells = 6: the coarsest mesh with a cell centre in the 2 mm jet (at
    # cells = 4 no fuel enters)
    "jet_flame_2d": dict(n=6, model="EDC"),
    "detonation_1d": dict(n=40, length=0.2),
    "shock_dry": dict(n=24, dry=True),
    "shock_fog": dict(n=24, dry=False),
}
EX_DROPLET_GATE_STEPS = 10
EX_WORKERS = 6                 # processes of the gates and the shock's runs
EX_LM_FIELDS = ("rho", "U", "p", "ha", "Y", "T", "phi")
EX_SHOCK_RH = 417.0            # m/s: examples/shock_watermist_1d.py:144-149
EX_TGV_STEPS = 2               # timed steps of the 2D TGV, a write each
# timed steps (after 1 warm-up) of each other path
EX_STEPS = {"flame_1d": 1, "jet_flame_2d": 1, "detonation_1d": 1,
            "shock_dry": 2, "shock_fog": 2}


def _ex_build(name: str, dev: str, dtype, **kw):
    """(solver, state, dt, info) of one family on `dev`."""
    from deepflame_torch import cases
    if name.startswith("shock"):
        return cases.shock_watermist_1d(MECH, dtype=dtype, device=dev, **kw)
    if name == "reacting_tgv_2d":
        solver, state, fos, control = cases.reacting_tgv_2d(
            MECH, dtype=dtype, device=dev, **kw)
        return solver, state, control.delta_t, dict(fos=fos, control=control)
    return getattr(cases, name)(MECH, dtype=dtype, device=dev, **kw)


def _ex_fields(name: str, s) -> dict:
    """A family's state as numpy for its gate: the low-Mach fields with
    the face flux as one array over the three axes (a deviation over its
    largest |phi|: the jet's transverse flux alone peaks at round-off's
    scale) and the k-epsilon fields; the density-based fields; with the fog
    the parcels too."""
    import numpy as np
    if name in ("flame_1d", "reacting_tgv_2d", "jet_flame_2d"):
        out = _as_numpy(s, EX_LM_FIELDS)
        out["phi"] = np.concatenate([f.ravel() for f in out["phi"]])
        if name == "jet_flame_2d":
            out.update({f"turb{i}": t.cpu().numpy()
                        for i, t in enumerate(s.turb)})
        return out
    if name == "shock_fog":
        return {**_as_numpy(s.gas, HS_FIELDS),
                **{"cloud_" + k: v for k, v in
                   _as_numpy(s.cloud, PARCEL_FIELDS).items()}}
    return _as_numpy(s, HS_FIELDS)


def _ex_gate_case(name: str, dev: str):
    """In a worker: EX_GATE_STEPS float64 steps of one family at its gate
    size (EX_GATES) on `dev`. Returns (fields as numpy, the Krylov
    iterations of each step, the chemistry lanes of the last step)."""
    torch = _worker_torch()
    solver, s, dt, _ = _ex_build(name, dev, torch.float64, **EX_GATES[name])
    iters = []
    for _ in range(EX_GATE_STEPS):
        s, diag = solver.step(s, dt)
        iters.append({k: int(v) for k, v in diag.items()
                      if k.startswith("iters")})
    return _ex_fields(name, s), iters, int(diag.get("chem_lanes", 0))


def _ex_droplet_gate(dev: str):
    """In a worker: EX_DROPLET_GATE_STEPS steps of each of the droplet's
    runs in float64 on `dev`: u_p after every step and the parcel arrays."""
    torch = _worker_torch()
    from deepflame_torch.cases import DROPLET_RUNS, droplet_relaxation
    out = {}
    for d_um, t_end in DROPLET_RUNS:
        u, c = droplet_relaxation(d_um * 1e-6, t_end, device=dev,
                                  steps=EX_DROPLET_GATE_STEPS)
        out[f"u_{d_um}"] = u.cpu().numpy()
        out.update({f"{k}_{d_um}": v for k, v in
                    _as_numpy(c, PARCEL_FIELDS).items()})
    return out


def _ex_shock_anchor(dry: bool):
    """In a worker: examples/shock_watermist_1d.py's own run on the card,
    float32 at 240 cells to t_end = 2 ms (1,200 steps), the shock read
    every n_steps // 40 steps on the example's clock; the speed fitted
    over x in (0.1, 1.0) m. Returns (times, fronts, speed, seconds)."""
    torch = _worker_torch()
    from deepflame_torch.cases import front_speed, shock_front
    solver, s, dt, info = _ex_build("shock_dry" if dry else "shock_fog",
                                    "cuda", torch.float32, dry=dry)
    t0, t_wall = 0.0, time.perf_counter()
    times, fronts = [], []
    for i in range(info["n_steps"]):
        s, _ = solver.step(s, dt)
        t0 += dt
        if (i + 1) % info["every"] == 0:
            p = info["prims"](s)[2]
            check(bool(torch.isfinite(p).all()), "examples shock: diverged")
            times.append(t0)
            fronts.append(shock_front(p, info["x"]))
    return (times, fronts, front_speed(times, fronts, 0.1, 1.0),
            time.perf_counter() - t_wall)


def _ex_check_gates(torch, jobs) -> None:
    """The float64 gates, card against the port's CPU path: every field
    and parcel array within 1e-8 of its largest value, the low-Mach
    families' Krylov iterations equal after each step."""
    for name, opts in EX_GATES.items():
        (a, ia, la), (b, ib, lb) = (jobs[name, "cuda"].result(),
                                    jobs[name, "cpu"].result())
        _field_gate(torch, f"examples {name} {opts} float64, "
                    f"{EX_GATE_STEPS} steps", a, b, tuple(a), 1e-8)
        print(f"examples {name} gate: iterations {json.dumps(ia)}, "
              f"chemistry lanes {la}")
        check(ia == ib, f"examples {name}: iterations {ia} vs {ib}")
        check(la == lb, f"examples {name}: chemistry lanes {la} vs {lb}")
    check(jobs["detonation_1d", "cuda"].result()[2] >= 1,
          "examples detonation gate: no driver cell in the drain")
    a, b = jobs["droplet", "cuda"].result(), jobs["droplet", "cpu"].result()
    _field_gate(torch, f"examples droplet, {EX_DROPLET_GATE_STEPS} steps "
                "of each diameter, float64", a, b, tuple(a), 1e-8)


def _ex_timed(torch, K, name, solver, s, dt, steps, spy=None):
    """1 warm-up step, then `steps` timed ones (launch counts set to 0 just
    before, read just after); prints ms/step, cell-updates/s and peak
    GiB. Returns (state, diag, counts, ms per step)."""
    t0 = time.perf_counter()
    s, _ = solver.step(s, dt)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    if spy is None:
        s, diag, c, wall = _timed_steps(torch, K, solver, s, dt, steps)
    else:
        with spy:
            s, diag, c, wall = _timed_steps(torch, K, solver, s, dt, steps)
    ms = wall / steps * 1e3
    gas = s.gas if hasattr(s, "gas") else s
    cells = gas.T.numel()
    print(f"examples {name}: warm-up {warm:.3f} s, {ms:.2f} ms/step over "
          f"{steps} step(s), {cells / (wall / steps):.4e} cell-updates/s "
          f"({cells} cells), peak {torch.cuda.max_memory_allocated() / 2**30:.3f}"
          f" GiB; launches {json.dumps(c)}; diagnostics " + json.dumps(
              {k: float(v) for k, v in diag.items()
               if k.startswith(("iters", "chem"))}))
    check(all(bool(torch.isfinite(getattr(gas, k)).all())
              for k in ("T", "rho")), f"examples {name}: non-finite fields")
    return s, diag, c, ms


def _ex_submit(pool) -> dict:
    """Submit phase_examples' worker jobs: the float64 gates (card and CPU
    sides), the droplet's gate and the shock's own runs, the longest first
    (the detonation's CPU side, its driver cell's float64 drain, about 60
    s; the shock's runs)."""
    jobs = {("detonation_1d", "cpu"): pool.submit(_ex_gate_case,
                                                   "detonation_1d", "cpu")}
    jobs.update({("shock", dry): pool.submit(_ex_shock_anchor, dry)
                 for dry in (False, True)})
    jobs.update({(name, dev): pool.submit(_ex_gate_case, name, dev)
                 for name in EX_GATES for dev in ("cuda", "cpu")
                 if (name, dev) not in jobs})
    jobs.update({("droplet", dev): pool.submit(_ex_droplet_gate, dev)
                 for dev in ("cuda", "cpu")})
    return jobs


def _ex_gates(torch, jobs) -> None:
    """The results of _ex_submit's jobs: the float64 gates
    (_ex_check_gates), then the shock's runs: the dry speed within 3 % of
    the Rankine-Hugoniot EX_SHOCK_RH, the fog's printed beside it."""
    t0 = time.perf_counter()
    _ex_check_gates(torch, jobs)
    shock = {dry: jobs["shock", dry].result() for dry in (True, False)}
    print(f"examples gates and shock runs: waited {time.perf_counter() - t0:.1f}"
          f" s for the workers")
    for dry, (times, fronts, v, sec) in shock.items():
        label = "dry" if dry else "through the fog"
        print(f"examples shock {label}: 240 cells float32, 1,200 steps "
              f"to 2 ms in {sec:.1f} s; fronts (m) " + json.dumps(
                  [round(x, 4) for x in fronts]) + f"; speed over x in "
              f"(0.1, 1.0) m {v} m/s (Rankine-Hugoniot "
              f"{EX_SHOCK_RH:g} m/s)")
        check(v is not None, f"examples shock {label}: no speed fit")
    v_dry, v_fog = shock[True][2], shock[False][2]
    check(abs(v_dry - EX_SHOCK_RH) <= 0.03 * EX_SHOCK_RH,
          f"examples shock dry: {v_dry:.1f} m/s, not within 3 % of "
          f"{EX_SHOCK_RH:g}")
    # printed, not gated: the example expects the fog's shock to be
    # slower, but the evaporated vapour enters without its enthalpy of
    # formation (JAX's model, reproduced; ROADMAP section C), so
    # evaporation heats the gas and the shock speeds up
    print(f"examples shock: through the fog {v_fog:.1f} m/s against "
          f"{v_dry:.1f} dry ({'slower' if v_fog < v_dry else 'faster'}; "
          f"the example expects slower)")


def phase_examples(torch, K, gated: bool = False):
    """The examples' own families (module docstring, phase 17): the float64
    gates, card against CPU, and the shock's own runs, each in a worker
    side by side (_ex_submit, _ex_gates; with `gated` the caller has run
    them already, beside another phase's gates); then each family at its
    example's mesh and options, 1 warm-up and EX_STEPS timed steps (the
    TGV EX_TGV_STEPS through run_case), with the launch counts set to 0
    just before the timed steps and read just after; the droplet against
    its reference integration; the kernels at these paths' shapes in a
    fresh worker. Returns ({path: launch counts}, {kernel: rows}, {path:
    ms per step})."""
    with _pool(1) as rows_pool:
        rows_pool.submit(_worker_ready)
        if not gated:
            with _pool(EX_WORKERS) as pool:
                _ex_gates(torch, _ex_submit(pool))
        counts, ms, lanes = _ex_paths(torch, K)
        rows = rows_pool.submit(_ex_rows_fresh, lanes).result()
    for kernel, krows in rows.items():
        for row in krows:
            print(f"{kernel} ({row['path']}): " + json.dumps(row))
    return counts, rows, ms


def _ex_paths(torch, K):
    """phase_examples' timed runs. Returns ({path: launch counts}, {path:
    ms per step}, {(n, lanes, dtype): the paths whose drains launched
    gj_inverse at that width})."""
    import tempfile
    import numpy as np
    from deepflame_torch import cases
    from deepflame_torch.runtime.driver import run_case
    from deepflame_torch.utils.flame_speed import flame_position

    counts, ms, lanes = {}, {}, {}
    f32, f64 = torch.float32, torch.float64
    need = ("stencil7_apply", "helmholtz7_apply", "gj_inverse")

    def drains(spy, path, dtype):
        for (_, dt_name, (n, L)), c in spy.table().get("gj_inverse",
                                                        {}).items():
            lanes.setdefault((int(n), int(L), dt_name), set()).add(path)

    # A16: float64, the example's default; one float32 step beside it (in
    # float32, at rtol 1e-4, the RK23 fast tier accepts every lane at this
    # dt, so no implicit trip launches gj_inverse)
    solver, s, dt, info = _ex_build("flame_1d", "cuda", f32)
    _, _, counts["ex-flame_1d-f32"], ms["ex-flame_1d-f32"] = _ex_timed(
        torch, K, "flame_1d 256 cells float32", solver, s, dt, 1)
    solver, s, dt, info = _ex_build("flame_1d", "cuda", f64)
    spy = _LaunchArgs(K)
    s, diag, c, ms["ex-flame_1d"] = _ex_timed(torch, K, "flame_1d 256 cells "
                                              "float64", solver, s, dt,
                                              EX_STEPS["flame_1d"], spy)
    drains(spy, "flame_1d", f64)
    counts["ex-flame_1d"] = c
    T = s.T.reshape(-1).cpu().numpy()
    print(f"examples flame_1d after {1 + EX_STEPS['flame_1d']} steps of "
          f"{dt:.6e} s: front {flame_position(info['x'], T) * 1e3:.4f} mm, "
          f"T_max {T.max():.2f} K (S_L needs about 400 steps: not fitted)")
    check(all(c[k] > 0 for k in need), f"examples flame_1d: a kernel of "
          f"the path did not launch: {c}")
    del solver, s

    # A17 through run_case, its function objects writing every step
    with tempfile.TemporaryDirectory() as tmp:
        solver, s0, fos, control = cases.reacting_tgv_2d(
            MECH, dtype=f32, device="cuda", out_dir=tmp)
        dt = control.delta_t
        t0 = time.perf_counter()
        solver.step(s0, dt)                               # warm-up
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        rec = _Recorder(solver)
        ctrl = dataclasses.replace(control, end_time=EX_TGV_STEPS * dt,
                                   write_interval=dt)
        spy = _LaunchArgs(K)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        with spy:
            s = run_case(rec, s0, ctrl, function_objects=fos,
                         fields_fn=cases.tgv_fields, log_every=EX_TGV_STEPS)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = dict(K.launches)
        files = _files(tmp)
    drains(spy, "reacting_tgv_2d", f32)
    counts["ex-reacting_tgv_2d"] = c
    ms["ex-reacting_tgv_2d"] = wall / EX_TGV_STEPS * 1e3
    cells = s.T.numel()
    print(f"examples reacting_tgv_2d {s.T.shape[0]} x {s.T.shape[1]} "
          f"float32 through run_case: "
          f"warm-up {warm:.3f} s, {ms['ex-reacting_tgv_2d']:.2f} ms/step "
          f"over {EX_TGV_STEPS} steps with a write each, "
          f"{cells / (wall / EX_TGV_STEPS):.4e} cell-updates/s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
          f"{json.dumps(c)}; iterations " + json.dumps(
              [{k: int(v) for k, v in d.items() if k.startswith("iters")}
               for d in rec.diags]) + f"; T [{float(s.T.min()):.1f}, "
          f"{float(s.T.max()):.1f}] K; files " + json.dumps(
              {k: list(v.shape) for k, v in files.items()}))
    check(all(c[k] > 0 for k in need), f"examples reacting_tgv_2d: a "
          f"kernel of the path did not launch: {c}")
    mm = files[os.path.join("fieldMinMax", "fieldMinMax.dat")]
    lines = [v for k, v in files.items() if k.startswith("sample")]
    n, L = s.T.shape[0], 2.0 * math.pi * 1e-3
    check(mm.shape == (EX_TGV_STEPS, 17) and len(lines) == EX_TGV_STEPS
          and all(v.shape == (n, 2) for v in lines),
          "examples reacting_tgv_2d: not one row or line a write")
    check(all(bool(np.isfinite(v).all()) for v in [mm] + lines),
          "examples reacting_tgv_2d: non-finite function-object output")
    check(all(np.allclose(v[:, 0], (np.arange(n) + 0.5) * L / n,
                          rtol=1e-12) for v in lines),
          "examples reacting_tgv_2d: line coordinates are not the centres")
    del solver, s, s0

    # A18, float64 as the example forces
    solver, s, dt, info = _ex_build("jet_flame_2d", "cuda", f64)
    spy = _LaunchArgs(K)
    s, diag, c, ms["ex-jet_flame_2d"] = _ex_timed(
        torch, K, "jet_flame_2d 96 x 24 EDC float64", solver, s, dt,
        EX_STEPS["jet_flame_2d"], spy)
    drains(spy, "jet_flame_2d", f64)
    counts["ex-jet_flame_2d"] = c
    print(f"examples jet_flame_2d: T [{float(s.T.min()):.1f}, "
          f"{float(s.T.max()):.1f}] K, Y_H2 max "
          f"{float(s.Y[info['h2_index']].max()):.4f}, k max "
          f"{float(s.turb[0].max()):.2f}")
    check(all(c[k] > 0 for k in need), f"examples jet_flame_2d: a kernel "
          f"of the path did not launch: {c}")
    del solver, s

    # A19, float32
    solver, s, dt, info = _ex_build("detonation_1d", "cuda", f32)
    spy = _LaunchArgs(K)
    s, diag, c, ms["ex-detonation_1d"] = _ex_timed(
        torch, K, "detonation_1d 625 cells float32", solver, s, dt,
        EX_STEPS["detonation_1d"], spy)
    drains(spy, "detonation_1d", f32)
    counts["ex-detonation_1d"] = c
    fr = cases.detonation_front(solver, s, info["x"], info["h2_index"])
    print(f"examples detonation_1d after {1 + EX_STEPS['detonation_1d']} "
          f"steps of {dt:.6e} s: front {fr['x_front'] * 1e3:.2f} mm, p_max "
          f"{fr['p_max'] / 1e3:.1f} kPa, T_max {fr['T_max']:.1f} K (the "
          f"speed needs about {info['n_steps']} steps: not fitted)")
    check(c["gj_inverse"] > 0, f"examples detonation_1d: gj_inverse did "
          f"not launch: {c}")
    del solver, s

    # A20, float32, dry and through the fog: no kernel on the path
    for name in ("shock_dry", "shock_fog"):
        solver, s, dt, info = _ex_build(name, "cuda", f32,
                                        dry=name == "shock_dry")
        s, diag, c, ms["ex-" + name] = _ex_timed(
            torch, K, f"{name} 240 cells float32", solver, s, dt,
            EX_STEPS[name])
        counts["ex-" + name] = c
        check(all(v == 0 for v in c.values()), f"examples {name}: a kernel "
              f"launched: {c}")

    # A21: the example's three runs whole, float64, against the reference
    worst, n_steps = 0.0, 0
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    results = []
    for d_um, t_end in cases.DROPLET_RUNS:
        u, _ = cases.droplet_relaxation(d_um * 1e-6, t_end, device="cuda")
        results.append((d_um, t_end, u))
        n_steps += u.numel()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = dict(K.launches)
    counts["ex-droplet"] = c
    ms["ex-droplet"] = wall / n_steps * 1e3
    for d_um, t_end, u in results:
        _, ref = cases.droplet_reference(d_um * 1e-6, t_end)
        err = abs(float(u[-1]) - ref[-1]) / abs(ref[-1])
        worst = max(worst, err)
        print(f"examples droplet {d_um} um, t_end {t_end:g} s, {u.numel()} "
              f"steps: u_p {float(u[-1]):.4f} m/s, reference {ref[-1]:.4f},"
              f" relative error {err:.3e}")
    print(f"examples droplet: {ms['ex-droplet']:.3f} ms a parcel step over "
          f"{n_steps} steps, float64; worst relative error {worst:.3e} "
          f"(the example's limit 2e-2); launches {json.dumps(c)}")
    check(worst < 0.02, f"examples droplet: {worst:.3e} from the reference")
    check(all(v == 0 for v in c.values()), f"examples droplet: a kernel "
          f"launched: {c}")
    return counts, ms, lanes


def _ex_rows_fresh(lanes) -> dict:
    """In the fresh worker of phase_examples: each kernel against its plain
    version at the examples' shapes: stencil7_apply with 9 lanes (the
    species solve) of 256 x 1 x 1 and 96 x 24 x 1 (open boundaries) and
    64 x 64 x 1 (periodic), float32; helmholtz7_apply_bc on those meshes
    with their pressure BCs (every side zeroGradient; cyclic; zeroGradient
    but a fixedValue outlet), float32; gj_inverse at the smallest and the
    largest drain each dtype's timed steps launched it at (`lanes`:
    {(n, L, dtype): paths})."""
    torch = _worker_torch()
    from deepflame_torch.mesh import cyclic, empty, fixed_value, zero_gradient
    from deepflame_torch.ops import kernels as K
    g = torch.Generator(device="cuda").manual_seed(17)
    zg, e = zero_gradient(), (empty(), empty())
    L2 = 2.0 * math.pi * 1e-3
    meshes = (
        ("flame_1d", (256, 1, 1), (0.012 / 256,) * 3, True,
         ((zg, zg), e, e), "every side zeroGradient, empty y, z"),
        ("reacting_tgv_2d", (64, 64, 1), (L2 / 64,) * 3, False,
         ((cyclic(), cyclic()), (cyclic(), cyclic()), e), "cyclic, empty z"),
        ("jet_flame_2d", (96, 24, 1), (0.08 / 96, 0.02 / 24, 0.02 / 24), True,
         ((zg, fixed_value(101325.0)), (zg, zg), e),
         "zeroGradient, fixedValue outlet, empty z"))
    rows = {"stencil7_apply": [], "helmholtz7_apply": [], "gj_inverse": []}
    for path, shape, spacing, open_b, bcs, label in meshes:
        row = _stencil_row(torch, K, g, (9,) + shape, open_b)
        row["path"] = f"examples {path}"
        rows["stencil7_apply"].append(row)
        row = _helmholtz_bc_row(torch, K, _helmholtz_bc_sets(
            torch, g, shape, spacing, bcs), label)
        row["path"] = f"examples {path}"
        rows["helmholtz7_apply"].append(row)
    for dt_name in ("float32", "float64"):
        mine = sorted((L, n, ps) for (n, L, d), ps in lanes.items()
                      if d == dt_name)
        for L, n, ps in (mine[:1] + mine[-1:] if len(mine) > 1 else mine):
            row = _gj_row(torch, K, g, n, L, getattr(torch, dt_name))
            row["path"] = "examples " + ", ".join(sorted(ps))
            rows["gj_inverse"].append(row)
    return rows



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="FILE",
                    help="profile one extra step of each main path (the DNN "
                         "path always is); write the device-time tables to "
                         "FILE with _stiff, _dnn, _fl and _sjet before its "
                         "extension")
    ap.add_argument("--phases", metavar="LIST",
                    help="run only these of tci, sjet-pasr, sjet-edc, "
                         "light, hs, amr, fgm, spray, mist, fljet, hsfl, "
                         "fgmfl, sprayfl, dist, dnnloop and examples "
                         "(comma-separated; "
                         "light needs tci and sjet-pasr; spray and mist run "
                         "their gates first) after the build, and end "
                         "without the result lines")
    args = ap.parse_args()

    t_start = time.perf_counter()
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
        for fn, regs, stack, stores, loads in K.ptxas_report(log):
            print(f"  {name}: {fn}: {regs} registers, {stack} bytes of "
                  f"stack, {stores} bytes of spill stores, {loads} of "
                  f"spill loads")

    seconds, t_phase = {}, time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        seconds[name] = round(now - t_phase, 1)
        t_phase = now

    if args.phases:
        only = args.phases.split(",")
        if "tci" in only:
            tci = phase_tci(torch, K)
            phase_done("tci")
        if "sjet-pasr" in only:
            _, _, solver, state = phase_sjet_pasr(torch, K)
            phase_done("sjet-pasr")
        if "sjet-edc" in only:
            phase_sjet_edc(torch, K)
            phase_done("sjet-edc")
        if "light" in only:
            phase_light(torch, K, state, solver, tci["PaSR"])
            phase_done("light")
        if "hs" in only:
            phase_hs(torch, K)
            phase_done("hs")
        if "amr" in only:
            phase_amr(torch, K)
            phase_done("amr")
        if "fgm" in only:
            phase_fgm(torch, K)
            phase_done("fgm")
        if "spray" in only or "mist" in only:
            spray_gates(torch)
            phase_done("spray-gates")
        if "spray" in only:
            phase_spray(torch, K)
            phase_done("spray")
        if "mist" in only:
            phase_mist(torch, K)
            phase_done("mist")
        if "fljet" in only:
            phase_fljet(torch, K)
            phase_done("fljet")
        if "hsfl" in only:
            phase_hsfl(torch, K)
            phase_done("hsfl")
        if "fgmfl" in only:
            phase_fgmfl(torch, K)
            phase_done("fgmfl")
        if "sprayfl" in only:
            phase_sprayfl(torch, K, build_chamber(torch)[0])
            phase_done("sprayfl")
        if "dist" in only:
            phase_dist(torch, K)
            phase_done("dist")
        if "dnnloop" in only:
            phase_dnnloop(torch, K)
            phase_done("dnnloop")
        if "examples" in only:
            phase_examples(torch, K)
            phase_done("examples")
        print(f"chip_smoke: phases {only} only, {time.perf_counter() - t_start:.1f} s; by "
              f"phase {json.dumps(seconds)}")
        print(card)
        return 0

    jet = build_jet(torch, N_JET)
    chamber, chamber_conn = build_chamber(torch)
    phase_done("build")
    figures = phase_kernels(torch, K, jet[0].p_ell, chamber_conn)
    phase_done("kernels")
    # the tci gates' four workers run beside the reference's four (both
    # gates, nothing timed), checked before the main paths are timed
    with tempfile.TemporaryDirectory() as tci_tmp, _pool(4) as tci_pool:
        tci_runs = _tci_submit(tci_pool, tci_tmp)
        phase_reference(torch, K)
        phase_done("reference")
        tci = phase_tci(torch, K, tci_runs)
        phase_done("tci")
    counts, ms = {}, {}
    for path in ("stiff", "dnn"):
        counts[path], (_, _, ms[path], _) = phase_main(
            torch, K, path, N_MAIN, STEPS, args.profile)
        phase_done(path)
    counts["fl"], (_, _, ms["fl"], _) = phase_main(
        torch, K, "fl", N_JET, STEPS, args.profile, built=jet)
    del jet
    phase_done("fl")
    counts["sjet"], (solver, state, ms["sjet"], diag) = phase_main(
        torch, K, "sjet", N_JET, STEPS, args.profile,
        built=build_sjet(torch, N_JET))
    phase_sjet_mg(torch, K, solver, state, ms["sjet"], diag, counts["sjet"])
    del solver, state
    phase_done("sjet")
    print(f"jet, {2 * N_JET} x {N_JET} x {N_JET} cells, float32, dt "
          f"{JET_DT:g} s: structured {ms['sjet']:.2f} ms/step, face-list "
          f"{ms['fl']:.2f} ms/step")
    phase_runtime(torch, K, N_RUNTIME)
    phase_done("runtime")
    counts["sjet-pasr"], ms["sjet-pasr"], solver, state = phase_sjet_pasr(
        torch, K)
    phase_done("sjet-pasr")
    counts["sjet-edc"], ms["sjet-edc"] = phase_sjet_edc(torch, K)
    phase_done("sjet-edc")
    phase_light(torch, K, state, solver, tci["PaSR"])
    del solver, state, tci
    phase_done("light")
    # the gates of hs, amr and fgm and the aachenBomb gate's card side in
    # one window of workers (nothing timed), all done before hs is timed;
    # each phase checks its own
    with _pool(8) as pool:
        gates = dict(hs=_hs_submit(pool), amr=_amr_submit(pool),
                     fgm=_fgm_submit(pool),
                     spray_card=pool.submit(_spray_gate_case, "cuda"))
    phase_done("hs-amr-fgm-gates")
    counts["hs"], ms["hs"] = phase_hs(torch, K, gates["hs"])
    phase_done("hs")
    amr_counts, amr_ms, amr_gj = phase_amr(torch, K, gates["amr"])
    counts.update(amr_counts)
    ms.update(amr_ms)
    figures["gj_inverse"]["path_shapes"] += amr_gj
    phase_done("amr")
    counts["fgm"], ms["fgm"] = phase_fgm(torch, K, gates["fgm"])
    phase_done("fgm")
    # the examples' gates and shock runs beside the spray gates (both
    # workers only, nothing timed), done before the spray path is timed
    with _pool(EX_WORKERS) as ex_pool:
        ex_jobs = _ex_submit(ex_pool)
        spray_gates(torch, gates["spray_card"])
        phase_done("spray-gates")
        _ex_gates(torch, ex_jobs)
        phase_done("examples-gates")
    counts["spray"], ms["spray"] = phase_spray(torch, K)
    phase_done("spray")
    counts["mist"], ms["mist"] = phase_mist(torch, K)
    phase_done("mist")
    # the gates of fljet, hsfl and fgmfl in one window, likewise
    with _pool(8) as pool:
        gates = dict(fljet=_fljet_submit(pool), hsfl=_hsfl_submit(pool),
                     fgmfl=_fgmfl_submit(pool))
    phase_done("fl-gates")
    counts["fljet"], ms["fljet"] = phase_fljet(torch, K, gates["fljet"])
    phase_done("fljet")
    counts["hsfl"], ms["hsfl"] = phase_hsfl(torch, K, gates["hsfl"])
    phase_done("hsfl")
    counts["fgmfl"], ms["fgmfl"] = phase_fgmfl(torch, K, gates["fgmfl"])
    phase_done("fgmfl")
    counts["sprayfl"], ms["sprayfl"] = phase_sprayfl(torch, K, chamber)
    phase_done("sprayfl")
    dist_counts, dist_rows = phase_dist(torch, K)
    counts.update(dist_counts)
    figures["helmholtz7_apply"]["dist_shapes"] = dist_rows["helmholtz"]
    figures["ell_matvec"]["dist_shape"] = dist_rows["ell"]
    figures["gj_inverse"]["path_shapes"] += dist_rows["gj"]
    phase_done("dist")
    dnn_counts, dnn_rows, dnn_ms = phase_dnnloop(torch, K)
    counts.update(dnn_counts)
    ms.update(dnn_ms)
    figures["mlp_fused"]["dnnloop_shapes"] = dnn_rows["mlp_fused"]
    figures["stencil7_apply"]["dnnloop_shapes"] = dnn_rows["stencil7_apply"]
    figures["helmholtz7_apply"]["dnnloop_shape"] = dnn_rows[
        "helmholtz7_apply"][0]
    figures["gj_inverse"]["path_shapes"] += dnn_rows["gj_inverse"]
    phase_done("dnnloop")
    ex_counts, ex_rows, ex_ms = phase_examples(torch, K, gated=True)
    counts.update(ex_counts)
    ms.update(ex_ms)
    figures["stencil7_apply"]["examples_shapes"] = ex_rows["stencil7_apply"]
    figures["helmholtz7_apply"]["examples_shapes"] = ex_rows[
        "helmholtz7_apply"]
    figures["gj_inverse"]["path_shapes"] += ex_rows["gj_inverse"]
    phase_done("examples")

    # each kernel's launches on its own path, and on every path
    own = lambda name: {"mlp_fused": "dnn", "ell_matvec": "fl"}.get(name,
                                                                    "stiff")
    kernels = [dict(name=name, launches=counts[own(name)][name],
                    launches_by_path={p: c[name] for p, c in counts.items()},
                    **f)
               for name, f in figures.items()]
    for k in kernels:
        k["kernel_ms"] = k["ms"]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all; by "
          f"phase {json.dumps(seconds)}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
