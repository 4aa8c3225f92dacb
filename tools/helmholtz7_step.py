"""The structured jet's pressure correctors with the Helmholtz kernel's two
matvecs, in one process.

    python3 tools/helmholtz7_step.py [--steps N]

From the root of the repository, on a machine with one CUDA card and nvcc.
Builds chip_smoke.py's structured jet (128 x 64 x 64, float32, Jacobi
pressure preconditioning), takes one warm-up step, then steps the same
state in turns old, new, new, old (N steps a turn): "new" is the solver as
it is, whose pressure CG calls the BC form (ghosts computed in the kernel);
"old" forces the padded form after pad_field, as before, by giving the
solver no ghost rule (deepflame_torch.solvers.low_mach.ghost_rule patched to
return None). For each step it prints one JSON line: the step's wall ms,
the wall ms of the pressure correctors inside it (LowMachSolver.
_pressure_loop, synchronised before and after), the pressure-CG
iterations and the Helmholtz launches. The two matvecs must give the same
pressure iterations. It never imports JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1, help="steps a turn")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("helmholtz7_step: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import deepflame_torch.solvers.low_mach as low_mach
    from deepflame_torch.ops import kernels as K
    from deepflame_torch.solvers import LowMachSolver

    print(cs.card_line())
    K.build()
    solver, state = cs.build_sjet(torch, cs.N_JET)
    solver.step(state, cs.JET_DT)                      # warm-up
    rule = low_mach.ghost_rule
    iters = {}
    try:
        for turn in ("old", "new", "new", "old"):
            low_mach.ghost_rule = ((lambda bcs, mesh: None) if turn == "old"
                                   else rule)
            for _ in range(args.steps):
                K.reset_launches()
                total, spent = cs._timed_inside(
                    torch, LowMachSolver, "_pressure_loop",
                    lambda: iters.__setitem__(
                        "diag", solver.step(state, cs.JET_DT)[1]))
                it = int(iters["diag"]["iters_p"])
                iters.setdefault(turn, set()).add(it)
                print(json.dumps(dict(
                    matvec=turn, step_ms=total * 1e3,
                    pressure_ms=sum(spent) * 1e3, iters_p=it,
                    helmholtz_launches=K.launches["helmholtz7_apply"])))
    finally:
        low_mach.ghost_rule = rule
    cs.check(iters["old"] == iters["new"], "the two matvecs took different "
                                           "pressure iterations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
