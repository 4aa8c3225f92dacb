"""Case driver: the solver `main()` time loop as a reusable harness.

Port of deepflame_tpu/runtime/driver.py (the reference solver mains: a
Courant-adjusted dt, one PIMPLE step per trip, a checkpoint every write
interval, step logs) with the `splittingStrategy` chemistry mode (chemistry
every second step with twice the dt, as a fractional step). Eager: each
step is the solver's own `step`.
"""
from __future__ import annotations

import dataclasses
import math
import time as _time
from typing import Callable

from .checkpoint import latest_time, load_meta, load_state, save_state
from .config import ControlDict

__all__ = ["run_case"]


def run_case(solver, state, control: ControlDict,
             function_objects=None,
             checkpoint_dir: str | None = None,
             splitting: bool = False,
             fields_fn: Callable | None = None,
             log_every: int = 10,
             courant_fn: Callable | None = None,
             restart: bool = False):
    """Run the time loop to control.end_time and return the final state.

    solver.step(state, dt) -> (state, diag). function_objects is any object
    with __call__(t, fields) and write(); fields_fn(state) -> dict feeds it.
    courant_fn(state, dt) -> Co enables the adjustable dt (controlDict
    adjustTimeStep). restart=True resumes from the latest checkpoint in
    checkpoint_dir: state, time, the settled dt and the write schedule
    continue where the previous run stopped."""
    dt = control.delta_t
    t = float(state.time)
    if restart:
        if checkpoint_dir is None or latest_time(checkpoint_dir) is None:
            print("restart requested but no checkpoint found; cold start")
        else:
            state = load_state(checkpoint_dir, state)
            meta = load_meta(checkpoint_dir)
            dt = float(meta.get("dt", dt))
            # the loop's own clock at the write, not the state's time: a
            # float32 state's time is off by its rounding, which would add a
            # step at the end and shift the write schedule (the JAX driver
            # resumes from state.time)
            t = float(meta["time"])
            print(f"restarting from t={t:.6e} (dt={dt:.3e})")
    # align the write schedule to the global grid (restart lands mid-grid)
    n_written = int(math.floor(t / control.write_interval + 1e-9))
    next_write = (n_written + 1) * control.write_interval
    step_on = step_off = solver.step
    if splitting:
        # chemistry every 2nd step with 2x dt (fractional-step splitting)
        step_off = dataclasses.replace(solver, config=dataclasses.replace(
            solver.config, chemistry=False)).step
        step_on = dataclasses.replace(solver, config=dataclasses.replace(
            solver.config, chemistry_dt_scale=2.0)).step
    i = 0
    t_wall = _time.perf_counter()
    while t < control.end_time - 1e-15:
        if control.adjust_time_step and courant_fn is not None:
            co = float(courant_fn(state, dt))
            if co > 0:
                dt = min(dt * min(control.max_courant / max(co, 1e-12), 1.2),
                         control.end_time - t)
        if splitting and i % 2 == 1:
            state, diag = step_off(state, dt)
        else:
            state, diag = step_on(state, dt)
        t += dt
        i += 1
        if i % log_every == 0:
            msg = f"t={t:.6e} dt={dt:.3e}"
            for k in ("T_min", "T_max", "continuity_err"):
                if k in diag:
                    msg += f" {k}={float(diag[k]):.6g}"
            print(msg, flush=True)
        if t >= next_write - 1e-15:
            if function_objects is not None and fields_fn is not None:
                function_objects(t, fields_fn(state))
            if checkpoint_dir is not None:
                save_state(checkpoint_dir, state, t, meta={"dt": dt})
            next_write += control.write_interval
    if function_objects is not None:
        function_objects.write()
    print(f"run complete: {i} steps, {_time.perf_counter() - t_wall:.1f}s wall")
    return state
