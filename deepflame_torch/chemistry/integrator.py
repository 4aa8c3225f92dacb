"""Batched stiff ODE integration for chemistry: adaptive Rosenbrock over lanes.

Port of deepflame_tpu/chemistry/integrator.py. Every lane (cell) carries its
own adaptive ode23s (or ROS4) controller; finished lanes freeze while the
batch drains. Two things change in the translation:

* The Jacobian: JAX linearises the batched right-hand side once and maps the
  linear map over the n basis vectors. Here `torch.func.vmap` maps
  `torch.func.jvp` over the same basis vectors: n forward-mode products in one
  batched pass, each giving one column of every lane's Jacobian.
* The loop: JAX's `lax.while_loop` (and the vmapped single-cell loop)
  tests "any lane still running" on the device every trip. Here the loop
  is Python and reads that flag back to the host only every `CHECK_EVERY`
  trips. The extra trips this allows are exact
  no-ops, because a finished lane's state, step and controller memory are
  only ever updated where the lane is active; and the trip count never
  passes `max_steps`, so the result is the JAX result.

The W = I - gamma dt J inverse goes through `ops.kernels.gj_inverse` (the
Gauss-Jordan kernel on the card, its plain version on the CPU).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.kernels import gj_inverse

__all__ = ["RosenbrockOptions", "rosenbrock_integrate",
           "rosenbrock_integrate_batched", "rk23_attempt_batched",
           "rosenbrock_attempt"]

# ode23s constants: d = 1/(2 + sqrt(2)), e32 = 6 + sqrt(2)
_ROS_D = 1.0 / (2.0 + 2.0**0.5)
_ROS_E32 = 6.0 + 2.0**0.5

# L-stable 4-stage order-4 Rosenbrock (ROS4) with an embedded order-3
# estimate (coefficients of deepflame_tpu/chemistry/integrator.py, derived by
# tools/derive_ros4.py)
_R4_G = 0.572816062482135
_R4_A21 = 0.5
_R4_A31 = -0.7361196555332076
_R4_A32 = 1.7361196555332077
_R4_G21 = -0.7278829824396041
_R4_G31 = -0.6385225800103846
_R4_G32 = -0.3124952497020243
_R4_G41 = 0.7179640104563134
_R4_G42 = 0.16039078642619697
_R4_G43 = -1.3190296151055532
_R4_B = (0.16666666665853, 0.6666666666766059,
         0.02765774684458492, 0.13900891982034194)
_R4_E = (-0.7499999999999577, 1.0,
         -0.7205237842112873, 0.47052378421121177)   # b - b_hat

# trips between host reads of "any lane still running"
CHECK_EVERY = 8

# relative residual above which a Gauss-Jordan solve is deemed bad and the
# step rejected outright (dt shrinks, W -> I, conditioning recovers)
_SOLVE_RES_MAX = 1e-3


class RosenbrockOptions(NamedTuple):
    rtol: float = 1e-6
    atol: float = 1e-12
    dt_init: float = 1e-8
    dt_min: float = 1e-14
    max_steps: int = 10_000
    safety: float = 0.9
    grow: float = 5.0
    shrink: float = 0.2
    order: int = 2          # 2 = ode23s, 4 = ROS4


def _jac_and_f(rhs_b: Callable, y):
    """(f(y), J(y)) for a batched right-hand side: y (L, n) -> (L, n),
    J (L, n, n), from n forward-mode products mapped over the basis."""
    L, n = y.shape
    basis = torch.eye(n, dtype=y.dtype, device=y.device)
    f0, J_cols = torch.func.vmap(
        lambda e: torch.func.jvp(rhs_b, (y,), (e.expand(L, n),)),
        out_dims=(None, 0))(basis)
    return f0, J_cols.permute(1, 2, 0)              # column i = J e_i


def _inverse_batched(W):
    """(L, n, n) -> lanes-last (n, n, L) inverses (kernel layout)."""
    return gj_inverse(W.permute(1, 2, 0).contiguous())


def rk23_attempt_batched(rhs_b: Callable, y, dt,
                         opts: RosenbrockOptions = RosenbrockOptions()):
    """ONE explicit Bogacki-Shampine 3(2) step over [0, dt] per lane: the
    cheap tier for non-stiff lanes. Returns (y_new, accepted, dt_suggestion);
    stiff lanes fail the embedded error test and fall through to the implicit
    tier. dt = 0 lanes return y unchanged, accepted."""
    dtv = dt[:, None]
    k1 = rhs_b(y)
    k2 = rhs_b(y + 0.5 * dtv * k1)
    k3 = rhs_b(y + 0.75 * dtv * k2)
    y3 = y + dtv * ((2.0 / 9.0) * k1 + (1.0 / 3.0) * k2 + (4.0 / 9.0) * k3)
    k4 = rhs_b(y3)
    err = dtv * ((-5.0 / 72.0) * k1 + (1.0 / 12.0) * k2
                 + (1.0 / 9.0) * k3 + (-1.0 / 8.0) * k4)
    scale = opts.atol + opts.rtol * torch.maximum(y.abs(), y3.abs())
    enorm = torch.clamp(torch.sqrt(((err / scale) ** 2).mean(1)), min=1e-30)
    accept = (enorm <= 1.0) & torch.isfinite(y3).all(1)
    factor = torch.clamp(opts.safety * enorm ** (-1.0 / 3.0),
                         opts.shrink, opts.grow)
    dt_sugg = torch.clamp(dt * factor, min=opts.dt_min)
    return y3, accept, dt_sugg


def rosenbrock_integrate_batched(rhs_b: Callable, y0, t_end,
                                 opts: RosenbrockOptions = RosenbrockOptions(),
                                 dt_start=None, return_nstep: bool = False):
    """Adaptive ode23s (or ROS4) over a lane batch.

    rhs_b: batched RHS (L, n) -> (L, n). y0: (L, n); t_end, dt_start: (L,).
    Returns (y_final (L, n), dt_suggestion (L,)); with return_nstep also the
    number of trips at whose start some lane was still running (the JAX
    loop's trip count), a 0-d int64 tensor counted on y0's device, which
    the trips run beyond it (up to CHECK_EVERY - 1) do not add to."""
    dtype = y0.dtype
    L, n = y0.shape
    eye = torch.eye(n, dtype=dtype, device=y0.device)
    p_est = 4.0 if opts.order == 4 else 3.0
    d_gamma = _R4_G if opts.order == 4 else _ROS_D
    t_stop = t_end * (1.0 - 1e-12)

    def body(y, t, dt, en_prev, rej):
        act = t < t_stop
        dt_c = torch.clamp(torch.minimum(dt, t_end - t), min=opts.dt_min)
        f0, jac = _jac_and_f(rhs_b, y)
        W = eye[None] - (dt_c[:, None, None] * d_gamma) * jac
        W_inv = _inverse_batched(W)                              # (n, n, L)
        solve = lambda b: torch.einsum("nml,lm->ln", W_inv, b)
        k1 = solve(f0)
        # accept-time guard on the unpivoted solve
        Wk1 = torch.einsum("lnm,lm->ln", W, k1)
        f0n = torch.sqrt((f0 * f0).mean(1))
        solve_ok = (torch.sqrt(((Wk1 - f0) ** 2).mean(1))
                    <= _SOLVE_RES_MAX * (f0n + 1e-300))
        if opts.order == 4:
            jv = lambda v: torch.einsum("lnm,lm->ln", jac, v)
            dtc = dt_c[:, None]
            F2 = rhs_b(y + dtc * (_R4_A21 * k1))
            k2 = solve(F2 + dtc * jv(_R4_G21 * k1))
            F3 = rhs_b(y + dtc * (_R4_A31 * k1 + _R4_A32 * k2))
            k3 = solve(F3 + dtc * jv(_R4_G31 * k1 + _R4_G32 * k2))
            k4 = solve(F3 + dtc * jv(_R4_G41 * k1 + _R4_G42 * k2
                                     + _R4_G43 * k3))
            y_new = y + dtc * (_R4_B[0] * k1 + _R4_B[1] * k2
                               + _R4_B[2] * k3 + _R4_B[3] * k4)
            err = dtc * (_R4_E[0] * k1 + _R4_E[1] * k2
                         + _R4_E[2] * k3 + _R4_E[3] * k4)
        else:
            f1 = rhs_b(y + (0.5 * dt_c)[:, None] * k1)
            k2 = solve(f1 - k1) + k1
            y_new = y + dt_c[:, None] * k2
            f2 = rhs_b(y_new)
            k3 = solve(f2 - _ROS_E32 * (k2 - f1) - 2.0 * (k1 - f0))
            err = (dt_c / 6.0)[:, None] * (k1 - 2.0 * k2 + k3)
        scale = opts.atol + opts.rtol * torch.maximum(y.abs(), y_new.abs())
        enorm = torch.clamp(torch.sqrt(((err / scale) ** 2).mean(1)), min=1e-30)
        accept = (enorm <= 1.0) & torch.isfinite(y_new).all(1) & solve_ok & act
        # PI (Gustafsson) controller, never growing right after a rejection
        pi_fac = (opts.safety * enorm ** (-0.7 / p_est)
                  * en_prev ** (0.4 / p_est))
        i_fac = opts.safety * enorm ** (-1.0 / p_est)
        factor = torch.where(accept, pi_fac, torch.clamp(i_fac, max=1.0))
        factor = torch.clamp(factor, opts.shrink, opts.grow)
        factor = torch.where(rej, torch.clamp(factor, max=1.0), factor)
        # a bad solve also poisons the error estimate: force shrink
        factor = torch.where(solve_ok, factor,
                             torch.full_like(factor, opts.shrink))
        dt_next = torch.clamp(dt_c * factor, min=opts.dt_min)
        dt = torch.where(act, dt_next, dt)
        en_prev = torch.where(accept, enorm, en_prev)
        rej = torch.where(act, ~accept & solve_ok, rej)
        y = torch.where(accept[:, None], y_new, y)
        t = torch.where(accept, t + dt_c, t)
        return y, t, dt, en_prev, rej

    y = y0
    t = torch.zeros(L, dtype=dtype, device=y0.device)
    if dt_start is None:
        dt = torch.minimum(torch.full((L,), opts.dt_init, dtype=dtype,
                                      device=y0.device), t_end)
    else:
        dt = torch.clamp(torch.as_tensor(dt_start, dtype=dtype,
                                         device=y0.device), min=opts.dt_min)
    en_prev = torch.ones(L, dtype=dtype, device=y0.device)
    rej = torch.zeros(L, dtype=torch.bool, device=y0.device)
    nstep = 0
    n_run = (torch.zeros((), dtype=torch.int64, device=y0.device)
             if return_nstep else None)
    while nstep < opts.max_steps and bool((t < t_stop).any()):
        for _ in range(min(CHECK_EVERY, opts.max_steps - nstep)):
            if return_nstep:
                n_run += (t < t_stop).any()
            y, t, dt, en_prev, rej = body(y, t, dt, en_prev, rej)
            nstep += 1
    return (y, dt, n_run) if return_nstep else (y, dt)


def _step(rhs_b: Callable, y, dt, eye):
    """One ode23s step of every lane over dt (L,), as the JAX package's
    single-cell `_step`: (y_new, error vector, relative residual
    ||W k1 - f0|| / ||f0|| of the Gauss-Jordan solve)."""
    f0, jac = _jac_and_f(rhs_b, y)
    W = eye[None] - (dt * _ROS_D)[:, None, None] * jac
    W_inv = _inverse_batched(W)                                  # (n, n, L)
    solve = lambda b: torch.einsum("nml,lm->ln", W_inv, b)
    k1 = solve(f0)
    f0n = torch.sqrt((f0 * f0).mean(1))
    solve_res = torch.sqrt(((torch.einsum("lnm,lm->ln", W, k1) - f0)
                            ** 2).mean(1)) / (f0n + 1e-300)
    f1 = rhs_b(y + (0.5 * dt)[:, None] * k1)
    k2 = solve(f1 - k1) + k1
    y_new = y + dt[:, None] * k2
    f2 = rhs_b(y_new)
    k3 = solve(f2 - _ROS_E32 * (k2 - f1) - 2.0 * (k1 - f0))
    err = (dt / 6.0)[:, None] * (k1 - 2.0 * k2 + k3)
    return y_new, err, solve_res


def rosenbrock_attempt(rhs_b: Callable, y, dt,
                       opts: RosenbrockOptions = RosenbrockOptions()):
    """ONE error-controlled ode23s step over [0, dt] per lane: what
    `jax.vmap(rosenbrock_attempt)` computes, lane for lane.

    rhs_b: batched RHS (L, n) -> (L, n); y: (L, n); dt: (L,). Returns
    (y_new, accepted, dt_suggestion): y_new is the attempt's result whether
    or not the lane passed the embedded error test and the solve's residual
    guard (`accepted`), as in the JAX package; dt_suggestion is
    max(dt clip(safety enorm^(-1/3), shrink, grow), dt_min). dt = 0 lanes
    return y, accepted. The W inverse is one `gj_inverse` launch."""
    eye = torch.eye(y.shape[1], dtype=y.dtype, device=y.device)
    y_new, err, solve_res = _step(rhs_b, y, dt, eye)
    scale = opts.atol + opts.rtol * torch.maximum(y.abs(), y_new.abs())
    enorm = torch.clamp(torch.sqrt(((err / scale) ** 2).mean(1)), min=1e-30)
    accept = ((enorm <= 1.0) & torch.isfinite(y_new).all(1)
              & (solve_res <= _SOLVE_RES_MAX))
    factor = torch.clamp(opts.safety * enorm ** (-1.0 / 3.0),
                         opts.shrink, opts.grow)
    dt_sugg = torch.clamp(dt * factor, min=opts.dt_min)
    return y_new, accept, dt_sugg


def rosenbrock_integrate(rhs_b: Callable, y0, t_end,
                         opts: RosenbrockOptions = RosenbrockOptions(),
                         dt_start=None, return_dt: bool = False,
                         return_nstep: bool = False):
    """The JAX single-cell integrator mapped over a lane batch: what
    `jax.vmap(rosenbrock_integrate)` computes, lane for lane.

    ode23s with the plain integral controller: factor = clip(safety
    enorm^(-1/3), shrink, grow), `shrink` after a bad solve, no explicit
    tier and no PI memory; the next step is set whether or not the step
    was accepted. A lane runs while t < t_end (1 - 1e-12) and it has taken
    fewer than `max_steps` trips, both in the state's dtype; a frozen lane
    keeps y, t, dt and its trip count. The W inverse of every lane is one
    `gj_inverse` launch a trip on the lanes-last layout.

    rhs_b: batched RHS (L, n) -> (L, n). y0: (L, n); t_end: (L,);
    dt_start: optional (L,) warm-start step (clipped below at dt_min),
    else min(dt_init, t_end). Returns y (L, n); with return_dt also the
    controller's next step (L,); with return_nstep also each lane's trip
    count (L,) int64 (the largest is the trips the JAX loop runs)."""
    dtype, dev = y0.dtype, y0.device
    L, n = y0.shape
    eye = torch.eye(n, dtype=dtype, device=dev)
    t_end = torch.as_tensor(t_end, dtype=dtype, device=dev).expand(L)
    t_stop = t_end * (1.0 - 1e-12)
    y = y0
    t = torch.zeros(L, dtype=dtype, device=dev)
    if dt_start is None:
        dt = torch.minimum(torch.full((L,), opts.dt_init, dtype=dtype,
                                      device=dev), t_end)
    else:
        dt = torch.clamp(torch.as_tensor(dt_start, dtype=dtype, device=dev),
                         min=opts.dt_min).expand(L)
    nstep = torch.zeros(L, dtype=torch.int64, device=dev)
    dt_min = torch.tensor(opts.dt_min, dtype=dtype, device=dev)

    def body(y, t, dt, nstep):
        act = (t < t_stop) & (nstep < opts.max_steps)
        dt_c = torch.minimum(dt, t_end - t)
        y_new, err, solve_res = _step(rhs_b, y, dt_c, eye)
        scale = opts.atol + opts.rtol * torch.maximum(y.abs(), y_new.abs())
        enorm = torch.clamp(torch.sqrt(((err / scale) ** 2).mean(1)),
                            min=1e-30)
        solve_ok = solve_res <= _SOLVE_RES_MAX
        accept = (enorm <= 1.0) & torch.isfinite(y_new).all(1) & solve_ok
        factor = torch.clamp(opts.safety * enorm ** (-1.0 / 3.0),
                             opts.shrink, opts.grow)
        factor = torch.where(solve_ok, factor,
                             torch.full_like(factor, opts.shrink))
        dt_next = torch.maximum(dt_c * factor, dt_min)
        take = act & accept
        y = torch.where(take[:, None], y_new, y)
        t = torch.where(take, t + dt_c, t)
        return (y, t, torch.where(act, dt_next, dt),
                torch.where(act, nstep + 1, nstep))

    trips = 0
    while trips < opts.max_steps and bool(((t < t_stop)
                                           & (nstep < opts.max_steps)).any()):
        for _ in range(min(CHECK_EVERY, opts.max_steps - trips)):
            y, t, dt, nstep = body(y, t, dt, nstep)
            trips += 1
    out = (y,)
    if return_dt:
        out += (dt,)
    if return_nstep:
        out += (nstep,)
    return out if len(out) > 1 else y
