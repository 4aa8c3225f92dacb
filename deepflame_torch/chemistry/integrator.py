"""Batched stiff ODE integration for chemistry: adaptive Rosenbrock over lanes.

Port of deepflame_tpu/chemistry/integrator.py. Every lane (cell) carries its
own adaptive ode23s (or ROS4) controller; finished lanes freeze while the
batch drains. Two things change in the translation:

* The Jacobian: JAX linearises the batched right-hand side once and maps the
  linear map over the n basis vectors. Here `torch.func.vmap` maps
  `torch.func.jvp` over the same basis vectors: n forward-mode products in one
  batched pass, each giving one column of every lane's Jacobian.
* The loop: JAX's `lax.while_loop` tests "any lane still running" on the
  device every trip. Here the loop is Python and reads that flag back to the
  host only every `CHECK_EVERY` trips. The extra trips this allows are exact
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
           "rosenbrock_integrate_batched", "rk23_attempt_batched"]

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


def rosenbrock_integrate(rhs: Callable, y0, t_end,
                         opts: RosenbrockOptions = RosenbrockOptions()):
    """Integrate dy/dt = rhs(y) from 0 to t_end for ONE cell (the 0D reactor):
    ode23s with the plain integral controller of the JAX single-cell
    integrator. y0: (n,); t_end: float."""
    dtype = y0.dtype
    n = y0.shape[-1]
    eye = torch.eye(n, dtype=dtype, device=y0.device)
    t_stop = t_end * (1.0 - 1e-12)
    y, t, dt = y0, 0.0, min(opts.dt_init, t_end)
    for _ in range(opts.max_steps):
        if not t < t_stop:
            break
        dt = min(dt, t_end - t)
        f0, J_cols = torch.func.vmap(
            lambda e: torch.func.jvp(rhs, (y,), (e,)), out_dims=(None, 0))(eye)
        jac = J_cols.T
        W = eye - (dt * _ROS_D) * jac
        W_inv = gj_inverse(W[:, :, None].contiguous())[:, :, 0]
        k1 = W_inv @ f0
        f0n = torch.sqrt((f0 * f0).mean())
        solve_res = torch.sqrt(((W @ k1 - f0) ** 2).mean()) / (f0n + 1e-300)
        f1 = rhs(y + 0.5 * dt * k1)
        k2 = W_inv @ (f1 - k1) + k1
        y_new = y + dt * k2
        f2 = rhs(y_new)
        k3 = W_inv @ (f2 - _ROS_E32 * (k2 - f1) - 2.0 * (k1 - f0))
        err = (dt / 6.0) * (k1 - 2.0 * k2 + k3)
        scale = opts.atol + opts.rtol * torch.maximum(y.abs(), y_new.abs())
        enorm = max(float(torch.sqrt(((err / scale) ** 2).mean())), 1e-30)
        solve_ok = float(solve_res) <= _SOLVE_RES_MAX
        accept = (enorm <= 1.0 and bool(torch.isfinite(y_new).all())
                  and solve_ok)
        factor = min(max(opts.safety * enorm ** (-1.0 / 3.0), opts.shrink),
                     opts.grow) if solve_ok else opts.shrink
        if accept:
            y, t = y_new, t + dt
        dt = max(dt * factor, opts.dt_min)
    return y
