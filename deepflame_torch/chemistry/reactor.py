"""0D reactor and the cell-batch chemistry solve used by the CFD solver.

Port of deepflame_tpu/chemistry/reactor.py: `ignite` (the df0DFoam
constant-pressure or constant-volume reactor) and `solve_chemistry`, which advances every cell
by dt at constant pressure and returns RR_i = rho (Y_new - Y_old)/dt and the
heat release. Load balancing is the JAX package's data layout: an explicit
RK23 fast tier for every lane, then the rejected (stiff) lanes sorted by
temperature or warm-start step into bins, each bin with its own drain.

Control flow: the JAX `lax.cond` between the top-K compact path and the full
sorted-binned path becomes one host read of the reject count and a Python
branch.

Cross-shard load balance (`solve_chemistry(cross_shard=True)` under an
active shard group, the reference's DLB cell migration): each shard sorts
its stiff lanes, deals them round-robin into one group per shard, and one
`all_to_all` hands every shard an equal slice of every stiffness stratum; a
second returns the results (`_stratified_cross_shard`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..constants import GAS_CONSTANT
from ..parallel.context import current_axis
from .integrator import (RosenbrockOptions, rk23_attempt_batched,
                         rosenbrock_integrate, rosenbrock_integrate_batched)
from .kinetics import KineticsData, production_rates
from .thermo import ThermoData

__all__ = ["constant_pressure_rhs", "constant_pressure_rhs_batched", "constant_volume_rhs",
           "constant_volume_rhs_batched", "ignite", "solve_chemistry",
           "ChemistryResult"]


def constant_pressure_rhs_batched(thermo: ThermoData, kin: KineticsData, p):
    """Batched RHS for states s = (L, 1+ns) at fixed per-lane pressure p (L,)."""
    def rhs(s):
        T, Y = s[:, 0], s[:, 1:]
        rho = thermo.rho(p, T, Y)
        wdot = production_rates(kin, thermo, T, rho, Y)       # (L, ns)
        dY = wdot * kin.W / rho[:, None]
        h_molar = thermo.h_RT(T) * (GAS_CONSTANT * T[:, None])
        cp = thermo.cp_mass(T, Y)
        dT = -(h_molar * wdot).sum(1) / (rho * cp)
        return torch.cat([dT[:, None], dY], dim=1)
    return rhs


def constant_pressure_rhs(thermo: ThermoData, kin: KineticsData, p):
    """RHS for one state s = [T, Y...] at fixed pressure p (a number or a
    0-d tensor)."""
    p = torch.as_tensor(p, dtype=thermo.W.dtype,
                        device=thermo.W.device).reshape(1)
    rhs_b = constant_pressure_rhs_batched(thermo, kin, p)
    return lambda s: rhs_b(s[None])[0]


def constant_volume_rhs_batched(thermo: ThermoData, kin: KineticsData, rho):
    """Batched RHS for states s = (L, 1+ns) at fixed per-lane density rho
    (L,): the energy equation in internal energy, u_i = h_i - R T (molar)."""
    def rhs(s):
        T, Y = s[:, 0], s[:, 1:]
        wdot = production_rates(kin, thermo, T, rho, Y)       # (L, ns)
        dY = wdot * kin.W / rho[:, None]
        u_molar = (thermo.h_RT(T) - 1.0) * (GAS_CONSTANT * T[:, None])
        cv = thermo.cv_mass(T, Y)
        dT = -(u_molar * wdot).sum(1) / (rho * cv)
        return torch.cat([dT[:, None], dY], dim=1)
    return rhs


def constant_volume_rhs(thermo: ThermoData, kin: KineticsData, rho):
    """RHS for one state s = [T, Y...] at fixed density rho (a number or a
    0-d tensor)."""
    rho = torch.as_tensor(rho, dtype=thermo.W.dtype,
                          device=thermo.W.device).reshape(1)
    rhs_b = constant_volume_rhs_batched(thermo, kin, rho)
    return lambda s: rhs_b(s[None])[0]


def ignite(thermo: ThermoData, kin: KineticsData, T0, p0, Y0, t_end,
           n_out: int = 200, const: str = "pressure",
           opts: RosenbrockOptions = RosenbrockOptions()):
    """0D reactor trajectory: (times, T(t), Y(t)) at n_out points.
    const: 'pressure' (HP reactor) or 'volume' (UV reactor, p evolves).
    T0, p0: floats; Y0: (ns,) mass fractions."""
    dtype, device = thermo.W.dtype, thermo.W.device
    Y0 = torch.as_tensor(Y0, dtype=dtype, device=device)
    T0 = torch.tensor([float(T0)], dtype=dtype, device=device)
    p0 = torch.tensor([float(p0)], dtype=dtype, device=device)
    s = torch.cat([T0, Y0])
    if const == "pressure":
        rhs_b = constant_pressure_rhs_batched(thermo, kin, p0)
    elif const == "volume":
        rhs_b = constant_volume_rhs_batched(thermo, kin,
                                            thermo.rho(p0, T0, Y0[None]))
    else:
        raise ValueError(const)
    # the output step in the state's dtype, as JAX's asarray(t_end / n_out)
    dt_out = torch.tensor([float(t_end) / n_out], dtype=dtype, device=device)
    s = s[None]
    traj = []
    for _ in range(n_out):
        s = rosenbrock_integrate(rhs_b, s, dt_out, opts)
        traj.append(s[0])
    traj = torch.stack(traj)
    times = torch.arange(1, n_out + 1, dtype=dtype, device=device) * dt_out
    return times, traj[:, 0], traj[:, 1:]


class ChemistryResult(NamedTuple):
    T: torch.Tensor          # (...,) new temperature
    Y: torch.Tensor          # (..., ns) new mass fractions
    RR: torch.Tensor         # (..., ns) rho (Y_new - Y_old)/dt [kg/m^3/s]
    Qdot: torch.Tensor       # (...,) heat release rate [J/m^3/s]
    dt_next: torch.Tensor | None = None   # (...,) warm-start step suggestion


def _stratified_cross_shard(run, key, inputs, n_out, group):
    """Cross-shard chemistry load balance: lanes sorted by stiffness `key`
    (largest = stiffest), dealt round-robin into one group per shard, one
    all_to_all so that every shard integrates an equal slice of every
    stratum, `run` on the received lanes, and a second all_to_all (its own
    inverse) back. inputs: (L, ...) tensors of one dtype, lane axis first
    (and run's outputs: (L', ...) tensors of one dtype); lanes are
    padded to a multiple of the shard count with zero lanes, which sort
    first (key -inf) and must be inactive in `run` (t_end 0). Returns the
    first n_out outputs of run, in the original lane order."""
    L = inputs[0].shape[0]
    P = group.size
    pad = (-L) % P
    Lp = L + pad

    def pack(x):
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        return x

    keyp = pack(key)
    if pad:
        keyp[L:] = float("-inf")
    order = torch.argsort(keyp, stable=True)            # cold ... stiff
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(Lp, device=order.device)

    def fwd(x):
        xs = pack(x)[order]
        g = xs.reshape((Lp // P, P) + xs.shape[1:]).transpose(0, 1)
        return group.all_to_all(g).reshape((Lp,) + xs.shape[1:])

    def bwd(y):
        g = group.all_to_all(y.reshape((P, Lp // P) + y.shape[1:]))
        ys = g.transpose(0, 1).reshape((Lp,) + y.shape[1:])
        return ys[inv_order][:L]

    # one all_to_all each way: the lanes' tensors side by side as columns
    # (the JAX package exchanges them one by one; the values are the same)
    received = _unstack(fwd(_stack(inputs)), inputs)
    outs = run(*received)[:n_out]
    return _unstack(bwd(_stack(outs)), outs)


def _stack(ts) -> torch.Tensor:
    """(L, ...) tensors of one dtype -> (L, sum of their widths)."""
    return torch.cat([t.reshape(t.shape[0], -1) for t in ts], dim=1)


def _unstack(x: torch.Tensor, like) -> tuple:
    """The inverse of _stack, shapes (but the lane count) from `like`."""
    out, c = [], 0
    for t in like:
        w = math.prod(t.shape[1:])
        out.append(x[:, c:c + w].reshape((x.shape[0],) + t.shape[1:]))
        c += w
    return tuple(out)


def solve_chemistry(thermo: ThermoData, kin: KineticsData, T, p, Y, dt,
                    opts: RosenbrockOptions = RosenbrockOptions(),
                    T_threshold: float = 200.0, n_bins: int = 32,
                    dt_start=None, fast_tier: bool = True,
                    sort: str = "T",
                    cross_shard: bool = False) -> ChemistryResult:
    """Advance chemistry in every cell by dt at constant pressure.

    T, p: (...,); Y: (..., ns); dt: float or per-cell tensor. Cells with
    T < T_threshold are frozen. cross_shard: under an active shard group,
    balance the stiff lanes across the shards (_stratified_cross_shard);
    without a group it changes nothing."""
    batch_shape = T.shape
    ns = Y.shape[-1]
    Tf = T.reshape(-1)
    pf = p.reshape(-1)
    Yf = Y.reshape(-1, ns)
    s0 = torch.cat([Tf[:, None], Yf], dim=1)
    dt_f = torch.broadcast_to(torch.as_tensor(dt, dtype=Tf.dtype,
                                              device=Tf.device),
                              batch_shape).reshape(-1)

    def integrate_chunk(s_chunk, p_chunk, te_chunk, d0_chunk):
        rhs_b = constant_pressure_rhs_batched(thermo, kin, p_chunk)
        return rosenbrock_integrate_batched(rhs_b, s_chunk, te_chunk, opts,
                                            dt_start=d0_chunk)

    active = Tf > T_threshold
    t_ends = torch.where(active, dt_f, torch.zeros_like(dt_f))
    if dt_start is None:
        dt0_f = torch.full_like(Tf, opts.dt_init)
    else:
        dt0_f = torch.broadcast_to(torch.as_tensor(
            dt_start, dtype=Tf.dtype, device=Tf.device), batch_shape).reshape(-1)

    # explicit fast tier: one embedded RK23 attempt over the whole step for
    # every lane; lanes failing the same error test go to the implicit tier
    if fast_tier:
        rhs_all = constant_pressure_rhs_batched(thermo, kin, pf)
        y_fast, accepted, dt_sugg = rk23_attempt_batched(rhs_all, s0, t_ends,
                                                         opts)
        dt_fast = torch.where(t_ends > 0, dt_sugg, dt0_f)
        t_ends_rem = torch.where(accepted, torch.zeros_like(t_ends), t_ends)
    else:
        t_ends_rem = t_ends

    def run_integration(s0, pf, t_ends_rem, dt0_f):
        return _integrate_binned(integrate_chunk, s0, pf, t_ends_rem, dt0_f,
                                 ns, n_bins, fast_tier, sort, opts,
                                 Tf_key=s0[:, 0])

    group = current_axis() if cross_shard else None
    if group is not None:
        # stiffness key: the warm-start step where given (a small converged
        # step is stiff), else the temperature; inactive lanes coldest
        neg_inf = torch.full_like(Tf, float("-inf"))
        key = torch.where(t_ends_rem > 0,
                          -dt0_f if dt_start is not None else Tf, neg_inf)
        s1, dt_next = _stratified_cross_shard(
            run_integration, key, (s0, pf, t_ends_rem, dt0_f), 2, group)
    else:
        s1, dt_next = run_integration(s0, pf, t_ends_rem, dt0_f)
    if fast_tier:
        s1 = torch.where(accepted[:, None], y_fast, s1)
        dt_next = torch.where(accepted, dt_fast, dt_next)
    T1 = s1[:, 0]
    Y1 = torch.clamp(s1[:, 1:], 0.0, 1.0)
    Y1 = Y1 / Y1.sum(-1, keepdim=True)
    rho = thermo.rho(pf, Tf, Yf)
    RR = rho[:, None] * (Y1 - Yf) / torch.clamp(dt_f, min=1e-30)[:, None]
    Qdot = -(RR @ thermo.h_formation)
    return ChemistryResult(
        T=T1.reshape(batch_shape), Y=Y1.reshape(batch_shape + (ns,)),
        RR=RR.reshape(batch_shape + (ns,)), Qdot=Qdot.reshape(batch_shape),
        dt_next=dt_next.reshape(batch_shape))


def _integrate_binned(integrate_chunk, s0, pf, t_ends_rem, dt0_f, ns,
                      n_bins, fast_tier, sort, opts, Tf_key):
    """Stiffness-binned batched integration over flat lanes.

    Compact path: with the fast tier in front only a stiff minority reaches
    the implicit integrator, so gather only the K stiffest lanes, bin and
    integrate those, and scatter the results back. If the reject count
    exceeds K, the full sorted-binned path runs instead (one host read)."""
    n = s0.shape[0]
    if not (n_bins > 1 and n >= 2 * n_bins):
        return integrate_chunk(s0, pf, t_ends_rem, dt0_f)
    chunk = -(-n // n_bins)
    pad = chunk * n_bins - n
    neg_inf = torch.full_like(Tf_key, float("-inf"))
    if sort == "dt":
        key = torch.where(t_ends_rem > 0, -dt0_f, neg_inf)
    else:
        key = torch.where(t_ends_rem > 0, Tf_key, neg_inf)

    n_hot_bins = max(4, n_bins // 8)
    K = n_hot_bins * chunk
    if fast_tier and n_bins >= 8 and K < n:
        n_rej = int((t_ends_rem > 0).sum())
        if n_rej <= K:
            idx = torch.argsort(key, stable=True)[n - K:]     # K stiffest
            s0_b = s0[idx].reshape(n_hot_bins, chunk, ns + 1)
            pf_b = pf[idx].reshape(n_hot_bins, chunk)
            te_b = t_ends_rem[idx].reshape(n_hot_bins, chunk)
            d0_b = dt0_f[idx].reshape(n_hot_bins, chunk)
            outs, dtns = [], []
            # coldest half of the compact set: one wide slab whose loop exits
            # at once (fast-tier survivors with te = 0)
            n_cold = n_hot_bins // 2
            o_c, d_c = integrate_chunk(
                s0_b[:n_cold].reshape(n_cold * chunk, ns + 1),
                pf_b[:n_cold].reshape(-1), te_b[:n_cold].reshape(-1),
                d0_b[:n_cold].reshape(-1))
            outs.append(o_c)
            dtns.append(d_c)
            for b in range(n_cold, n_hot_bins):
                o_b, d_b = integrate_chunk(s0_b[b], pf_b[b], te_b[b], d0_b[b])
                outs.append(o_b)
                dtns.append(d_b)
            s1 = s0.clone()
            s1[idx] = torch.cat(outs, 0)
            dt1 = dt0_f.clone()
            dt1[idx] = torch.cat(dtns, 0)
            return s1, dt1
    return _sorted_binned(integrate_chunk, key, s0, pf, t_ends_rem, dt0_f,
                          ns=ns, n_bins=n_bins, chunk=chunk, pad=pad,
                          fast_tier=fast_tier, opts=opts)


def _sorted_binned(integrate_chunk, key, s0, pf, t_ends_rem, dt0_f, *, ns,
                   n_bins, chunk, pad, fast_tier, opts):
    """Full sorted-binned integration: every lane permuted into stiffness
    order, one drain per bin (the cold half folded into one wide slab)."""
    order = torch.argsort(key, stable=True)
    pad_s = torch.zeros((pad, ns + 1), dtype=s0.dtype, device=s0.device)
    pad_s[:, 0] = 300.0
    s0_s = torch.cat([pad_s, s0[order]])
    pf_s = torch.cat([torch.full((pad,), 101325.0, dtype=pf.dtype,
                                 device=pf.device), pf[order]])
    te_s = torch.cat([torch.zeros(pad, dtype=t_ends_rem.dtype,
                                  device=pf.device), t_ends_rem[order]])
    d0_s = torch.cat([torch.full((pad,), opts.dt_init, dtype=dt0_f.dtype,
                                 device=pf.device), dt0_f[order]])
    s0_b = s0_s.reshape(n_bins, chunk, ns + 1)
    pf_b = pf_s.reshape(n_bins, chunk)
    te_b = te_s.reshape(n_bins, chunk)
    d0_b = d0_s.reshape(n_bins, chunk)
    outs, dtns = [], []
    start = 0
    if fast_tier and n_bins >= 4:
        n_cold = n_bins // 2
        o_c, d_c = integrate_chunk(
            s0_b[:n_cold].reshape(n_cold * chunk, ns + 1),
            pf_b[:n_cold].reshape(-1), te_b[:n_cold].reshape(-1),
            d0_b[:n_cold].reshape(-1))
        outs.append(o_c)
        dtns.append(d_c)
        start = n_cold
    for b in range(start, n_bins):
        o_b, d_b = integrate_chunk(s0_b[b], pf_b[b], te_b[b], d0_b[b])
        outs.append(o_b)
        dtns.append(d_b)
    out = torch.cat(outs, 0)[pad:]
    dtn = torch.cat(dtns, 0)[pad:]
    s1 = torch.empty_like(out)
    s1[order] = out
    dt_next = torch.empty_like(dtn)
    dt_next[order] = dtn
    return s1, dt_next
