"""Chapman-Jouguet detonation state calculator.

Port of deepflame_tpu/utils/cj.py: the CJ point as the minimum-speed
intersection of the Rayleigh line with the equilibrium Hugoniot, each
Hugoniot point's equilibrium found by relaxing the kinetics at constant
(rho, e) from the complete-combustion composition.

JAX runs the n_x Hugoniot points one after another, each a fixed point on
p1 of up to 40 relaxations. Here the points are lanes of one batch: every
iteration relaxes all unfinished points in one call of the lane-batched
integrator, a point freezes once |p_eq - p1| < 5 Pa, and the best D is taken
at the end, so each point's iterates and the result are the sequential
loop's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..chemistry.integrator import RosenbrockOptions, rosenbrock_integrate
from ..chemistry.kinetics import KineticsData
from ..chemistry.reactor import constant_volume_rhs_batched
from ..chemistry.thermo import ThermoData
from ..constants import GAS_CONSTANT

__all__ = ["cj_speed"]


def cj_speed(thermo: ThermoData, kin: KineticsData, Y0, Y_burned, p0, T0,
             x_range=(0.48, 0.64), n_x: int = 9,
             relax_time: float = 2e-3,
             opts: RosenbrockOptions = RosenbrockOptions(
                 rtol=1e-8, atol=1e-14, max_steps=400_000)):
    """CJ speed [m/s] and (T_CJ, p_CJ), as a tuple (D, T, p) of floats.

    Y0: unburned mass fractions; Y_burned: complete-combustion composition
    (same elements), the relaxation start on the burned branch."""
    dtype, dev = thermo.W.dtype, thermo.W.device
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
    Y0, Yb = f(Y0), f(Y_burned)
    rho0 = float(thermo.rho(f(p0), f(T0), Y0))
    e0 = float(thermo.e_mass(f(T0), Y0))
    v0 = 1.0 / rho0

    xs = np.linspace(*x_range, n_x)
    v1 = xs * v0
    rho1 = 1.0 / v1
    p1 = np.full(n_x, 18.0 * p0)
    T1 = np.zeros(n_x)
    live = np.ones(n_x, bool)
    for _ in range(40):
        idx = np.flatnonzero(live)
        if idx.size == 0:
            break
        e1 = e0 + 0.5 * (p1[idx] + p0) * (v0 - v1[idx])
        rho_l = f(rho1[idx])
        T_start = thermo.T_from_e(f(e1), Yb.expand(idx.size, -1),
                                  torch.full((idx.size,), 2500.0,
                                             dtype=dtype, device=dev),
                                  iters=50)
        s0 = torch.cat([T_start[:, None], Yb.expand(idx.size, -1)], dim=1)
        rhs = constant_volume_rhs_batched(thermo, kin, rho_l)
        s1 = rosenbrock_integrate(rhs, s0, f(np.full(idx.size, relax_time)),
                                  opts)
        T_eq = s1[:, 0]
        p_eq = rho_l * GAS_CONSTANT * T_eq / thermo.W_mix(s1[:, 1:])
        T_eq, p_eq = T_eq.cpu().numpy(), p_eq.cpu().numpy().astype(float)
        T1[idx] = T_eq
        done = np.abs(p_eq - p1[idx]) < 5.0
        live[idx[done]] = False
        move = idx[~done]
        p1[move] = 0.5 * p1[move] + 0.5 * p_eq[~done]
    D = np.sqrt((p1 - p0) / (rho0**2 * (v0 - v1)))
    best = (np.inf, None, None)
    for i in range(n_x):
        if D[i] < best[0]:
            best = (float(D[i]), float(T1[i]), float(p1[i]))
    return best
