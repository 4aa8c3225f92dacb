"""Flame diagnostics: flame position, thermal thickness and propagation
speed from 1D profiles.

The port's own copy of deepflame_tpu/utils/flame_speed.py (the reference's
flameSpeed utility), host numpy: profiles arrive from function-object
output, one transfer per write.
"""
from __future__ import annotations

import numpy as np

__all__ = ["flame_position", "flame_thickness", "flame_speed",
           "laminar_flame_speed"]


def flame_position(x: np.ndarray, T: np.ndarray) -> float:
    """Location of max |dT/dx| (the flame front)."""
    g = np.abs(np.gradient(np.asarray(T), np.asarray(x)))
    return float(x[int(np.argmax(g))])


def flame_thickness(x: np.ndarray, T: np.ndarray) -> float:
    """Thermal thickness (T_max - T_min)/max|dT/dx|."""
    T = np.asarray(T)
    g = np.abs(np.gradient(T, np.asarray(x)))
    return float((T.max() - T.min()) / max(g.max(), 1e-300))


def flame_speed(times, positions) -> float:
    """Propagation speed from a linear fit of front position against time."""
    return float(np.polyfit(np.asarray(times), np.asarray(positions), 1)[0])


def laminar_flame_speed(times, positions, rho_burned, rho_unburned,
                        u_inflow: float = 0.0) -> float:
    """S_L = |dx_f/dt - u_inflow| rho_b/rho_u: the expansion correction when
    the front propagates into quiescent unburned gas in the lab frame."""
    s_disp = flame_speed(times, positions) - u_inflow
    return float(abs(s_disp) * rho_burned / rho_unburned)
