"""Carry a mechanism or a solver state into the port from plain numpy data.

Both functions take dictionaries of numpy arrays (for example the fields of
the JAX package's `Mechanism` or `LowMachState`, each passed through
`numpy.asarray`), so the tests can start both packages from one state
without this package importing the other.
"""
from __future__ import annotations

import numpy as np
import torch

from .chemistry.mechanism import MECHANISM_ARRAYS, Mechanism
from .device import resolve_device
from .solvers.low_mach import LowMachState

__all__ = ["mechanism_from_numpy", "state_from_numpy"]


def mechanism_from_numpy(d: dict, device=None) -> Mechanism:
    """Mechanism from a dict with its names ('name', 'species_names',
    'element_names') and its arrays (MECHANISM_ARRAYS) as numpy. Thermo,
    kinetics and transport tables made from it match the source's."""
    arrays = {k: np.array(d[k], dtype=np.float64) for k in MECHANISM_ARRAYS}
    return Mechanism(name=str(d["name"]),
                     species_names=tuple(d["species_names"]),
                     element_names=tuple(d["element_names"]),
                     device=resolve_device(device), **arrays)


def state_from_numpy(d: dict, dtype=torch.float64, device=None) -> LowMachState:
    """LowMachState from a dict of numpy fields: rho, U, p, ha, Y, T, dpdt,
    time, phi (sequence of three face arrays) and optionally chem_dt (absent,
    None or empty when chemistry is off)."""
    device = resolve_device(device)
    f = lambda x: torch.as_tensor(np.array(x), dtype=dtype, device=device)
    chem_dt = d.get("chem_dt")
    if chem_dt is not None and np.size(chem_dt) == 0:
        chem_dt = None
    return LowMachState(
        rho=f(d["rho"]), U=f(d["U"]), p=f(d["p"]), ha=f(d["ha"]), Y=f(d["Y"]),
        T=f(d["T"]), phi=tuple(f(x) for x in d["phi"]), dpdt=f(d["dpdt"]),
        time=f(d["time"]), chem_dt=None if chem_dt is None else f(chem_dt))
