"""Carry a mechanism, a solver state, DF-ODENet parameters, a flamelet table
or DeePFGM parameters into the port from plain numpy data.

The functions take numpy arrays (for example the fields of the JAX
package's `Mechanism` or `LowMachState`, or its DF-ODENet parameters, each
passed through `numpy.asarray`), so the tests can start both packages from
one state without this package importing the other.
"""
from __future__ import annotations

import numpy as np
import torch

from .chemistry.dnn import DFODENet
from .combustion.fgm import DeepFGM, FlameletTable
from .chemistry.mechanism import MECHANISM_ARRAYS, Mechanism
from .device import resolve_device
from .solvers.fgm_fl import FGMFLState
from .solvers.high_speed_fl import HighSpeedFLState
from .solvers.low_mach import LowMachState
from .solvers.low_mach_fl import LowMachFLState
from .solvers.spray import SprayFLState

__all__ = ["mechanism_from_numpy", "state_from_numpy", "fl_state_from_numpy",
           "hs_fl_state_from_numpy", "fgm_fl_state_from_numpy",
           "spray_fl_state_from_numpy", "dfodenet_from_numpy",
           "flamelet_table_from_numpy", "deep_fgm_from_numpy"]


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
    time, phi (sequence of three face arrays), optionally turb and cscalars
    (sequences of cell arrays, absent or empty without them) and chem_dt
    (absent, None or empty when chemistry is off)."""
    device = resolve_device(device)
    f = lambda x: torch.as_tensor(np.array(x), dtype=dtype, device=device)
    chem_dt = d.get("chem_dt")
    if chem_dt is not None and np.size(chem_dt) == 0:
        chem_dt = None
    return LowMachState(
        rho=f(d["rho"]), U=f(d["U"]), p=f(d["p"]), ha=f(d["ha"]), Y=f(d["Y"]),
        T=f(d["T"]), phi=tuple(f(x) for x in d["phi"]), dpdt=f(d["dpdt"]),
        time=f(d["time"]), turb=tuple(f(x) for x in d.get("turb", ())),
        cscalars=tuple(f(x) for x in d.get("cscalars", ())),
        chem_dt=None if chem_dt is None else f(chem_dt))


def fl_state_from_numpy(d: dict, dtype=torch.float64,
                        device=None) -> LowMachFLState:
    """LowMachFLState from a dict of numpy fields of a face-list state: rho,
    U (n, 3), p, ha, Y (n, ns), T, dpdt, time, phi (nf,), phi_b (sequence of
    per-patch arrays), optionally chem_dt (absent, None or empty when
    chemistry is off, as the JAX package's `()`) and turb (the RAS (k, eps),
    absent or empty without RAS)."""
    device = resolve_device(device)
    f = lambda x: torch.as_tensor(np.array(x), dtype=dtype, device=device)
    chem_dt = d.get("chem_dt")
    if chem_dt is not None and np.size(chem_dt) == 0:
        chem_dt = None
    return LowMachFLState(
        rho=f(d["rho"]), U=f(d["U"]), p=f(d["p"]), ha=f(d["ha"]), Y=f(d["Y"]),
        T=f(d["T"]), phi=f(d["phi"]), phi_b=tuple(f(x) for x in d["phi_b"]),
        dpdt=f(d["dpdt"]), time=f(d["time"]),
        chem_dt=None if chem_dt is None else f(chem_dt),
        turb=tuple(f(x) for x in d.get("turb", ())))


def hs_fl_state_from_numpy(d: dict, dtype=torch.float64,
                           device=None) -> HighSpeedFLState:
    """HighSpeedFLState from numpy fields: rho (n,), rhoU (n, 3), rhoE,
    rhoY (n, ns), T and time."""
    device = resolve_device(device)
    f = lambda x: torch.as_tensor(np.array(x), dtype=dtype, device=device)
    return HighSpeedFLState(**{k: f(d[k]) for k in HighSpeedFLState._fields})


def fgm_fl_state_from_numpy(d: dict, dtype=torch.float64,
                            device=None) -> FGMFLState:
    """FGMFLState from numpy fields: every field of the state, phi_b a
    sequence of per-patch arrays."""
    device = resolve_device(device)
    f = lambda x: torch.as_tensor(np.array(x), dtype=dtype, device=device)
    return FGMFLState(**{k: (tuple(f(x) for x in d[k]) if k == "phi_b"
                             else f(d[k])) for k in FGMFLState._fields})


def spray_fl_state_from_numpy(gas: dict, cloud, dtype=torch.float64,
                              device=None) -> SprayFLState:
    """SprayFLState of a face-list gas state given as numpy fields (as
    fl_state_from_numpy takes them) and a cloud state of the port (e.g.
    OverlaySprayCloud.init's)."""
    return SprayFLState(gas=fl_state_from_numpy(gas, dtype, device),
                        cloud=cloud)


def dfodenet_from_numpy(nets, x_mean, x_std, y_mean, y_std, delta_t: float,
                        frozen_T: float = 700.0, compute_dtype=None,
                        dtype=torch.float64, device=None) -> DFODENet:
    """DFODENet from numpy parameters: nets = [[(W (in, out), b (out,)),
    ...] per species], as the JAX package's `init_params` lays them out."""
    device = resolve_device(device)
    f = lambda x: torch.as_tensor(np.array(x), dtype=dtype, device=device)
    return DFODENet(nets=[[(f(W), f(b)) for W, b in net] for net in nets],
                    x_mean=f(x_mean), x_std=f(x_std), y_mean=f(y_mean),
                    y_std=f(y_std), delta_t=delta_t, frozen_T=frozen_T,
                    compute_dtype=compute_dtype)


def flamelet_table_from_numpy(d: dict, dtype=torch.float64,
                              device=None) -> FlameletTable:
    """FlameletTable from a dict of the JAX table's fields: axes (six
    arrays), tables ({name: 6-D array}), scaled_pv, H_fuel, H_ox,
    omega_species, species and laminar ({key: (NH, NZL) array})."""
    device = resolve_device(device)
    return FlameletTable(
        axes=tuple(np.array(a, dtype=np.float64) for a in d["axes"]),
        tables={k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
                for k, v in d["tables"].items()},
        scaled_pv=bool(d["scaled_pv"]), H_fuel=float(d["H_fuel"]),
        H_ox=float(d["H_ox"]), omega_species=tuple(d["omega_species"]),
        species=tuple(d["species"]),
        laminar={k: np.array(v) for k, v in d["laminar"].items()})


def deep_fgm_from_numpy(params, x_mean, x_std, y_mean, y_std,
                        dtype=torch.float64, device=None) -> DeepFGM:
    """DeepFGM from numpy parameters: params = [(W (in, out), b (out,)),
    ...] and the normalisation vectors of its inputs (4,) and outputs
    (8,)."""
    device = resolve_device(device)
    f = lambda x: torch.as_tensor(np.array(x), dtype=dtype, device=device)
    return DeepFGM(params=[(f(W), f(b)) for W, b in params],
                   x_mean=f(x_mean), x_std=f(x_std), y_mean=f(y_mean),
                   y_std=f(y_std))
