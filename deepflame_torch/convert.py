"""Carry a mechanism, a solver state, DF-ODENet parameters, a flamelet table
or DeePFGM parameters into the port from plain numpy data.

The functions take numpy arrays (for example the fields of the JAX
package's `Mechanism` or `LowMachState`, or its DF-ODENet parameters, each
passed through `numpy.asarray`), so the tests can start both packages from
one state without this package importing the other. The AMR states go both
ways (`*_to_numpy`), in the JAX package's layout.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .chemistry.dnn import DFODENet
from .combustion.fgm import DeepFGM, FlameletTable
from .chemistry.mechanism import MECHANISM_ARRAYS, Mechanism
from .device import resolve_device
from .mesh.patch_amr import PatchState, RowPatchState
from .solvers.fgm_fl import FGMFLState
from .solvers.high_speed import HighSpeedState
from .solvers.high_speed_fl import HighSpeedFLState
from .solvers.low_mach import LowMachState
from .solvers.low_mach_fl import LowMachFLState
from .solvers.spray import SprayFLState

__all__ = ["mechanism_from_numpy", "state_from_numpy", "fl_state_from_numpy",
           "hs_fl_state_from_numpy", "fgm_fl_state_from_numpy",
           "spray_fl_state_from_numpy", "dfodenet_from_numpy",
           "dfodenet_to_numpy",
           "flamelet_table_from_numpy", "deep_fgm_from_numpy",
           "hs_state_from_numpy", "patch_state_from_numpy",
           "row_patch_state_from_numpy", "patch_state_to_numpy",
           "row_patch_state_to_numpy"]


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


def dfodenet_to_numpy(net: DFODENet) -> dict:
    """The arguments of dfodenet_from_numpy as numpy, from a DFODENet:
    nets [[(W (in, out), b (out,)), ...] per species], x_mean, x_std,
    y_mean, y_std, delta_t and frozen_T (the JAX package's DFODENet takes
    the same fields)."""
    a = lambda t: t.detach().cpu().numpy()
    return dict(nets=[[(a(W), a(b)) for W, b in net] for net in net.nets],
                x_mean=a(net.x_mean), x_std=a(net.x_std),
                y_mean=a(net.y_mean), y_std=a(net.y_std),
                delta_t=net.delta_t, frozen_T=net.frozen_T)


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


def _fields_of(x) -> dict:
    """The fields of a mapping or of a NamedTuple (its _asdict())."""
    return dict(x) if isinstance(x, Mapping) else x._asdict()


def hs_state_from_numpy(d, dtype=torch.float64,
                        device=None) -> HighSpeedState:
    """HighSpeedState (structured) from numpy fields, a mapping or a
    NamedTuple: rho, rhoU (3, ...), rhoE, rhoY (ns, ...), T and time."""
    device = resolve_device(device)
    d = _fields_of(d)
    f = lambda x: torch.as_tensor(np.array(x), dtype=dtype, device=device)
    return HighSpeedState(**{k: f(d[k]) for k in HighSpeedState._fields})


def _offsets(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=torch.int32, device=device)


def patch_state_from_numpy(d, dtype=torch.float64, device=None) -> PatchState:
    """PatchState (MovingPatchAMR, NestedPatchAMR) from numpy fields, as the
    JAX package's PatchState holds them: coarse, fine (a state, or the next
    level's patch state) and offset, each a mapping or a NamedTuple."""
    device = resolve_device(device)
    d = _fields_of(d)
    fine = _fields_of(d["fine"])
    fine = (patch_state_from_numpy(fine, dtype, device) if "offset" in fine
            else hs_state_from_numpy(fine, dtype, device))
    return PatchState(coarse=hs_state_from_numpy(d["coarse"], dtype, device),
                      fine=fine, offset=_offsets(d["offset"], device))


def row_patch_state_from_numpy(d, dtype=torch.float64,
                               device=None) -> RowPatchState:
    """RowPatchState (FrontPatchAMR2D) from numpy fields in the JAX
    package's layout, rows leading every leaf of fine (rhoU (R, 3, ...),
    rhoY (R, ns, ...)); the port keeps the row axis after the component
    axis (rhoU (3, R, ...), rhoY (ns, R, ...))."""
    device = resolve_device(device)
    d = _fields_of(d)
    fine = _fields_of(d["fine"])
    fine.update(rhoU=np.moveaxis(np.asarray(fine["rhoU"]), 0, 1),
                rhoY=np.moveaxis(np.asarray(fine["rhoY"]), 0, 1))
    return RowPatchState(coarse=hs_state_from_numpy(d["coarse"], dtype,
                                                    device),
                         fine=hs_state_from_numpy(fine, dtype, device),
                         offsets=_offsets(d["offsets"], device))


def _state_to_numpy(s) -> dict:
    return {k: getattr(s, k).detach().cpu().numpy()
            for k in HighSpeedState._fields}


def patch_state_to_numpy(ps: PatchState) -> dict:
    """A PatchState as nested dicts of numpy arrays (coarse, fine,
    offset)."""
    fine = (patch_state_to_numpy(ps.fine) if isinstance(ps.fine, PatchState)
            else _state_to_numpy(ps.fine))
    return dict(coarse=_state_to_numpy(ps.coarse), fine=fine,
                offset=ps.offset.cpu().numpy())


def row_patch_state_to_numpy(ps: RowPatchState) -> dict:
    """A RowPatchState as dicts of numpy arrays in the JAX package's layout
    (rows leading every leaf of fine)."""
    fine = _state_to_numpy(ps.fine)
    fine.update(rhoU=np.moveaxis(fine["rhoU"], 1, 0),
                rhoY=np.moveaxis(fine["rhoY"], 1, 0))
    return dict(coarse=_state_to_numpy(ps.coarse), fine=fine,
                offsets=ps.offsets.cpu().numpy())
