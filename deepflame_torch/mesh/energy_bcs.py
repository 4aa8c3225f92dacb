"""Energy boundary conditions: T-space BCs resolved onto the enthalpy field.

Port of deepflame_tpu/mesh/energy_bcs.py. The user states the boundary
condition on temperature and the ha field receives the consistent affine BC:

    fixedEnergy:    ha|b      = h(T_b, Y_b)
    gradientEnergy: dha/dn|b  = cp(T_own, Y_own) dT/dn|b
    mixedEnergy:    f * fixed + (1 - f) * gradient

`resolve_energy_bcs` is called once per step and maps energy-kind BCs to
"affine" ghost BCs from the current owner-cell state.
"""
from __future__ import annotations

import torch

from .structured import BC, StructuredMesh

__all__ = ["fixed_energy", "gradient_energy", "mixed_energy",
           "resolve_energy_bcs", "has_energy_bcs"]


def fixed_energy(T_b) -> BC:
    return BC("fixedEnergy", T_b)


def gradient_energy(dTdn) -> BC:
    """dha/dn = cp dT/dn; the value is the +axis derivative dT/dx."""
    return BC("gradientEnergy", dTdn)


def mixed_energy(T_b, dTdn, fraction) -> BC:
    return BC("mixedEnergy", (T_b, dTdn, fraction))


_ENERGY_KINDS = ("fixedEnergy", "gradientEnergy", "mixedEnergy")


def has_energy_bcs(bcs_h) -> bool:
    return any(bc.kind in _ENERGY_KINDS for ax in bcs_h for bc in ax)


def _owner_slice(F, axis, side):
    n = F.shape[axis]
    i = 0 if side == 0 else n - 1
    return F.narrow(axis, i, 1)


def _pad_prior_axes(arr, axis):
    """pad_field pads axes in order 0..2, so an array-valued BC on `axis`
    meets owner slices whose earlier axes already carry one ghost layer each
    side: edge-replicate those axes."""
    for ax in range(axis):
        n = arr.shape[ax]
        arr = torch.cat([arr.narrow(ax, 0, 1), arr, arr.narrow(ax, n - 1, 1)],
                        dim=ax)
    return arr


def _boundary_Y(Y, bcs_Y, axis, side):
    """(ns, 1-slice) boundary composition: fixedValue Y BCs honoured, anything
    else -> owner-cell composition."""
    ns = Y.shape[0]
    own = _owner_slice(Y, axis + 1, side)
    if bcs_Y is None:
        return own
    shared = isinstance(bcs_Y[0][0], BC)
    vals = []
    for k in range(ns):
        bc = (bcs_Y if shared else bcs_Y[k])[axis][side]
        if bc.kind in ("fixedValue", "inletOutlet"):
            vals.append(torch.full_like(own[k], bc.value))
        else:
            vals.append(own[k])
    return torch.stack(vals)


def resolve_energy_bcs(bcs_h, T, Y, thermo, mesh: StructuredMesh, bcs_Y=None):
    """Map energy-kind BCs in bcs_h to affine ghost BCs from the current
    fields. Returns bcs_h itself when it holds no energy kinds."""
    if not has_energy_bcs(bcs_h):
        return bcs_h
    out = []
    for axis in range(3):
        pair = []
        for side in (0, 1):
            bc = bcs_h[axis][side]
            if bc.kind not in _ENERGY_KINDS:
                pair.append(bc)
                continue
            h = mesh.spacing[axis]
            sgn = -1.0 if side == 0 else 1.0
            Yb = torch.movedim(_boundary_Y(Y, bcs_Y, axis, side), 0, -1)
            T_own = _owner_slice(T, axis, side)
            if bc.kind == "fixedEnergy":
                T_b = torch.as_tensor(bc.value, dtype=T.dtype, device=T.device)
                h_b = thermo.h_mass(torch.broadcast_to(T_b, T_own.shape), Yb)
                pair.append(BC("affine",
                               (-1.0, _pad_prior_axes(2.0 * h_b, axis))))
            elif bc.kind == "gradientEnergy":
                g = thermo.cp_mass(T_own, Yb) * bc.value
                pair.append(BC("affine",
                               (1.0, _pad_prior_axes(sgn * g * h, axis))))
            else:
                T_b, dTdn, f = bc.value
                T_b = torch.as_tensor(T_b, dtype=T.dtype, device=T.device)
                h_b = thermo.h_mass(torch.broadcast_to(T_b, T_own.shape), Yb)
                g = thermo.cp_mass(T_own, Yb) * dTdn
                a = 1.0 - 2.0 * f
                b = 2.0 * f * h_b + (1.0 - f) * sgn * g * h
                pair.append(BC("affine", (a, _pad_prior_axes(b, axis))))
        out.append(tuple(pair))
    return tuple(out)
