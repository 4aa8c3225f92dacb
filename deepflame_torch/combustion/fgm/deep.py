"""DeePFGM: a neural-network flamelet manifold in place of the table lookup.

Port of deepflame_tpu/combustion/fgm/deep.py (the reference's
FGM/DeePFGM): one MLP maps the normalised control variables (z, c, gz, gc)
to the table outputs (omgc, cOc, ZOc, cp, mwt, hiyi, Tf, nu). As in JAX,
the network runs `chemistry.dnn.mlp_apply` (plain GEMMs), not the fused
DF-ODENet kernel. Serving only: distilling a network from a table
(`train_deep_fgm` in the JAX package) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ...chemistry.dnn import mlp_apply
from .table import BASE_TABLES

__all__ = ["DeepFGM"]

_OUTPUTS = BASE_TABLES  # ("omgc", "cOc", "ZOc", "cp", "mwt", "hiyi", "Tf", "nu")
_FLOORS = {"cp": 100.0, "mwt": 1.0, "Tf": 200.0, "nu": 1e-7}


@dataclasses.dataclass(frozen=True)
class DeepFGM:
    params: Any             # MLP params [(W (in, out), b (out,)), ...]
    x_mean: torch.Tensor    # (4,) over [z, c, gz, gc]
    x_std: torch.Tensor
    y_mean: torch.Tensor    # (8,)
    y_std: torch.Tensor

    def query(self, Z, c, gz, gc) -> dict:
        """All manifold outputs at once: {name: field}, with the physical
        floors (cp, mwt, Tf, nu positive; omgc >= 0)."""
        x = torch.stack([Z, c, gz, gc], dim=-1)
        y = mlp_apply(self.params, (x - self.x_mean) / self.x_std) \
            * self.y_std + self.y_mean
        out = {name: y[..., i] for i, name in enumerate(_OUTPUTS)}
        for k, floor in _FLOORS.items():
            out[k] = torch.clamp(out[k], min=floor)
        out["omgc"] = torch.clamp(out["omgc"], min=0.0)
        return out
