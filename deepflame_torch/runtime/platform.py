"""Device and precision selection shared by the example drivers.

Port of deepflame_tpu/runtime/platform.py. The JAX package forces the CPU
for float64 because the TPU has none; the H100 has float64, so the port
runs it wherever it is asked to.
"""
from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["configure"]


def configure(device: str | None, dtype: str):
    """(torch dtype, device) for --device/--dtype choices: dtype "f64" or
    "f32"; device None means the CUDA card, which must exist."""
    if dtype not in ("f32", "f64"):
        raise ValueError(f"dtype {dtype!r}: f32 or f64")
    return (torch.float64 if dtype == "f64" else torch.float32,
            resolve_device(device))
