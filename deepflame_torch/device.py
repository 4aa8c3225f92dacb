"""Device selection for the port's entry points.

Every entry point (`load_mechanism`, `make_thermo`, `make_transport`,
`make_kinetics`, `StructuredMesh.box`, `LowMachSolver`, `initial_state`)
runs on the CUDA card unless the caller asks for the CPU. There is no silent
fallback: with no card and no explicit `device="cpu"`, they raise.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)
