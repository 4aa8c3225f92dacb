"""Checkpoint / restart of solver states.

Port of deepflame_tpu/runtime/checkpoint.py, in the same layout:
<directory>/<time>/state.npz holds the state's tensors as leaf_0, leaf_1, ...
in the JAX package's flatten order (the state's fields in order, a tuple such
as phi as its elements, a None field as nothing), and meta.json the time,
the leaf count and any extra entries. So a checkpoint the JAX package wrote
of a LowMachState restarts the port, and the other way round.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

__all__ = ["save_state", "load_state", "load_meta", "latest_time"]


def _leaves(obj) -> list:
    if obj is None:
        return []
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [leaf for o in obj for leaf in _leaves(o)]
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def _rebuild(like, arrays):
    """`like`'s structure with its tensors taken in order from `arrays`, each
    in the type and on the device of the tensor it replaces."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(next(arrays), dtype=like.dtype,
                               device=like.device)
    parts = [_rebuild(o, arrays) for o in like]
    return type(like)(*parts) if hasattr(like, "_fields") else type(like)(parts)


def _time_dir(directory: str, time) -> str:
    if time == "latest":
        time = latest_time(directory)
        if time is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    return os.path.join(directory, f"{float(time):.9g}")


def save_state(directory: str, state: Any, time: float,
               meta: dict | None = None) -> str:
    """Write state to <directory>/<time>/state.npz + meta.json."""
    tdir = os.path.join(directory, f"{time:.9g}")
    os.makedirs(tdir, exist_ok=True)
    leaves = _leaves(state)
    np.savez(os.path.join(tdir, "state.npz"),
             **{f"leaf_{i}": x.detach().cpu().numpy()
                for i, x in enumerate(leaves)})
    with open(os.path.join(tdir, "meta.json"), "w") as f:
        json.dump({"time": time, "n_leaves": len(leaves),
                   "treedef": type(state).__name__, **(meta or {})}, f)
    return tdir


def load_state(directory: str, like: Any, time: float | str = "latest") -> Any:
    """Read a checkpoint into the structure, types and device of `like`."""
    data = np.load(os.path.join(_time_dir(directory, time), "state.npz"))
    n = len(_leaves(like))
    if n != len(data.files):
        raise ValueError(f"checkpoint has {len(data.files)} leaves, the "
                         f"state needs {n}")
    return _rebuild(like, iter(data[f"leaf_{i}"] for i in range(n)))


def load_meta(directory: str, time: float | str = "latest") -> dict:
    """Read a checkpoint's meta.json (it carries, for example, the adjustable
    dt at write time, so restarts resume with the settled step size)."""
    with open(os.path.join(_time_dir(directory, time), "meta.json")) as f:
        return json.load(f)


def latest_time(directory: str) -> float | None:
    if not os.path.isdir(directory):
        return None
    times = []
    for d in os.listdir(directory):
        try:
            times.append(float(d))
        except ValueError:
            pass
    return max(times) if times else None
