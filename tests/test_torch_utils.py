"""The port's host utilities: flame diagnostics (utils/flame_speed.py)
against the JAX package's, equal on a seeded tanh flame; and the runtime's
platform selection (runtime/platform.py), which keeps float64 on the card
where the JAX package moves it to the CPU."""
import numpy as np
import pytest
import torch

from deepflame_tpu.utils import flame_speed as JFS

from deepflame_torch.runtime import platform as TP
from deepflame_torch.utils import flame_speed as TFS


def test_flame_speed_matches_jax():
    x = np.linspace(0.0, 0.01, 201)
    times = np.linspace(0.0, 1e-3, 6)
    profiles = [300.0 + 850.0 * (1.0 + np.tanh((x - 0.004 - 0.4 * t) / 3e-4))
                for t in times]
    for fn in ("flame_position", "flame_thickness"):
        assert getattr(TFS, fn)(x, profiles[2]) == \
            getattr(JFS, fn)(x, profiles[2])
    pos = [TFS.flame_position(x, T) for T in profiles]
    assert TFS.flame_speed(times, pos) == JFS.flame_speed(times, pos)
    assert TFS.laminar_flame_speed(times, pos, 0.15, 1.1, 0.1) == \
        JFS.laminar_flame_speed(times, pos, 0.15, 1.1, 0.1)
    assert TFS.flame_speed(times, pos) == pytest.approx(0.4, rel=0.05)


def test_platform_configure():
    assert TP.configure("cpu", "f64") == (torch.float64, torch.device("cpu"))
    assert TP.configure("cpu", "f32") == (torch.float32, torch.device("cpu"))
    with pytest.raises(ValueError, match="f32 or f64"):
        TP.configure("cpu", "bf16")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TP.configure(None, "f64")
