"""Case runtime of the port: configuration, solver factory, time-loop
driver, checkpoints and timers (deepflame_tpu/runtime's config, factory,
driver, checkpoint and timers modules)."""
from .config import (CaseConfig, ChemistryProperties, CombustionProperties,
                     TurbulenceProperties, ControlDict, Schemes,
                     SolutionControl, load_case)
from .checkpoint import save_state, load_state, load_meta, latest_time
from .timers import PhaseTimers, trace

__all__ = ["CaseConfig", "ChemistryProperties", "CombustionProperties",
           "TurbulenceProperties", "ControlDict", "Schemes", "SolutionControl",
           "load_case", "save_state", "load_state", "load_meta", "latest_time",
           "PhaseTimers", "trace"]
