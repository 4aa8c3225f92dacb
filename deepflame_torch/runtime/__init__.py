"""Case runtime of the port: configuration, solver factory, time-loop
driver, checkpoints, timers, function objects, derived fields and OpenFOAM
field import (deepflame_tpu/runtime's modules of the same names)."""
from .config import (CaseConfig, ChemistryProperties, CombustionProperties,
                     TurbulenceProperties, ControlDict, Schemes,
                     SolutionControl, load_case)
from .checkpoint import save_state, load_state, load_meta, latest_time
from .function_objects import (FieldMinMax, Probes, LineSample, FieldAverage,
                               FunctionObjectSet, PatchFieldValue)
from .timers import PhaseTimers, trace
from .openfoam_io import read_openfoam_field, read_case_fields
from .derived import (vorticity, q_criterion, enstrophy, mach_number,
                      y_plus, wall_heat_flux, DerivedFields)

__all__ = ["vorticity", "q_criterion", "enstrophy", "mach_number", "y_plus",
           "wall_heat_flux", "DerivedFields",
           "CaseConfig", "ChemistryProperties", "CombustionProperties",
           "TurbulenceProperties", "ControlDict", "Schemes", "SolutionControl",
           "load_case", "save_state", "load_state", "load_meta", "latest_time",
           "FieldMinMax", "Probes", "LineSample", "FieldAverage",
           "FunctionObjectSet", "PatchFieldValue", "PhaseTimers", "trace",
           "read_openfoam_field", "read_case_fields"]
