"""Typed case configuration (the OpenFOAM-dictionary surface, as dataclasses).

Port of deepflame_tpu/runtime/config.py: the reference's per-case dictionary
files (constant/CanteraTorchProperties, combustionProperties,
turbulenceProperties, system/controlDict, fvSchemes, fvSolution) as
dataclasses with the same section names, defined in Python or loaded from
one YAML file (examples/cases/*.yaml).
"""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["ChemistryProperties", "CombustionProperties",
           "TurbulenceProperties", "ControlDict", "Schemes", "SolutionControl",
           "CaseConfig", "load_case"]


@dataclasses.dataclass(frozen=True)
class ChemistryProperties:
    """CanteraTorchProperties parity."""
    chemistry: bool = True
    mechanism_file: str = ""
    transport_model: str = "Mix"          # Mix | UnityLewis
    ode_rtol: float = 1e-6                # odeCoeffs relTol
    ode_atol: float = 1e-12               # odeCoeffs absTol
    inert_specie: str = "N2"
    splitting_strategy: bool = False
    # TorchSettings parity
    torch_on: bool = False
    torch_model: str = ""
    frozen_temperature: float = 700.0
    inference_delta_time: float = 1e-6


@dataclasses.dataclass(frozen=True)
class CombustionProperties:
    model: str = "laminar"                # laminar | EDC | PaSR | flareFGM | DeePFGM | noCombustion
    edc_version: str = "v2005"
    pasr_mixing_scale: str = "globalScale"
    pasr_chemistry_scale: str = "formationRate"
    pasr_Cmix: float = 0.1
    fgm_table: str = ""


@dataclasses.dataclass(frozen=True)
class TurbulenceProperties:
    simulation_type: str = "laminar"      # laminar | LES | RAS
    les_model: str = "Smagorinsky"        # Smagorinsky | WALE | Sigma | dynamicSmagorinsky
    ras_model: str = "kEpsilon"           # kEpsilon | RNGkEpsilon | kOmegaSST
    Pr_t: float = 0.85
    Sc_t: float = 0.7


@dataclasses.dataclass(frozen=True)
class ControlDict:
    end_time: float = 1e-3
    delta_t: float = 1e-6
    adjust_time_step: bool = False
    max_courant: float = 0.4
    write_interval: float = 1e-4
    write_dir: str = "postProcessing"


@dataclasses.dataclass(frozen=True)
class Schemes:
    """fvSchemes parity (per-operator discretization selection)."""
    div_scheme: str = "limitedLinear"     # div(phi,*) family
    flux_scheme: str = "HLLC"             # density-based solver
    limiter: str = "vanLeer"              # MUSCL reconstruction
    rk_order: int = 2


@dataclasses.dataclass(frozen=True)
class SolutionControl:
    """fvSolution parity."""
    n_outer_correctors: int = 2
    n_correctors: int = 2
    p_tol: float = 1e-8
    p_rel_tol: float = 1e-3
    u_tol: float = 1e-7
    y_tol: float = 1e-9
    h_tol: float = 1e-8


@dataclasses.dataclass(frozen=True)
class CaseConfig:
    chemistry: ChemistryProperties = ChemistryProperties()
    combustion: CombustionProperties = CombustionProperties()
    turbulence: TurbulenceProperties = TurbulenceProperties()
    control: ControlDict = ControlDict()
    schemes: Schemes = Schemes()
    solution: SolutionControl = SolutionControl()
    dtype: str = "float32"


_SECTIONS = {
    "chemistry": ChemistryProperties,
    "combustion": CombustionProperties,
    "turbulence": TurbulenceProperties,
    "control": ControlDict,
    "schemes": Schemes,
    "solution": SolutionControl,
}


def load_case(path: str) -> CaseConfig:
    """Load a YAML case file; unknown keys are rejected (typo safety)."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    kwargs: dict[str, Any] = {}
    for name, cls in _SECTIONS.items():
        section = doc.pop(name, {})
        valid = {f.name for f in dataclasses.fields(cls)}
        bad = set(section) - valid
        if bad:
            raise ValueError(f"unknown keys in '{name}': {sorted(bad)}")
        kwargs[name] = cls(**section)
    if "dtype" in doc:
        kwargs["dtype"] = doc.pop("dtype")
    if doc:
        raise ValueError(f"unknown top-level sections: {sorted(doc)}")
    return CaseConfig(**kwargs)
