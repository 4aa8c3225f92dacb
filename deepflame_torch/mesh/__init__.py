from .structured import (StructuredMesh, BC, pad_field, fixed_value,
                         zero_gradient, cyclic, fixed_gradient, symmetry, empty)
from .energy_bcs import (fixed_energy, gradient_energy, mixed_energy,
                         resolve_energy_bcs)

__all__ = ["StructuredMesh", "BC", "pad_field", "fixed_value", "zero_gradient",
           "cyclic", "fixed_gradient", "symmetry", "empty", "fixed_energy",
           "gradient_energy", "mixed_energy", "resolve_energy_bcs"]
