from .structured import (StructuredMesh, BC, pad_field, fixed_value,
                         zero_gradient, cyclic, fixed_gradient, symmetry, empty)
from .facelist import BoundaryPatch, FaceListMesh
from .geometry import GeneralMesh, build_general_mesh
from .blockmesh import parse_blockmesh_dict, build_blockmesh, read_blockmesh
from .polymesh import read_polymesh, write_polymesh
from .energy_bcs import (fixed_energy, gradient_energy, mixed_energy,
                         resolve_energy_bcs)

__all__ = ["StructuredMesh", "BC", "pad_field", "fixed_value", "zero_gradient",
           "cyclic", "fixed_gradient", "symmetry", "empty", "fixed_energy",
           "gradient_energy", "mixed_energy", "resolve_energy_bcs",
           "BoundaryPatch", "FaceListMesh", "GeneralMesh", "build_general_mesh",
           "parse_blockmesh_dict", "build_blockmesh", "read_blockmesh",
           "read_polymesh", "write_polymesh"]
