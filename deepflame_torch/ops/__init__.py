from .fv import (FvMatrix, grad, div_flux, flux_of, div_explicit,
                 laplacian_explicit, interpolate, face_pair, fvm_ddt, fvm_div,
                 fvm_laplacian, fvm_source_implicit)
from .linsolve import cg, bicgstab, solve_fvmatrix, SolverResult

__all__ = ["FvMatrix", "grad", "div_flux", "flux_of", "div_explicit",
           "laplacian_explicit", "interpolate", "face_pair", "fvm_ddt", "fvm_div", "fvm_laplacian",
           "fvm_source_implicit", "cg", "bicgstab", "solve_fvmatrix",
           "SolverResult"]
