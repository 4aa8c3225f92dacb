from .les import LESModel, dynamic_smagorinsky, smagorinsky, sigma_model, wale
from .ras import KEpsilon, KOmegaSST, wall_distance
from .wall_functions import WallFunctions

__all__ = ["LESModel", "smagorinsky", "wale", "sigma_model",
           "dynamic_smagorinsky", "KEpsilon", "KOmegaSST", "wall_distance",
           "WallFunctions"]
