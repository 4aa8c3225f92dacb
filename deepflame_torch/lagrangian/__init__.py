from .cloud import (CloudSources, CloudState, ConeInjector, ManualInjector,
                    PatchFuncInjector, SprayCloud)
from .film import WallFilm, WallFilmState
from .liquids import Liquid, ethanol, n_dodecane, n_heptane, water

__all__ = ["CloudSources", "CloudState", "ConeInjector", "ManualInjector",
           "PatchFuncInjector", "SprayCloud", "WallFilm", "WallFilmState",
           "Liquid", "ethanol", "n_dodecane", "n_heptane", "water"]
