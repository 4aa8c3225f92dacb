from .fgm import FGMConfig, FGMSolver, FGMState
from .high_speed import HighSpeedConfig, HighSpeedSolver, HighSpeedState
from .low_mach import LowMachConfig, LowMachSolver, LowMachState
from .low_mach_fl import LowMachFLState, LowMachSolverFL
from .spray import (HighSpeedSprayState, HighSpeedSpraySolver, SpraySolver,
                    SprayState)

__all__ = ["LowMachConfig", "LowMachSolver", "LowMachState", "LowMachFLState",
           "LowMachSolverFL", "HighSpeedConfig", "HighSpeedSolver",
           "HighSpeedState", "FGMConfig", "FGMSolver", "FGMState", "SprayState",
           "SpraySolver", "HighSpeedSprayState", "HighSpeedSpraySolver"]
