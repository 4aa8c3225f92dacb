from .fgm import FGMConfig, FGMSolver, FGMState
from .fgm_fl import FGMFLState, FGMSolverFL
from .high_speed import HighSpeedConfig, HighSpeedSolver, HighSpeedState
from .high_speed_fl import HighSpeedFLState, HighSpeedSolverFL
from .low_mach import LowMachConfig, LowMachSolver, LowMachState
from .low_mach_fl import LowMachFLState, LowMachSolverFL
from .spray import (HighSpeedSprayState, HighSpeedSpraySolver, SprayFLSolver,
                    SprayFLState, SpraySolver, SprayState)

__all__ = ["LowMachConfig", "LowMachSolver", "LowMachState", "LowMachFLState",
           "LowMachSolverFL", "HighSpeedConfig", "HighSpeedSolver",
           "HighSpeedState", "FGMConfig", "FGMSolver", "FGMState", "SprayState",
           "SpraySolver", "HighSpeedSprayState", "HighSpeedSpraySolver",
           "HighSpeedFLState", "HighSpeedSolverFL", "FGMFLState",
           "FGMSolverFL", "SprayFLState", "SprayFLSolver"]
