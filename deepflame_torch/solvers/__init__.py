from .low_mach import LowMachConfig, LowMachSolver, LowMachState
from .low_mach_fl import LowMachFLState, LowMachSolverFL

__all__ = ["LowMachConfig", "LowMachSolver", "LowMachState", "LowMachFLState",
           "LowMachSolverFL"]
