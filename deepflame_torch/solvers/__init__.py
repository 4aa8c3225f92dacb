from .low_mach import LowMachConfig, LowMachSolver, LowMachState

__all__ = ["LowMachConfig", "LowMachSolver", "LowMachState"]
