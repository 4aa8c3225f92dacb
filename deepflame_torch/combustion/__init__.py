from .basic import CombustionModel, Laminar, NoCombustion
from .dnn_chemistry import DNNChemistry

__all__ = ["CombustionModel", "Laminar", "NoCombustion", "DNNChemistry"]
