from .basic import CombustionModel, Laminar, NoCombustion
from .dnn_chemistry import DNNChemistry
from .edc import EDC
from .pasr import PaSR

__all__ = ["CombustionModel", "Laminar", "NoCombustion", "EDC", "PaSR",
           "DNNChemistry"]
