from .basic import CombustionModel, Laminar, NoCombustion

__all__ = ["CombustionModel", "Laminar", "NoCombustion"]
