from .context import gmax, gmean, gmin, gsum

__all__ = ["gsum", "gmax", "gmin", "gmean"]
