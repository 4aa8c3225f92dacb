from .les import LESModel, smagorinsky, wale, sigma_model

__all__ = ["LESModel", "smagorinsky", "wale", "sigma_model"]
