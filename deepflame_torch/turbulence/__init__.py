from .les import LESModel, dynamic_smagorinsky, smagorinsky, sigma_model, wale

__all__ = ["LESModel", "smagorinsky", "wale", "sigma_model",
           "dynamic_smagorinsky"]
