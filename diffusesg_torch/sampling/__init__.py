"""EDM sampler, sampler factory and decode."""
from .factory import get_mc_sampler

__all__ = ["get_mc_sampler"]
