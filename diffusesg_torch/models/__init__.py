"""Denoiser modules, factory and preconditioning."""
from .factory import FIXED_NUM_HEADS, build_model, count_params, init_params, make_model

__all__ = ["FIXED_NUM_HEADS", "build_model", "count_params", "init_params", "make_model"]
