"""Sampling + decode for batches of requests."""
from .generate import generate, make_serving_fn

__all__ = ["generate", "make_serving_fn"]
