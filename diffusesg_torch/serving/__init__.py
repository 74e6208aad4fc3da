"""Serving: sampling + decode for batches of requests, on one device or
across several, the sampler artifact and the micro-batching HTTP server
(counterpart of diffusesg_tpu/serving), with the compiled sampler's
cache (``save_compiled`` / ``load_compiled``)."""
from .export import (export_sampler, fixed_batch, load_artifact, load_compiled,
                     make_completion_fn, make_serving_fn, make_sharded_completion_fn,
                     make_sharded_serving_fn, save_artifact, save_compiled)
from .generate import generate
from .server import BatchingSampler, serve

__all__ = ["export_sampler", "fixed_batch", "load_artifact", "load_compiled",
           "make_completion_fn", "make_serving_fn", "make_sharded_completion_fn",
           "make_sharded_serving_fn", "save_artifact", "save_compiled", "generate",
           "BatchingSampler", "serve"]
