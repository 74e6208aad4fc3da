"""Serving: sampling + decode for batches of requests, on one device or
across several, the sampler artifact and the micro-batching HTTP server
(counterpart of diffusesg_tpu/serving)."""
from .export import (export_sampler, fixed_batch, load_artifact, make_completion_fn,
                     make_serving_fn, make_sharded_completion_fn, make_sharded_serving_fn,
                     save_artifact)
from .generate import generate
from .server import BatchingSampler, serve

__all__ = ["export_sampler", "fixed_batch", "load_artifact", "make_completion_fn",
           "make_serving_fn", "make_sharded_completion_fn", "make_sharded_serving_fn",
           "save_artifact", "generate", "BatchingSampler", "serve"]
