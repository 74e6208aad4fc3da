"""Sampling + decode for a list of requests.

``generate`` takes a plain list of requests (nodes per graph) and returns
the decoded graphs through the serving core of ``serving/export.py``
(``make_serving_fn``, the counterpart of the JAX package's
``_serving_impl``); padded slots decode to zeros.  The model runs its
kernels or its plain versions as its config's ``tpu.use_pallas_attention``
chose (``models.make_model``).  The HTTP server is ``serving/server.py``.
"""
from __future__ import annotations

import torch

from ..sampling.edm_sampler import NodeAdjEDMSampler
from ..utils.device import resolve_device
from .export import make_denoiser, make_serving_fn

__all__ = ["flags_from_num_nodes", "generate", "make_denoiser", "make_serving_fn"]


def flags_from_num_nodes(num_nodes, max_node_num: int, device) -> torch.Tensor:
    """[B, N] bool node flags with the first ``num_nodes[i]`` slots valid."""
    counts = torch.as_tensor(list(num_nodes), dtype=torch.long)
    if counts.numel() == 0 or int(counts.min()) < 1 or int(counts.max()) > max_node_num:
        raise ValueError(f"each request needs 1..{max_node_num} nodes, got {list(num_nodes)}")
    flags = torch.arange(max_node_num)[None, :] < counts[:, None]
    return flags.to(device)


def generate(model, sampler: NodeAdjEDMSampler, config, num_nodes, seed: int = 0,
             device: str | torch.device = "cuda", noise=None):
    """Answer a list of requests (nodes per graph, e.g. ``[64, 40, 12, 5]``)
    with decoded scene graphs: (adj_types, node_types, bboxes), batch-first
    in request order.  Runs on ``cuda`` unless ``device="cpu"``."""
    dev = resolve_device(device)
    param_dev = next(model.parameters()).device
    if param_dev.type != dev.type:
        raise ValueError(f"model is on {param_dev}, requests asked for {dev}")
    flags = flags_from_num_nodes(num_nodes, config.dataset.max_node_num, param_dev)
    return make_serving_fn(model, sampler, config)(seed, flags, noise)
