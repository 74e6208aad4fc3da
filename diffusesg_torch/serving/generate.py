"""Sampling + decode for a batch of requests: the port's serving core.

Counterpart of ``_serving_impl`` / ``make_serving_fn`` in
diffusesg_tpu/serving/export.py:

    (seed, node_flags[B, N]) -> (adj_types[B, N, N], node_types[B, N],
                                 bboxes[B, N, 4])

``generate`` takes a plain list of requests (nodes per graph) and returns
the decoded graphs; padded slots decode to zeros.  The model runs its
kernels or its plain versions as its config's ``tpu.use_pallas_attention``
chose (``models.make_model``).  The AOT export and the HTTP server wait for
the serving slice.
"""
from __future__ import annotations

from functools import partial

import torch

from ..models.channels import resolve_sampling_channels
from ..models.precond import precond_forward
from ..sampling.decode import decode_samples
from ..sampling.edm_sampler import NodeAdjEDMSampler
from ..utils.device import resolve_device


def flags_from_num_nodes(num_nodes, max_node_num: int, device) -> torch.Tensor:
    """[B, N] bool node flags with the first ``num_nodes[i]`` slots valid."""
    counts = torch.as_tensor(list(num_nodes), dtype=torch.long)
    if counts.numel() == 0 or int(counts.min()) < 1 or int(counts.max()) > max_node_num:
        raise ValueError(f"each request needs 1..{max_node_num} nodes, got {list(num_nodes)}")
    flags = torch.arange(max_node_num)[None, :] < counts[:, None]
    return flags.to(device)


def make_denoiser(model, config, node_flags):
    """The preconditioned model (adjs, nodes, sigmas, sc_a, sc_x) -> (D_a, D_x)."""
    precond = config.mcmc.get("precond", "edm")

    def denoiser(a, x, sigmas, sc_a, sc_x):
        return precond_forward(model, precond, a, x, node_flags, sigmas, sc_a, sc_x)
    return denoiser


def make_serving_fn(model, sampler: NodeAdjEDMSampler, config):
    """(seed, node_flags, noise=None) -> (adj_types, node_types, bboxes)."""
    info = resolve_sampling_channels(config)
    if info["flag_node_only"]:
        raise NotImplementedError("serving supports the joint node+edge+bbox configs")
    decode = partial(
        decode_samples, node_encoding=config.train.node_encoding,
        edge_encoding=config.train.edge_encoding, num_node_type=info["raw_num_node_type"],
        num_adj_type=info["raw_num_adj_type"] if not info["flag_binary_edge"] else 2,
        flag_bbox=True, flag_node_only=False)

    def serve(seed: int, node_flags: torch.Tensor, noise=None):
        with torch.inference_mode():
            adjs, nodes = sampler.sample(make_denoiser(model, config, node_flags), node_flags,
                                         info["num_node_chan"], info["num_adj_chan"],
                                         noise=noise, seed=seed)
            dec = decode(adjs, nodes, node_flags)
        return dec.adj_types, dec.node_types, dec.bboxes
    return serve


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
