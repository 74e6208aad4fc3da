"""The serving core, its numpy contract, and the sampler artifact.

Counterpart of diffusesg_tpu/serving/export.py on one device.  The core is
end to end, sampling and decode:

    (seed, node_flags[B, N]) -> (adj_types int32[B, N, N], node_types int32[B, N],
                                 bboxes float32[B, N, 4])

decoded integer scene graphs with [0, 1] cxcywh boxes (the decode of
``sampling/decode.py``); padded slots decode to zeros.  ``make_serving_fn``
and ``make_completion_fn`` return it on tensors (``serving/generate.py``
and the tests call those); ``fixed_batch`` binds either to one batch size,
device and numpy in and out, the contract ``serving/server.py`` calls, as
the JAX package's compiled program is bound to one batch.

The artifact is a directory: ``sampler.pt`` (the served weights, the chosen
EMA in the model's dtype, and the resolved config) and ``meta.json`` (the JAX
artifact's keys, ``format`` ``diffusesg_torch.serving/1``).  It differs from
the JAX artifact: that one is a compiled program (``jax.export``) that runs
without the model code; this one carries weights and config, not a program,
because the kernels launch through ctypes and no torch serialization carries
them.  The serving host therefore needs ``diffusesg_torch`` installed, and
``load_artifact`` rebuilds the model and the sampler from the config.  The
sharded serving functions and the executable cache (``save_compiled`` /
``load_compiled``) are not ported.
"""
from __future__ import annotations

import json
import os
from functools import partial

import numpy as np
import torch

from ..models.channels import resolve_sampling_channels
from ..models.precond import precond_forward
from ..ops.attribute_code import attribute_converter
from ..sampling.decode import decode_samples
from ..sampling.edm_sampler import NodeAdjEDMSampler
from ..utils.device import resolve_device

ARTIFACT_WEIGHTS = "sampler.pt"
ARTIFACT_META = "meta.json"
ARTIFACT_FORMAT = "diffusesg_torch.serving/1"


def make_denoiser(model, config, node_flags):
    """The preconditioned model (adjs, nodes, sigmas, sc_a, sc_x) -> (D_a, D_x)."""
    precond = config.mcmc.get("precond", "edm")

    def denoiser(a, x, sigmas, sc_a, sc_x):
        return precond_forward(model, precond, a, x, node_flags, sigmas, sc_a, sc_x)
    return denoiser


def _decoder(config, what: str):
    info = resolve_sampling_channels(config)
    if info["flag_node_only"]:
        raise NotImplementedError(f"{what} supports the joint node+edge+bbox configs; "
                                  "node_only ablation models are eval-only")
    n_edge_type = info["raw_num_adj_type"] if not info["flag_binary_edge"] else 2
    decode = partial(
        decode_samples, node_encoding=config.train.node_encoding,
        edge_encoding=config.train.edge_encoding, num_node_type=info["raw_num_node_type"],
        num_adj_type=n_edge_type, flag_bbox=True, flag_node_only=False)
    return info, n_edge_type, decode


def make_serving_fn(model, sampler: NodeAdjEDMSampler, config, chunk_steps: int | None = None):
    """(seed, node_flags, noise=None) -> (adj_types, node_types, bboxes) on
    the flags' device.  ``noise`` replaces the default ``TorchNoise(seed)``;
    ``chunk_steps`` is the sampler's (bit-equal output)."""
    info, _, decode = _decoder(config, "serving")

    def serve(seed: int, node_flags: torch.Tensor, noise=None):
        # inference mode is thread-local: entered here, so a serving worker
        # thread runs the model under it too
        with torch.inference_mode():
            adjs, nodes = sampler.sample(make_denoiser(model, config, node_flags), node_flags,
                                         info["num_node_chan"], info["num_adj_chan"],
                                         noise=noise, seed=seed, chunk_steps=chunk_steps)
            dec = decode(adjs, nodes, node_flags)
        return dec.adj_types, dec.node_types, dec.bboxes
    return serve


def make_completion_fn(model, sampler: NodeAdjEDMSampler, config):
    """Conditional completion over the serving surface (export.py:136-220).

    Known parts arrive in user space (integer types, [0, 1] cxcywh boxes),
    are encoded as the dataset pipeline encodes them and held through the
    reverse diffusion by the sampler's ``inpaint``, so they come back
    verbatim.  The returned function is

        (seed, node_flags[B, N], known_node int[B, N], mask_node bool[B, N],
         known_bbox float[B, N, 4], mask_bbox bool[B, N],
         known_adj int[B, N, N], mask_adj bool[B, N, N], noise=None)
          -> (adj_types, node_types, bboxes)

    Node-type and box knowledge are masked independently (a per-channel
    node mask)."""
    info, n_edge_type, decode = _decoder(config, "completion serving")
    node_enc, edge_enc = config.train.node_encoding, config.train.edge_encoding
    n_node_type = info["raw_num_node_type"]

    def complete(seed: int, node_flags, known_node, mask_node, known_bbox, mask_bbox,
                 known_adj, mask_adj, noise=None):
        with torch.inference_mode():
            x = attribute_converter(known_node.float(), node_flags, "int", node_enc, n_node_type,
                                    flag_nodes=True, flag_in_ddpm_range=False,
                                    flag_out_ddpm_range=True)
            if x.ndim == 2:  # ddpm encodes channel-less; bits / one_hot carry C
                x = x[..., None]
            gt_x = torch.cat([x, (known_bbox.float() - 0.5) * 2.0], dim=-1)
            gt_a = attribute_converter(known_adj.float(), node_flags, "int", edge_enc,
                                       n_edge_type, flag_adjs=True, flag_in_ddpm_range=False,
                                       flag_out_ddpm_range=True)
            type_chan = gt_x.shape[-1] - 4
            m_x = torch.cat([mask_node[..., None].expand(*mask_node.shape, type_chan),
                             mask_bbox[..., None].expand(*mask_bbox.shape, 4)], dim=-1)
            inpaint = {"gt_adjs": gt_a, "gt_nodes": gt_x, "mask_adjs": mask_adj,
                       "mask_nodes": m_x}
            adjs, nodes = sampler.sample(make_denoiser(model, config, node_flags), node_flags,
                                         info["num_node_chan"], info["num_adj_chan"],
                                         noise=noise, seed=seed, inpaint=inpaint)
            dec = decode(adjs, nodes, node_flags)
        return dec.adj_types, dec.node_types, dec.bboxes
    return complete


_ARG_DTYPES = (torch.bool, torch.int32, torch.bool, torch.float32, torch.bool, torch.int32,
               torch.bool)


def fixed_batch(fn, batch_size: int, max_node_num: int, device):
    """Bind a core of ``make_serving_fn`` / ``make_completion_fn`` to one
    batch size and device, numpy in and out: ``(seed, node_flags bool[B, N])``
    or the 8-argument completion form -> numpy (adj int32[B, N, N],
    node int32[B, N], bbox float32[B, N, 4]).  Flags of another batch or
    width raise ``ValueError``, as the JAX package's compiled program does."""
    dev = torch.device(device)

    def call(seed, node_flags, *known, noise=None):
        flags = np.asarray(node_flags)
        if flags.shape != (batch_size, max_node_num):
            raise ValueError(f"this sampler serves node flags of shape "
                             f"({batch_size}, {max_node_num}), got {flags.shape}")
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
                for a, dt in zip((flags, *known), _ARG_DTYPES)]
        adj, node, bbox = fn(int(seed), *args, noise=noise)
        return (adj.to(torch.int32).cpu().numpy(), node.to(torch.int32).cpu().numpy(),
                bbox.float().cpu().numpy())
    return call


def _aval(dtype: str, shape) -> str:
    return f"{dtype}[{','.join(str(int(d)) for d in shape)}]"


def export_sampler(model, sampler: NodeAdjEDMSampler, config, batch_size: int) -> dict:
    """The artifact's contents at a fixed batch size: the model's weights
    (whatever weights it holds: load the chosen EMA first), the resolved
    config, the platform the model sits on and the contract's shapes.  The
    artifact rebuilds its sampler from the config, so ``sampler`` must be
    the one ``get_mc_sampler(config)`` gives."""
    from ..sampling import get_mc_sampler

    if get_mc_sampler(config) != sampler:
        raise ValueError("the artifact rebuilds its sampler from the config, and this "
                         "sampler differs from the config's")
    n = int(config.dataset.max_node_num)
    return {
        "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "config": config.to_dict(),
        "platforms": [next(model.parameters()).device.type],
        "num_devices": 1,
        "in_avals": [_aval("int32", ()), _aval("bool", (batch_size, n))],
        "out_avals": [_aval("int32", (batch_size, n, n)), _aval("int32", (batch_size, n)),
                      _aval("float32", (batch_size, n, 4))],
    }


def save_artifact(path: str, exported: dict, config, batch_size: int) -> None:
    """Write ``sampler.pt`` (weights + config) and ``meta.json`` to ``path``/."""
    os.makedirs(path, exist_ok=True)
    torch.save({"state_dict": exported["state_dict"], "config": exported["config"]},
               os.path.join(path, ARTIFACT_WEIGHTS))
    meta = {
        "format": ARTIFACT_FORMAT,
        "platforms": list(exported["platforms"]),
        "num_devices": int(exported["num_devices"]),
        "batch_size": batch_size,
        "max_node_num": int(config.dataset.max_node_num),
        "dataset": config.dataset.name,
        "node_encoding": config.train.node_encoding,
        "edge_encoding": config.train.edge_encoding,
        "num_steps": int(config.mcmc.num_steps),
        "in_avals": list(exported["in_avals"]),
        "out_avals": list(exported["out_avals"]),
    }
    with open(os.path.join(path, ARTIFACT_META), "w") as f:
        json.dump(meta, f, indent=2)


def load_artifact(path: str, device: str | torch.device = "cuda"):
    """Load an artifact -> (callable, meta): the numpy contract
    ``(seed, node_flags bool[B, N]) -> (adj, node, bbox)`` at the artifact's
    batch, on ``device`` (``cuda`` unless the caller asks for the CPU).
    Raises when the artifact was exported for another platform or for more
    devices than this process sees (export.py:313-330)."""
    from ..config import ConfigDict
    from ..models import make_model
    from ..sampling import get_mc_sampler

    dev = resolve_device(device)
    with open(os.path.join(path, ARTIFACT_META)) as f:
        meta = json.load(f)
    platforms = [p.lower() for p in meta.get("platforms", [])]
    if dev.type not in platforms:
        raise RuntimeError(f"serving artifact at {path} was exported for platforms "
                           f"{meta.get('platforms')} but this process runs on '{dev.type}'; "
                           "re-export on the target platform")
    ndev = int(meta.get("num_devices", 1))
    visible = torch.cuda.device_count() if dev.type == "cuda" else 1
    if ndev > visible:
        raise RuntimeError(f"serving artifact at {path} spans {ndev} devices but this "
                           f"process has {visible}; re-export for {visible}")
    blob = torch.load(os.path.join(path, ARTIFACT_WEIGHTS), map_location="cpu",
                      weights_only=True)
    config = ConfigDict(blob["config"]).lock()
    model = make_model(config)
    model.load_state_dict(blob["state_dict"], strict=True)
    model = model.to(dev).eval()
    fn = make_serving_fn(model, get_mc_sampler(config), config)
    return fixed_batch(fn, int(meta["batch_size"]), int(meta["max_node_num"]), dev), meta
