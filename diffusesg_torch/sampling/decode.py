"""Decode raw diffusion outputs into integer scene graphs + boxes.

Counterpart of diffusesg_tpu/sampling/decode.py: clamp to [-1, 1],
sign-binarize bits / one_hot channels, interval-quantize ddpm scalars,
split and rescale the bbox slice, remove self-loops.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.attribute_code import attribute_converter, bin2dec, num_bits_for
from ..ops.masking import mask_adjs, mask_nodes


class DecodedSamples(NamedTuple):
    node_types: torch.Tensor | None  # [B, N] int32
    adj_types: torch.Tensor          # [B, N, N] int32
    bboxes: torch.Tensor | None      # [B, N, 4] float in [0, 1]


def split_bbox_nodes(nodes, node_flags):
    """Split the trailing 4 bbox channels and rescale [-1, 1] -> [0, 1]."""
    node_attr, bbox = nodes[..., :-4], nodes[..., -4:]
    return node_attr, mask_nodes(bbox * 0.5 + 0.5, node_flags)


def decode_node(node_samples, node_flags, encoding: str, num_node_type: int):
    """Quantize node-type channels to ints."""
    x = torch.clamp(node_samples, -1.0, 1.0)
    if encoding == "bits":
        bits = mask_nodes((x > 0.0).float(), node_flags)
        out = bin2dec(bits, num_bits_for(num_node_type))
        return torch.clamp(mask_nodes(out, node_flags), 0, num_node_type - 1).to(torch.int32)
    if encoding == "one_hot":
        x = mask_nodes(torch.where(x > 0.0, 1.0, -1.0), node_flags)
        out = attribute_converter(x, node_flags, "one_hot", "int", num_node_type,
                                  flag_nodes=True, flag_in_ddpm_range=True)
        return out.to(torch.int32)
    if encoding == "ddpm":
        if x.ndim == 3 and x.shape[-1] == 1:
            x = x[..., 0]
        out = attribute_converter(x, node_flags, "ddpm", "int", num_node_type,
                                  flag_nodes=True, flag_in_ddpm_range=True)
        return out.to(torch.int32)
    raise NotImplementedError(f"unknown encoding {encoding}")


def decode_adj(adj_samples, node_flags, encoding: str, num_adj_type: int,
               remove_self_loops: bool = True):
    """Quantize edge-type channels to ints."""
    x = torch.clamp(adj_samples, -1.0, 1.0)
    if encoding == "bits":
        if x.ndim == 3:
            x = x[..., None]
        bits = mask_adjs((x > 0.0).float(), node_flags)
        out = bin2dec(bits, num_bits_for(num_adj_type))
        out = torch.clamp(mask_adjs(out, node_flags), 0, num_adj_type - 1)
    elif encoding == "one_hot":
        x = mask_adjs(torch.where(x > 0.0, 1.0, -1.0), node_flags)
        out = attribute_converter(x, node_flags, "one_hot", "int", num_adj_type,
                                  flag_adjs=True, flag_in_ddpm_range=True)
    elif encoding == "ddpm":
        if x.ndim == 4 and x.shape[-1] == 1:
            x = x[..., 0]
        out = attribute_converter(x, node_flags, "ddpm", "int", num_adj_type,
                                  flag_adjs=True, flag_in_ddpm_range=True)
    else:
        raise NotImplementedError(f"unknown encoding {encoding}")
    if remove_self_loops and node_flags.ndim == 2:
        n = out.shape[-1]
        out = out * (1.0 - torch.eye(n, dtype=out.dtype, device=out.device))
    return out.to(torch.int32)


def decode_samples(adjs, nodes, node_flags, node_encoding: str, edge_encoding: str,
                   num_node_type: int, num_adj_type: int, flag_bbox: bool = True,
                   flag_node_only: bool = False) -> DecodedSamples:
    """Full decode path for joint samples."""
    bbox = None
    if flag_node_only:
        if flag_bbox:
            adjs, bbox = adjs[..., :-4], mask_adjs(adjs[..., -4:] * 0.5 + 0.5, node_flags)
        adj_types = decode_adj(adjs, node_flags, edge_encoding, num_node_type,
                               remove_self_loops=False)
        return DecodedSamples(None, adj_types, bbox)
    if flag_bbox:
        nodes, bbox = split_bbox_nodes(nodes, node_flags)
    node_types = decode_node(nodes, node_flags, node_encoding, num_node_type)
    adj_types = decode_adj(adjs, node_flags, edge_encoding, num_adj_type)
    return DecodedSamples(node_types, adj_types, bbox)
