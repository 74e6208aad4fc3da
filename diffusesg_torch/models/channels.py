"""Dataset/encoding -> model channel bookkeeping.

The port's own copy of diffusesg_tpu/models/channels.py.

Reference: DiffuseSG/utils/sg_utils.py:348-430 (get_node_adj_num_type,
get_node_adj_model_input_output_channels).  Numbers are reproduced exactly so
reference configs map onto identical model shapes.
"""
from __future__ import annotations

import math

DATASET_CONSTANTS = {
    # name-fragment: (num_node_type, num_edge_type incl. null, num_allowed_nodes)
    "visual_genome": (150, 51, 62),
    "coco_stuff": (171, 7, 33),
}


def dataset_constants(dataset_name: str):
    for key, val in DATASET_CONSTANTS.items():
        if key in dataset_name:
            return val
    raise NotImplementedError(f"unknown scene-graph dataset {dataset_name}")


def _encoded_channels(encoding: str, raw_num_type: int) -> int:
    if encoding == "one_hot":
        return raw_num_type
    if encoding == "bits":
        return int(math.ceil(math.log2(raw_num_type)))
    if encoding == "ddpm":
        return 1
    raise NotImplementedError(f"unknown encoding {encoding}")


def get_node_adj_num_type(dataset_name: str, flag_sg: bool, encoding: str,
                          flag_node_only: bool = False, flag_node_bbox: bool = True,
                          edge_encoding: str | None = None) -> dict:
    """Per-encoding channel counts (reference: sg_utils.py:348-409).

    ``edge_encoding`` supports node_encoding != edge_encoding configs (the
    reference keeps separate config keys and independent decode paths,
    sampler_node_adj.py:221-293); None means same encoding for both.
    """
    if not flag_sg:
        raise NotImplementedError("only scene-graph datasets are supported")
    raw_num_node_type, raw_num_adj_type, num_allowed_nodes = dataset_constants(dataset_name)

    num_node_type = _encoded_channels(encoding, raw_num_node_type)
    num_adj_type = _encoded_channels(edge_encoding or encoding, raw_num_adj_type)

    if flag_node_only:
        in_chans_node = 2
        in_chans_adj = num_node_type
        out_chans_node = 1
        out_chans_adj = num_node_type
        num_adj_type = num_node_type
        num_node_type = 1
        if flag_node_bbox:
            in_chans_adj += 4
            out_chans_adj += 4
    else:
        in_chans_node = num_node_type * 2
        in_chans_adj = num_adj_type
        out_chans_node = num_node_type
        out_chans_adj = num_adj_type
        if flag_node_bbox:
            num_node_type += 4
            in_chans_node += 4 * 2
            out_chans_node += 4

    return {
        "raw_num_node_type": raw_num_node_type,
        "raw_num_adj_type": raw_num_adj_type,
        "num_allowed_nodes": num_allowed_nodes,
        "num_node_type": num_node_type,
        "num_adj_type": num_adj_type,
        "in_chans_node": in_chans_node,
        "in_chans_adj": in_chans_adj,
        "out_chans_node": out_chans_node,
        "out_chans_adj": out_chans_adj,
    }


def resolve_sampling_channels(config) -> dict:
    """Sampler-facing channel counts with the node_only / binary_edge
    overrides the sampling orchestrator applies (reference:
    sampler_node_adj.py:61-86 channel resolution + the implicit
    channel-less-broadcast quirk at sampler_node_adj.py:80-83).

    Returns get_node_adj_num_type's dict extended with ``num_node_chan`` /
    ``num_adj_chan`` (what the sampler's init noise uses) and the resolved
    ``flag_node_only`` / ``flag_binary_edge``.
    """
    flag_node_only = config.train.get("node_only", False)
    flag_binary_edge = config.train.get("binary_edge", False)
    info = get_node_adj_num_type(
        config.dataset.name, flag_sg=True,
        encoding=config.train.node_encoding,
        flag_node_only=flag_node_only, flag_node_bbox=True,
        edge_encoding=config.train.edge_encoding)
    num_node_chan = info["num_node_type"]
    num_adj_chan = info["num_adj_type"]
    if flag_binary_edge:
        num_adj_chan = 1
    if flag_node_only:
        # node-only packs node attrs (+bbox) onto the adj grid; the sampler's
        # adj channel count is the real grid channel count
        num_adj_chan = info["in_chans_adj"]
        num_node_chan = 1  # dummy [B, N] node vector
    return dict(info, num_node_chan=num_node_chan, num_adj_chan=num_adj_chan,
                flag_node_only=flag_node_only, flag_binary_edge=flag_binary_edge)


def get_node_adj_model_input_output_channels(config):
    """Model-facing channel counts (reference: sg_utils.py:412-430)."""
    info = get_node_adj_num_type(
        config.dataset.name, config.flag_sg, config.train.node_encoding,
        flag_node_only=config.train.get("node_only", False),
        edge_encoding=config.train.edge_encoding)
    in_chans = info["in_chans_node"] + info["in_chans_adj"]
    return in_chans, info["out_chans_adj"], info["out_chans_node"]
