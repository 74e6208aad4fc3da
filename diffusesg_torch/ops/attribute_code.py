"""Attribute codec: node/edge labels among int / ddpm / bits / one_hot.

Counterpart of diffusesg_tpu/ops/attribute_code.py.  Every conversion
routes through the integer encoding.  Channels-last layout:
  int / ddpm:     nodes [B, N], adjs [B, N, N]
  bits / one_hot: nodes [B, N, C], adjs [B, N, N, C]
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .masking import mask_adjs, mask_nodes

ENCODINGS = ("int", "ddpm", "bits", "one_hot")


def _infer_mask_func(attr, flag_nodes: bool, flag_adjs: bool):
    if flag_adjs and not flag_nodes:
        return mask_adjs
    if flag_nodes and not flag_adjs:
        return mask_nodes
    if attr.ndim == 3:
        return mask_adjs
    if attr.ndim == 2:
        return mask_nodes
    raise ValueError("cannot infer node/adj kind; pass flag_nodes or flag_adjs")


def num_bits_for(num_attr_type: int) -> int:
    return int(math.ceil(math.log2(num_attr_type)))


def _bit_weights(num_bits: int, dtype, device):
    return (2 ** torch.arange(num_bits - 1, -1, -1, device=device)).to(dtype)


def dec2bin(dec: torch.Tensor, num_bits: int) -> torch.Tensor:
    """[...] int -> [..., num_bits] float 0/1, MSB first."""
    masks = _bit_weights(num_bits, torch.int32, dec.device)
    return (torch.bitwise_and(dec.to(torch.int32)[..., None], masks) != 0).float()


def bin2dec(bits: torch.Tensor, num_bits: int) -> torch.Tensor:
    """[..., num_bits] 0/1 -> [...] float decimal, MSB first."""
    return (_bit_weights(num_bits, bits.dtype, bits.device) * bits).sum(-1)


def attribute_int_to_ddpm(in_attr, attr_flags, num_attr_type, flag_nodes=False,
                          flag_adjs=False):
    mask_fn = _infer_mask_func(in_attr, flag_nodes, flag_adjs)
    out = 2.0 * in_attr.float() / (num_attr_type - 1.0) - 1.0
    return mask_fn(out, attr_flags)


def attribute_ddpm_to_int(in_attr, attr_flags, num_attr_type, flag_nodes=False,
                          flag_adjs=False):
    """Nearest-interval quantization; a boundary maps to the lower index."""
    mask_fn = _infer_mask_func(in_attr, flag_nodes, flag_adjs)
    delta = 2.0 / (num_attr_type - 1.0)
    idx = torch.ceil((in_attr.float() + 1.0) / delta - 0.5)
    idx = torch.clamp(idx, 0, num_attr_type - 1)
    return mask_fn(idx, attr_flags)


def attribute_int_to_bits(in_attr, attr_flags, num_attr_type, flag_ddpm_range=True,
                          flag_nodes=False, flag_adjs=False):
    mask_fn = _infer_mask_func(in_attr, flag_nodes, flag_adjs)
    out = dec2bin(in_attr, num_bits_for(num_attr_type))
    if flag_ddpm_range:
        out = 2.0 * out - 1.0
    return mask_fn(out, attr_flags)


def attribute_bits_to_int(in_attr, attr_flags, num_attr_type, flag_in_ddpm_range=True,
                          flag_clamp_int=False, flag_nodes=False, flag_adjs=False):
    mask_fn = mask_adjs if flag_adjs or (not flag_nodes and in_attr.ndim == 4) else mask_nodes
    bits = in_attr
    if flag_in_ddpm_range:
        bits = mask_fn((bits + 1.0) / 2.0, attr_flags)
    out = bin2dec(bits, bits.shape[-1])
    if flag_clamp_int:
        out = torch.clamp(out, 0, num_attr_type - 1)
    return mask_fn(out, attr_flags)


def attribute_int_to_one_hot(in_attr, attr_flags, num_attr_type, flag_ddpm_range=True,
                             flag_nodes=False, flag_adjs=False):
    mask_fn = _infer_mask_func(in_attr, flag_nodes, flag_adjs)
    idx = in_attr.long()
    # jax.nn.one_hot gives an all-zero row for an out-of-range index
    valid = (idx >= 0) & (idx < num_attr_type)
    out = F.one_hot(torch.where(valid, idx, 0), num_attr_type).float() * valid[..., None]
    if flag_ddpm_range:
        out = 2.0 * out - 1.0
    return mask_fn(out, attr_flags)


def attribute_one_hot_to_int(in_attr, attr_flags, num_attr_type, flag_in_ddpm_range=True,
                             flag_nodes=False, flag_adjs=False):
    mask_fn = mask_adjs if flag_adjs or (not flag_nodes and in_attr.ndim == 4) else mask_nodes
    x = in_attr
    if flag_in_ddpm_range:
        x = mask_fn((x + 1.0) / 2.0, attr_flags)
    out = torch.argmax(x, dim=-1).float()
    return mask_fn(out, attr_flags)


def attribute_converter(in_attr, attr_flags, in_encoding, out_encoding, num_attr_type,
                        flag_nodes=False, flag_adjs=False, flag_in_ddpm_range=True,
                        flag_out_ddpm_range=True, flag_clamp_int=False):
    """Convert among int/ddpm/bits/one_hot through the int intermediate."""
    if in_encoding not in ENCODINGS or out_encoding not in ENCODINGS:
        raise ValueError(f"encodings must be one of {ENCODINGS}")
    if in_encoding == "int":
        int_attr = in_attr
    elif in_encoding == "ddpm":
        int_attr = attribute_ddpm_to_int(in_attr, attr_flags, num_attr_type,
                                         flag_nodes=flag_nodes, flag_adjs=flag_adjs)
    elif in_encoding == "bits":
        int_attr = attribute_bits_to_int(in_attr, attr_flags, num_attr_type,
                                         flag_in_ddpm_range, flag_clamp_int,
                                         flag_nodes=flag_nodes, flag_adjs=flag_adjs)
    else:
        int_attr = attribute_one_hot_to_int(in_attr, attr_flags, num_attr_type,
                                            flag_in_ddpm_range,
                                            flag_nodes=flag_nodes, flag_adjs=flag_adjs)
    if out_encoding == "int":
        return int_attr
    if out_encoding == "ddpm":
        return attribute_int_to_ddpm(int_attr, attr_flags, num_attr_type,
                                     flag_nodes=flag_nodes, flag_adjs=flag_adjs)
    if out_encoding == "bits":
        return attribute_int_to_bits(int_attr, attr_flags, num_attr_type, flag_out_ddpm_range,
                                     flag_nodes=flag_nodes, flag_adjs=flag_adjs)
    return attribute_int_to_one_hot(int_attr, attr_flags, num_attr_type, flag_out_ddpm_range,
                                    flag_nodes=flag_nodes, flag_adjs=flag_adjs)


def reshape_node_attr_vec_to_mat(node_attr_vec, node_flags_vec, matrix_size: int):
    """Pack node attributes onto an adjacency-shaped grid (node-only mode):
    [B, N](, C) -> [B, M, M](, C) channels-last, plus [B, M, M] bool flags."""
    b, n = node_attr_vec.shape[:2]
    m = matrix_size
    pad = m * m - n
    if pad < 0:
        raise ValueError(f"matrix_size^2={m * m} < vector length {n}")
    flags_mat = F.pad(node_flags_vec.float(), (0, pad)).reshape(b, m, m).bool()
    if node_attr_vec.ndim == 2:
        attr_mat = F.pad(node_attr_vec, (0, pad)).reshape(b, m, m)
    elif node_attr_vec.ndim == 3:
        attr_mat = F.pad(node_attr_vec, (0, 0, 0, pad)).reshape(b, m, m, -1)
    else:
        raise ValueError(f"bad node_attr shape {tuple(node_attr_vec.shape)}")
    return mask_adjs(attr_mat, flags_mat), flags_mat


def reshape_node_attr_mat_to_vec(node_attr_mat, node_flags_mat, vector_size: int):
    """Unpack adjacency-shaped node attributes back to vectors (node-only
    mode): [B, M, M](, C) -> [B, N](, C), plus [B, N] bool flags."""
    b, m = node_attr_mat.shape[:2]
    flat_len = m * m

    def fit(x_flat):
        if vector_size >= flat_len:
            pad = [0, 0] * (x_flat.ndim - 2) + [0, vector_size - flat_len]
            return F.pad(x_flat, pad)
        return x_flat[:, :vector_size]

    flags_vec = fit(node_flags_mat.float().reshape(b, -1)).bool()
    if node_attr_mat.ndim == 3:
        attr_vec = fit(node_attr_mat.reshape(b, -1))
    elif node_attr_mat.ndim == 4:
        attr_vec = fit(node_attr_mat.reshape(b, flat_len, node_attr_mat.shape[-1]))
    else:
        raise ValueError(f"bad node_attr shape {tuple(node_attr_mat.shape)}")
    return mask_nodes(attr_vec, flags_vec), flags_vec
