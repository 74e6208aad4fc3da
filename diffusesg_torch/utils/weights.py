"""Carry the JAX package's weights across to the port.

``flax_to_state_dict`` turns a flax ``DiffuseSG`` parameter tree, given as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``, with or
without the top ``"params"`` level), into the port's ``state_dict`` (the
PyTorch reference's names and layouts).  It is the inverse of the mapping
in diffusesg_tpu/utils/torch_import.py:44-145 and imports nothing of it:
flax stores Linear kernels [in, out] and the port [out, in]; the patch
embedding is a Conv2d [D, Cin, p, p] whose flax Dense flattens (kh, kw, cin);
the readout's ConvTranspose2d [Cin, Cout, p, p] flattens (kh, kw, cout) with
its bias tiled p*p times.
"""
from __future__ import annotations

import re

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(out: dict, prefix: str, tree: dict) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])


def _ln(out: dict, prefix: str, scale, bias) -> None:
    out[f"{prefix}.weight"] = _t(scale)
    out[f"{prefix}.bias"] = _t(bias)


def _mlp(out: dict, prefix: str, tree: dict, key: str = "") -> None:
    for fc in ("fc1", "fc2"):
        out[f"{prefix}.{fc}.weight"] = _t(np.asarray(tree[f"{key}{fc}_kernel"]).T)
        out[f"{prefix}.{fc}.bias"] = _t(tree[f"{key}{fc}_bias"])


def _swin_block(out: dict, prefix: str, t: dict) -> None:
    _dense(out, f"{prefix}.affine", t["Dense_0"])
    _ln(out, f"{prefix}.norm1", t["norm1_scale"], t["norm1_bias"])
    out[f"{prefix}.attn.relative_position_bias_table"] = _t(t["relative_position_bias_table"])
    for name in ("qkv", "proj"):
        out[f"{prefix}.attn.{name}.weight"] = _t(np.asarray(t[f"{name}_kernel"]).T)
        out[f"{prefix}.attn.{name}.bias"] = _t(t[f"{name}_bias"])
    _ln(out, f"{prefix}.norm2", t["norm2_scale"], t["norm2_bias"])
    _mlp(out, f"{prefix}.mlp", t, key="mlp_")


def _basic_layer(out: dict, prefix: str, t: dict) -> None:
    if "PatchBreakup_0" in t:
        u = t["PatchBreakup_0"]
        out[f"{prefix}.upsample.pre_linear.weight"] = _t(np.asarray(u["pre_kernel"]).T)
        _ln(out, f"{prefix}.upsample.norm", u["norm1_scale"], u["norm1_bias"])
        _ln(out, f"{prefix}.upsample.post_norm", u["norm2_scale"], u["norm2_bias"])
        out[f"{prefix}.upsample.post_linear.weight"] = _t(np.asarray(u["post_kernel"]).T)
    for key in sorted(k for k in t if k.startswith("SwinBlock_")):
        _swin_block(out, f"{prefix}.blocks.{key.split('_')[1]}", t[key])
    if "PatchMerging_0" in t:
        d = t["PatchMerging_0"]
        _ln(out, f"{prefix}.downsample.norm", d["norm_scale"], d["norm_bias"])
        out[f"{prefix}.downsample.reduction.weight"] = _t(np.asarray(d["reduction_kernel"]).T)


def flax_to_state_dict(params: dict, patch_size: int = 1) -> dict[str, torch.Tensor]:
    """flax DiffuseSG params (numpy leaves) -> the port's ``state_dict``."""
    p = params.get("params", params)
    k = patch_size
    out: dict[str, torch.Tensor] = {}

    pe = p["patch_embed"]
    kernel = np.asarray(pe["Dense_0"]["kernel"])  # [(kh kw cin), D]
    d = kernel.shape[1]
    out["patch_embed.proj.weight"] = _t(kernel.reshape(k, k, -1, d).transpose(3, 2, 0, 1))
    out["patch_embed.proj.bias"] = _t(pe["Dense_0"]["bias"])
    if "LayerNorm_0" in pe:
        _ln(out, "patch_embed.norm", pe["LayerNorm_0"]["scale"], pe["LayerNorm_0"]["bias"])
    _dense(out, "patch_embed.affine", pe["NoiseAffine_0"]["Dense_0"])

    _dense(out, "map_layer0", p["map_layer0"])
    _dense(out, "map_layer1", p["map_layer1"])
    _ln(out, "norm", p["final_norm"]["scale"], p["final_norm"]["bias"])
    _mlp(out, "readout_adj_mlp", p["readout_adj_mlp"])
    _mlp(out, "readout_node_mlp", p["readout_node_mlp"])

    ro = p["read_out"]
    k0 = np.asarray(ro["Dense_0"]["kernel"])  # [Cin, (kh kw cout)]
    cin = k0.shape[0]
    out["read_out.0.weight"] = _t(k0.reshape(cin, k, k, -1).transpose(0, 3, 1, 2))
    out["read_out.0.bias"] = _t(np.asarray(ro["Dense_0"]["bias"])[:k0.shape[1] // (k * k)])
    for i in (1, 2):
        dense = ro[f"Dense_{i}"]
        out[f"read_out.{i}.weight"] = _t(np.asarray(dense["kernel"]).T[:, :, None, None])
        out[f"read_out.{i}.bias"] = _t(dense["bias"])

    for key in p:
        m = re.fullmatch(r"(down|up)_layers_(\d+)", key)
        if m:
            _basic_layer(out, f"{m.group(1)}_layers.{m.group(2)}", p[key])
    return out
