"""Carry the JAX package's weights across to the port, and back.

``flax_to_state_dict`` turns a flax ``DiffuseSG`` parameter tree, given as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``, with or
without the top ``"params"`` level), into the port's ``state_dict`` (the
PyTorch reference's names and layouts).  It is the inverse of the mapping
in diffusesg_tpu/utils/torch_import.py:44-145 and imports nothing of it:
flax stores Linear kernels [in, out] and the port [out, in]; the patch
embedding is a Conv2d [D, Cin, p, p] whose flax Dense flattens (kh, kw, cin);
the readout's ConvTranspose2d [Cin, Cout, p, p] flattens (kh, kw, cout) with
its bias tiled p*p times.  ``state_dict_to_flax`` is the inverse, for
comparing gradients and updated parameters with the JAX package's leaf by
leaf.
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


# ------------------------------------------------------------- the inverse

def _n(t) -> np.ndarray:
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _inv_dense(sd: dict, prefix: str) -> dict:
    out = {"kernel": _n(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _n(sd[f"{prefix}.bias"])
    return out


def _inv_mlp(sd: dict, prefix: str, key: str = "") -> dict:
    out = {}
    for fc in ("fc1", "fc2"):
        out[f"{key}{fc}_kernel"] = _n(sd[f"{prefix}.{fc}.weight"]).T
        out[f"{key}{fc}_bias"] = _n(sd[f"{prefix}.{fc}.bias"])
    return out


def _inv_swin_block(sd: dict, prefix: str) -> dict:
    t = {"Dense_0": _inv_dense(sd, f"{prefix}.affine"),
         "norm1_scale": _n(sd[f"{prefix}.norm1.weight"]),
         "norm1_bias": _n(sd[f"{prefix}.norm1.bias"]),
         "relative_position_bias_table":
             _n(sd[f"{prefix}.attn.relative_position_bias_table"]),
         "norm2_scale": _n(sd[f"{prefix}.norm2.weight"]),
         "norm2_bias": _n(sd[f"{prefix}.norm2.bias"])}
    for name in ("qkv", "proj"):
        t[f"{name}_kernel"] = _n(sd[f"{prefix}.attn.{name}.weight"]).T
        t[f"{name}_bias"] = _n(sd[f"{prefix}.attn.{name}.bias"])
    t.update(_inv_mlp(sd, f"{prefix}.mlp", key="mlp_"))
    return t


def _inv_basic_layer(sd: dict, prefix: str) -> dict:
    t = {}
    if f"{prefix}.upsample.pre_linear.weight" in sd:
        t["PatchBreakup_0"] = {
            "pre_kernel": _n(sd[f"{prefix}.upsample.pre_linear.weight"]).T,
            "norm1_scale": _n(sd[f"{prefix}.upsample.norm.weight"]),
            "norm1_bias": _n(sd[f"{prefix}.upsample.norm.bias"]),
            "norm2_scale": _n(sd[f"{prefix}.upsample.post_norm.weight"]),
            "norm2_bias": _n(sd[f"{prefix}.upsample.post_norm.bias"]),
            "post_kernel": _n(sd[f"{prefix}.upsample.post_linear.weight"]).T}
    blocks = sorted({int(m.group(1)) for k in sd
                     if (m := re.match(re.escape(prefix) + r"\.blocks\.(\d+)\.", k))})
    for i in blocks:
        t[f"SwinBlock_{i}"] = _inv_swin_block(sd, f"{prefix}.blocks.{i}")
    if f"{prefix}.downsample.reduction.weight" in sd:
        t["PatchMerging_0"] = {
            "norm_scale": _n(sd[f"{prefix}.downsample.norm.weight"]),
            "norm_bias": _n(sd[f"{prefix}.downsample.norm.bias"]),
            "reduction_kernel": _n(sd[f"{prefix}.downsample.reduction.weight"]).T}
    return t


def state_dict_to_flax(sd: dict, patch_size: int = 1) -> dict:
    """The port's ``state_dict`` (or a dict of gradients under the same
    names) -> the flax-shaped tree of numpy arrays, the inverse of
    ``flax_to_state_dict``; every map is linear, so gradients carry over leaf
    by leaf.  The readout's transposed-convolution bias is tiled p*p times in
    flax: a parameter is tiled back, and for a gradient the caller sums the
    flax leaf's p*p tiles before comparing."""
    k = patch_size
    pe_w = _n(sd["patch_embed.proj.weight"])  # [D, Cin, kh, kw]
    d = pe_w.shape[0]
    pe = {"Dense_0": {"kernel": pe_w.transpose(2, 3, 1, 0).reshape(-1, d),
                      "bias": _n(sd["patch_embed.proj.bias"])},
          "NoiseAffine_0": {"Dense_0": _inv_dense(sd, "patch_embed.affine")}}
    if "patch_embed.norm.weight" in sd:
        pe["LayerNorm_0"] = {"scale": _n(sd["patch_embed.norm.weight"]),
                             "bias": _n(sd["patch_embed.norm.bias"])}
    w0 = _n(sd["read_out.0.weight"])  # [Cin, Cout, kh, kw]
    ro = {"Dense_0": {"kernel": w0.transpose(0, 2, 3, 1).reshape(w0.shape[0], -1),
                      "bias": np.tile(_n(sd["read_out.0.bias"]), k * k)}}
    for i in (1, 2):
        ro[f"Dense_{i}"] = {"kernel": _n(sd[f"read_out.{i}.weight"])[:, :, 0, 0].T,
                            "bias": _n(sd[f"read_out.{i}.bias"])}
    p = {"patch_embed": pe, "read_out": ro,
         "map_layer0": _inv_dense(sd, "map_layer0"),
         "map_layer1": _inv_dense(sd, "map_layer1"),
         "final_norm": {"scale": _n(sd["norm.weight"]), "bias": _n(sd["norm.bias"])},
         "readout_adj_mlp": _inv_mlp(sd, "readout_adj_mlp"),
         "readout_node_mlp": _inv_mlp(sd, "readout_node_mlp")}
    layers = sorted({(m.group(1), int(m.group(2))) for key in sd
                     if (m := re.match(r"(down|up)_layers\.(\d+)\.", key))})
    for kind, i in layers:
        p[f"{kind}_layers_{i}"] = _inv_basic_layer(sd, f"{kind}_layers.{i}")
    return {"params": p}
