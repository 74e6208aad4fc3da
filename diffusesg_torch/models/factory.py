"""Model factory: config -> DiffuseSG module with a seeded init.

Counterpart of diffusesg_tpu/models/factory.py.  The compute dtype comes
from the config's ``tpu.compute_dtype`` (bf16 for the two full configs),
parameters stay fp32; ``tpu.use_pallas_attention`` switches the hand-written
kernels on (the two full configs) or leaves every layer on its plain version
(``configs/vg_small_test.yaml``: float32, head_dim 16, which no kernel
covers).  Without a ``tpu:`` block the model runs its plain versions in
float32, as the JAX factory does.
"""
from __future__ import annotations

import torch
from torch import nn

from ..utils.device import resolve_device
from .channels import get_node_adj_model_input_output_channels
from .diffusesg import DiffuseSG

# heads are fixed per stage in the reference factory (learning_utils.py:56)
FIXED_NUM_HEADS = (3, 6, 12, 24)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _tpu(config):
    return config.get("tpu", None) or {}


def compute_dtype(config) -> torch.dtype:
    name = str(_tpu(config).get("compute_dtype", "float32"))
    if name not in _DTYPES:
        raise ValueError(f"unsupported compute_dtype {name!r}")
    return _DTYPES[name]


def use_kernels(config) -> bool:
    """The config's ``tpu.use_pallas_attention`` (false when missing)."""
    return bool(_tpu(config).get("use_pallas_attention", False))


def make_model(config) -> DiffuseSG:
    """The denoiser module for ``config``, parameters uninitialized."""
    if config.model.name != "diffuse_sg":
        raise ValueError(f"unknown model name {config.model.name}")
    in_chans, out_chans_adj, out_chans_node = get_node_adj_model_input_output_channels(config)
    depths = tuple(config.model.depths)
    return DiffuseSG(
        img_size=config.dataset.max_node_num,
        patch_size=config.model.patch_size,
        in_chans=in_chans,
        embed_dim=config.model.get("feature_dims", [96])[-1],
        depths=depths,
        num_heads=FIXED_NUM_HEADS[:len(depths)],
        window_size=config.model.window_size,
        mlp_ratio=4.0,
        out_chans_adj=out_chans_adj,
        out_chans_node=out_chans_node,
        self_condition=config.train.self_cond,
        symmetric_noise=not config.flag_sg,
        dtype=compute_dtype(config),
        use_kernels=use_kernels(config),
    )


def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded init on the CPU generator (so the weights do not depend on
    the device): trunc-normal std 0.02 within +-2 std for every weight
    matrix and bias table, zero biases, LayerNorm scale 1 and shift 0."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if isinstance(_owner(model, name), nn.LayerNorm):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                w = torch.empty(p.shape, dtype=torch.float32)
                nn.init.trunc_normal_(w, std=0.02, a=-0.04, b=0.04, generator=gen)
                p.copy_(w)
    return model


def _owner(model: nn.Module, param_name: str) -> nn.Module:
    return model.get_submodule(param_name.rpartition(".")[0])


def build_model(config, device: str | torch.device = "cuda", seed: int = 0) -> DiffuseSG:
    """The denoiser for ``config`` with seeded weights, on ``device``
    (``cuda`` unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    return init_params(make_model(config), seed).to(dev).eval()


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
