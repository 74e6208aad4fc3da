"""Random weights from the seed, made on the device in one call.

Every value comes from one ``randn`` over all of them, on a
``torch.Generator`` of the device, in the order of the names given, in
float32 (the type the parameters are held and served in: the model casts
them to bfloat16 at use).  The scales keep each layer's output of the order
of its input, so that the denoiser's output is of the order of one and
moves the sampled graphs and the loss (the published initialisation's std
of 0.02 leaves the untrained network's output near 1e-4, and a check of it
would check little): a weight matrix std 1 / sqrt(fan in), cut at two std;
a relative-position bias table std 0.5; a bias std 0.1; a LayerNorm's
scale 1 and shift 0, each plus std 0.1.
"""
from __future__ import annotations

import math
import re

import torch

from .noise import key

WEIGHT_STREAM = 3
_NORM = re.compile(r"(^|\.)(norm\d?|post_norm)\.(weight|bias)$")
# a transposed convolution holds [in, out, kh, kw]
_TRANSPOSED = re.compile(r"(^|\.)read_out\.0\.weight$")


def _scale(name: str, shape) -> tuple[float, float, float | None]:
    """(offset, std, cut) of a leaf: value = offset + std * clamp(n, -cut, cut)."""
    m = _NORM.search(name)
    if m:
        return (1.0 if m.group(3) == "weight" else 0.0), 0.1, None
    if name.endswith(".bias"):
        return 0.0, 0.1, None
    if name.endswith("relative_position_bias_table"):
        return 0.0, 0.5, None
    fan_in = shape[0] if _TRANSPOSED.search(name) else math.prod(shape[1:])
    return 0.0, fan_in ** -0.5, 2.0


def make(shapes: dict, seed: int, device) -> dict:
    """name -> float32 tensor on ``device`` for ``shapes`` (name -> shape)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(key(seed, WEIGHT_STREAM))
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=dev)
    out, at = {}, 0
    for name, shape in shapes.items():
        size = math.prod(shape)
        offset, std, cut = _scale(name, shape)
        z = flat[at:at + size].view(shape)
        if cut is not None:
            z = z.clamp(-cut, cut)
        out[name] = z * std + offset
        at += size
    return out
