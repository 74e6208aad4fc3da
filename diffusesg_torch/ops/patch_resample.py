"""PatchMerging / PatchBreakup: the U-Net's 2x down- and upsampling.

Counterpart of diffusesg_tpu/ops/patch_resample.py (forward only).  On a
CUDA tensor they run as the hand-written kernels ``patch_merge`` and
``patch_breakup`` (csrc/patch_resample.cu); on a CPU tensor as the plain
versions below.  Channel orders match the reference: merge concatenates
[x(0,0), x(1,0), x(0,1), x(1,1)] (h-offset fastest), breakup maps chunk k
to the offset (ho = k % 2, wo = k // 2).  Weights are in the PyTorch Linear
layout ([out, in]).

The breakup takes the U-Net's skip as a second argument: the plain version
concatenates it, the kernel reads both sources without a copy.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_build
from .mlp_block_kernel import layer_norm


def patch_merge_plain(x, ln_g, ln_b, w):
    """[B, H, W, C] -> [B, H/2, W/2, 2C] (reference: patch_merge_xla)."""
    b, h, ww, c = x.shape
    x = x.reshape(b, h // 2, 2, ww // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
    x = x.reshape(b, h // 2, ww // 2, 4 * c)
    x = layer_norm(x, ln_g, ln_b).to(w.dtype)
    return F.linear(x.float(), w.float()).to(w.dtype)


def patch_merge(x, ln_g, ln_b, w):
    """PatchMerging; the kernel on CUDA tensors, the plain version on CPU."""
    if x.device.type == "cpu":
        return patch_merge_plain(x, ln_g, ln_b, w)
    b, h, ww, c = x.shape
    c_out = w.shape[0]
    if h % 2 or ww % 2 or c % 8 or w.shape[1] != 4 * c:
        raise ValueError(f"patch_merge shapes x{tuple(x.shape)} w{tuple(w.shape)} "
                         "are not supported")
    x = cuda_build.require(x, torch.bfloat16, "x")
    w = cuda_build.require(w, torch.bfloat16, "w")
    g = cuda_build.require(ln_g, torch.float32, "ln_g")
    bt = cuda_build.require(ln_b, torch.float32, "ln_b")
    gathered = torch.empty((b * (h // 2) * (ww // 2), 4 * c), dtype=torch.bfloat16,
                           device=x.device)
    out = torch.empty((b, h // 2, ww // 2, c_out), dtype=torch.bfloat16, device=x.device)
    p = cuda_build.ptr
    rc = cuda_build.lib().dsg_patch_merge(p(x), p(g), p(bt), p(w), p(gathered), p(out), b, h,
                                          ww, c, c_out, cuda_build.stream_ptr(x.device))
    cuda_build.check(rc, "patch_merge")
    cuda_build.count_launch("patch_merge", f"{h}x{ww}xC{c}")
    return out


def patch_breakup_plain(x, skip, w_in, ln1_g, ln1_b, ln2_g, ln2_b, w_out):
    """[B, H, W, C1] (+ skip [B, H, W, C2]) -> [B, 2H, 2W, c]
    (reference: patch_breakup_xla on the concatenated input)."""
    if skip is not None:
        x = torch.cat([x, skip], dim=-1)
    b, h, ww, _ = x.shape
    dim = w_in.shape[0]
    c_out = dim // 4
    y = F.linear(x.to(w_in.dtype).float(), w_in.float())
    y = layer_norm(y, ln1_g, ln1_b).to(w_in.dtype)
    y = y.reshape(b, h, ww, 2, 2, c_out).permute(0, 1, 4, 2, 3, 5)  # [b, h, ho, w, wo, c]
    y = y.reshape(b, 2 * h, 2 * ww, c_out)
    y = layer_norm(y, ln2_g, ln2_b).to(w_out.dtype)
    return F.linear(y.float(), w_out.float()).to(w_out.dtype)


def patch_breakup(x, skip, w_in, ln1_g, ln1_b, ln2_g, ln2_b, w_out):
    """PatchBreakup; the kernel on CUDA tensors, the plain version on CPU."""
    if x.device.type == "cpu":
        return patch_breakup_plain(x, skip, w_in, ln1_g, ln1_b, ln2_g, ln2_b, w_out)
    b, h, ww, c1 = x.shape
    c2 = 0 if skip is None else skip.shape[-1]
    dim = w_in.shape[0]
    c = dim // 4
    if (w_in.shape[1] != c1 + c2 or dim % 32 or c1 % 8 or c2 % 8
            or tuple(w_out.shape) != (c, c)
            or (skip is not None and skip.shape[:3] != x.shape[:3])):
        raise ValueError(f"patch_breakup shapes x{tuple(x.shape)} w_in{tuple(w_in.shape)} "
                         "are not supported")
    bf, f32 = torch.bfloat16, torch.float32
    x = cuda_build.require(x, bf, "x")
    if skip is not None:
        skip = cuda_build.require(skip, bf, "skip")
    w_in = cuda_build.require(w_in, bf, "w_in")
    w_out = cuda_build.require(w_out, bf, "w_out")
    g1, b1, g2, b2 = (cuda_build.require(t, f32, n) for t, n in (
        (ln1_g, "ln1_g"), (ln1_b, "ln1_b"), (ln2_g, "ln2_g"), (ln2_b, "ln2_b")))
    m = b * h * ww
    y = torch.empty((m, dim), dtype=f32, device=x.device)
    z = torch.empty((m, dim), dtype=bf, device=x.device)
    scattered = torch.empty((4 * m, c), dtype=bf, device=x.device)
    out = torch.empty((b, 2 * h, 2 * ww, c), dtype=bf, device=x.device)
    p = cuda_build.ptr
    rc = cuda_build.lib().dsg_patch_breakup(
        p(x), p(skip), c1, c2, p(w_in), p(g1), p(b1), p(g2), p(b2), p(w_out), p(y), p(z),
        p(scattered), p(out), b, h, ww, dim, cuda_build.stream_ptr(x.device))
    cuda_build.check(rc, "patch_breakup")
    cuda_build.count_launch("patch_breakup", f"{h}x{ww}xC{c1 + c2}->{c}")
    return out
