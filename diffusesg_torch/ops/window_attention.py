"""Fused window attention: ``softmax(scale q k^T + rel_bias (+ mask)) v``.

Counterpart of diffusesg_tpu/ops/window_attention.py.  q, k, v are
[nWB, nH, L, hd] (window-batch major), ``rel_bias`` [nH, L, L] and the
optional shifted-window ``mask`` [nW, L, L]; the bias is never materialized
at [nWB, nH, L, L].  On a CUDA tensor the forward is the hand-written kernel
``window_attention`` (csrc/window_attention.cu: the window core of the Swin
block with separate q, k, v operands, scores and probabilities in registers
only), which
covers head_dim 32 with L = 64 or L = 100 in bf16 and raises for anything
else; on a CPU tensor it is ``attention_plain``, which is general.  The
backward recomputes the plain version and differentiates it, as the JAX
``custom_vjp`` differentiates ``_attention_xla``.
"""
from __future__ import annotations

import torch

from . import cuda_build
from .mlp_block_kernel import up
from .swin_block_v3 import WINDOWS, window_core_plan

NAME = "window_attention"
LENGTHS = tuple(w * w for w in WINDOWS)  # window lengths the kernel is built for
HEAD_DIM = 32


def attention_plain(q, k, v, rel_bias, mask=None, scale: float = 1.0):
    """q, k, v [nWB, nH, L, hd] -> [nWB, nH, L, hd] in q's dtype; scores and
    softmax in fp32, the probabilities rounded to q's dtype before the
    product with v (reference: _attention_xla)."""
    scores = (up(q) @ up(k).transpose(-1, -2)) * scale + up(rel_bias)[None]
    if mask is not None:
        nw = mask.shape[0]
        scores = scores + up(mask)[:, None].repeat(q.shape[0] // nw, 1, 1, 1)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return (up(probs) @ up(v)).to(q.dtype)


def window_attention_fwd(q, k, v, rel_bias, mask=None, scale: float = 1.0):
    """Forward alone: the kernel on CUDA tensors, the plain version on CPU."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, rel_bias, mask, scale)
    nwb, nh, L, hd = q.shape
    if L not in LENGTHS or hd != HEAD_DIM:
        raise ValueError(f"window_attention covers L in {LENGTHS} and head_dim {HEAD_DIM}; "
                         f"got L={L} head_dim={hd}")
    if k.shape != q.shape or v.shape != q.shape or tuple(rel_bias.shape) != (nh, L, L):
        raise ValueError(f"window_attention shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} rel_bias{tuple(rel_bias.shape)} do not match")
    q, k, v = (cuda_build.require(t, torch.bfloat16, n) for t, n in ((q, "q"), (k, "k"), (v, "v")))
    rel = cuda_build.require(rel_bias, torch.float32, "rel_bias")
    mask_n = 0
    if mask is not None:
        mask = cuda_build.require(mask, torch.float32, "mask")
        mask_n = mask.shape[0]
        if tuple(mask.shape[1:]) != (L, L) or nwb % mask_n:
            raise ValueError(f"mask{tuple(mask.shape)} does not tile {nwb} windows of {L} tokens")
    out = torch.empty_like(q)
    per_sm = cuda_build.blocks_per_sm(q.device, "dsg_window_attention_per_sm", L)
    wpb = window_core_plan(nwb, nh, mask_n, per_sm, cuda_build.sm_count(q.device))
    p = cuda_build.ptr
    cuda_build.launch(NAME, q.device, "dsg_window_attention",
                      p(q), p(k), p(v), p(rel), p(mask), p(out), nwb, nh, L, hd, mask_n, wpb,
                      float(scale))
    cuda_build.count_launch(NAME, f"{nwb}x{nh}xL{L}" + (" mask" if mask is not None else ""))
    return out


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel_bias, mask, scale):
        ctx.save_for_backward(q, k, v, rel_bias, mask)
        ctx.scale = scale
        return window_attention_fwd(q, k, v, rel_bias, mask, scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, rel_bias, mask = ctx.saved_tensors
        grads = cuda_build.plain_vjp(
            lambda q_, k_, v_, rel_: attention_plain(q_, k_, v_, rel_, mask, ctx.scale),
            (q, k, v, rel_bias), grad_out)
        # the mask is a constant of the geometry: no gradient
        return (*grads, None, None)


def fused_window_attention_qkhd(q, k, v, rel_bias, mask=None, scale: float = 1.0):
    """Fused ``softmax(q k^T scale + rel_bias [+ mask]) v``, differentiable.

    q, k, v: [nWB, nH, L, hd]; rel_bias: [nH, L, L]; mask: [nW, L, L] additive
    shifted-window mask or None (more masks than windows are trimmed).
    Returns [nWB, nH, L, hd]."""
    if mask is not None and mask.shape[0] > q.shape[0]:
        mask = mask[: q.shape[0]]
    return _WindowAttention.apply(q, k, v, rel_bias, mask, float(scale))
