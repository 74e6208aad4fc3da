"""One whole Swin block (forward): the attention half, then the MLP half.

Counterpart of diffusesg_tpu/ops/swin_block_v3.py (forward only):

    a   = silu(shift + x * (scale + 1))
    y   = a + proj(W-MSA(qkv(LN1(a))))          (+ shifted-window mask)
    out = y + fc2(gelu(fc1(LN2(y))))

On a CUDA tensor the attention half runs as the hand-written kernel
``swin_attn`` (csrc/swin_attn.cu) and the MLP half as ``token_mlp``; on a
CPU tensor both run their plain versions, composed exactly as the JAX CPU
path composes ``swin_attn_block_xla`` and ``mlp_block_xla``.

Unlike the JAX entry, ``x`` is NOT pre-rolled: ``shift`` is passed in.  The
plain version rolls and unrolls like the reference; the kernel folds the
roll into its window index math, so both take and return the unrolled
spatial layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_build
from .mlp_block_kernel import layer_norm, token_mlp

NAME = "swin_attn"


def swin_attn_block_plain(x, scale_shift, ln_gamma, ln_beta, wqkv, bqkv, wproj, bproj,
                          rel_bias, mask, num_heads: int, window: int, shift: int = 0):
    """Attention half, x [B, H, W, C] (unrolled), scale_shift [B, 2C],
    rel_bias [nH, L, L], mask [nW, L, L] or None (reference:
    swin_attn_block_xla, with the roll of layers.SwinBlock around it)."""
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    b, h, w, c = x.shape
    dt = x.dtype
    scale, sh = scale_shift[:, None, None, :].float().chunk(2, dim=-1)
    a = F.silu(sh + x.float() * (scale + 1.0)).to(dt)
    hn = layer_norm(a, ln_gamma, ln_beta).to(dt)

    L = window * window
    hw, ww = h // window, w // window
    xw = hn.reshape(b, hw, window, ww, window, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, L, c)
    qkv = F.linear(xw.float(), wqkv.float(), bqkv.float()).to(dt)
    hd = c // num_heads
    qkv = qkv.reshape(-1, L, 3, num_heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2).float() for i in range(3))  # [nWB, nH, L, hd]
    scores = (q * hd ** -0.5) @ k.transpose(-1, -2) + rel_bias[None].float()
    if mask is not None:
        nw = mask.shape[0]
        scores = scores + mask.float()[:, None].repeat(scores.shape[0] // nw, 1, 1, 1)
    probs = torch.softmax(scores, dim=-1).to(dt)
    out = (probs.float() @ v).to(dt).transpose(1, 2).reshape(-1, L, c)
    out = F.linear(out.float(), wproj.float(), bproj.float())
    out = out.reshape(b, hw, ww, window, window, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
    y = (a.float() + out).to(dt)
    if shift > 0:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    return y


def swin_attn(x, scale_shift, ln_gamma, ln_beta, wqkv, bqkv, wproj, bproj, rel_bias, mask,
              num_heads: int, window: int, shift: int = 0):
    """Attention half; the kernel on CUDA tensors, the plain version on CPU."""
    if x.device.type == "cpu":
        return swin_attn_block_plain(x, scale_shift, ln_gamma, ln_beta, wqkv, bqkv, wproj,
                                     bproj, rel_bias, mask, num_heads, window, shift)
    b, h, w, c = x.shape
    if window != 8 or c != 32 * num_heads or h % window or w % window:
        raise ValueError(f"swin_attn covers window 8 and head_dim 32; got window={window} "
                         f"C={c} heads={num_heads} grid={h}x{w}")
    bf, f32 = torch.bfloat16, torch.float32
    x = cuda_build.require(x, bf, "x")
    ss = cuda_build.require(scale_shift, bf, "scale_shift")
    wqkv = cuda_build.require(wqkv, bf, "wqkv")
    wproj = cuda_build.require(wproj, bf, "wproj")
    g, bt, bqkv, bproj, rel = (cuda_build.require(t, f32, n) for t, n in (
        (ln_gamma, "ln_gamma"), (ln_beta, "ln_beta"), (bqkv, "bqkv"), (bproj, "bproj"),
        (rel_bias, "rel_bias")))
    if mask is not None:
        mask = cuda_build.require(mask, f32, "mask")
    m = b * h * w
    a, hn, attn = (torch.empty((m, c), dtype=bf, device=x.device) for _ in range(3))
    qkv = torch.empty((m, 3 * c), dtype=bf, device=x.device)
    out = torch.empty_like(x)
    p = cuda_build.ptr
    rc = cuda_build.lib().dsg_swin_attn(
        p(x), p(ss), p(g), p(bt), p(wqkv), p(bqkv), p(wproj), p(bproj), p(rel), p(mask),
        p(a), p(hn), p(qkv), p(attn), p(out), b, h, w, c, num_heads, window, shift,
        cuda_build.stream_ptr(x.device))
    cuda_build.check(rc, NAME)
    cuda_build.count_launch(NAME, f"{h}x{w}xC{c}" + (f" shift{shift}" if shift else ""))
    return out


def fused_swin_block(x, scale_shift, ln1_g, ln1_b, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                     ln2_g, ln2_b, w1, b1, w2, b2, num_heads: int, window: int,
                     shift: int = 0):
    """Whole block: ``swin_attn`` then ``token_mlp`` (kernels on CUDA)."""
    y = swin_attn(x, scale_shift, ln1_g, ln1_b, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                  num_heads, window, shift)
    return token_mlp(y, ln2_g, ln2_b, w1, b1, w2, b2)
