"""Swin-Transformer building blocks of the DiffuseSG denoiser (PyTorch).

Counterpart of diffusesg_tpu/models/layers.py.  Activations stay
channels-last ([B, L, C] tokens over an H x W grid); module and parameter
names follow the PyTorch reference's state dict (``attn.qkv``, ``norm1``,
``mlp.fc1``, ``affine``, ``upsample.pre_linear``, ...), so a reference
checkpoint's tensors map one to one.  Parameters stay fp32 and are cast to
the compute dtype at use.  Every layer that has a kernel takes
``use_kernels``, the config's ``tpu.use_pallas_attention`` as the JAX
``use_pallas`` is, and decides in one place: on, the Swin block, window
attention, merge, breakup and readout go through the kernel wrappers of
``diffusesg_torch.ops`` (hand-written CUDA on the card, which raise by name
on shapes or dtypes they do not cover; plain versions on the CPU); off, they
run their plain versions on whatever device the tensors are on,
differentiated by autograd, as the JAX package runs its XLA composition.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mlp_block_kernel import LN_EPS
from ..ops.patch_resample import (patch_breakup, patch_breakup_plain, patch_merge,
                                  patch_merge_plain)
from ..ops.readout_kernel import readout_mlp, readout_mlp_plain
from ..ops.swin_block_v3 import fused_swin_block, swin_block_plain
from ..ops.window_attention import attention_plain, fused_window_attention_qkhd

NOISE_EMB_CHANNELS = 512


def dense(x, linear: nn.Linear, dtype):
    """A Linear evaluated in ``dtype``, like flax ``nn.Dense(dtype=...)``."""
    bias = None if linear.bias is None else linear.bias.to(dtype)
    return F.linear(x.to(dtype), linear.weight.to(dtype), bias)


def relative_position_index(window: int) -> np.ndarray:
    """Static [window^2, window^2] lookup into the (2w-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def shifted_window_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """Static [nW, w*w, w*w] additive mask (0 / -100) for SW-MSA."""
    img_mask = np.zeros((1, h, w, 1), dtype=np.float32)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    mw = img_mask.reshape(1, h // window, window, w // window, window, 1)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window * window)
    attn_mask = mw[:, None, :] - mw[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


class Mlp(nn.Module):
    """Two Linear layers ``fc1``/``fc2``; as a readout head its forward is
    ``gelu(fc1(x))`` then ``fc2`` through the readout kernel (or its plain
    version), output in the compute dtype.  A Swin block holds one as the
    container of its MLP weights, as the reference does."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 dtype=torch.float32, use_kernels: bool = False):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)
        self.dtype, self.use_kernels = dtype, use_kernels

    def forward(self, x):
        c, dt = x.shape[-1], self.dtype
        readout = readout_mlp if self.use_kernels else readout_mlp_plain
        out = readout(x.reshape(-1, c).to(dt), self.fc1.weight.to(dt), self.fc1.bias,
                      self.fc2.weight.to(dt), self.fc2.bias)
        return out.reshape(*x.shape[:-1], self.fc2.out_features).to(dt)


class WindowAttention(nn.Module):
    """Window multi-head self-attention with relative-position bias: ``qkv``,
    ``proj`` and the bias table.  Inside a Swin block the block's kernel
    computes it from these parameters; called on its own, ``forward`` takes
    [nWB, L = window^2, C] tokens and an optional additive mask [nW, L, L]
    and runs the fused window-attention kernel (or its plain version) between
    the two Linears."""

    def __init__(self, dim: int, window: int, num_heads: int, dtype=torch.float32,
                 use_kernels: bool = False):
        super().__init__()
        self.dim, self.window, self.num_heads, self.dtype = dim, window, num_heads, dtype
        self.use_kernels = use_kernels
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(window).reshape(-1)),
                             persistent=False)

    def rel_bias(self) -> torch.Tensor:
        """[nH, L, L] fp32 relative-position bias."""
        L = self.window * self.window
        table = self.relative_position_bias_table
        return table[self.relative_position_index].reshape(L, L, -1).permute(2, 0, 1).contiguous()

    def forward(self, x, mask=None):
        nwb, L, c = x.shape
        head_dim = self.dim // self.num_heads
        qkv = dense(x, self.qkv, self.dtype).reshape(nwb, L, 3, self.num_heads, head_dim)
        q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.float32, device=x.device)
        attend = fused_window_attention_qkhd if self.use_kernels else attention_plain
        out = attend(q, k, v, self.rel_bias().float(), mask, head_dim ** -0.5)
        return dense(out.transpose(1, 2).reshape(nwb, L, c), self.proj, self.dtype)


class SwinBlock(nn.Module):
    """One Swin block with noise conditioning (reference:
    diffusesg.py:158-277): attention half then MLP half, as ONE call of
    ``ops.swin_block_v3.fused_swin_block`` (or of ``swin_block_plain``).
    Under tensor parallelism (``parallel.tp.shard_model`` sets ``tp``) its
    parameters are this rank's shards and it runs ``swin_block_plain`` over
    them, between the model group's collectives."""

    def __init__(self, dim: int, input_resolution, num_heads: int, window_size: int,
                 shift_size: int, mlp_ratio: float = 4.0, dtype=torch.float32,
                 use_kernels: bool = False):
        super().__init__()
        h, w = input_resolution
        window, shift = window_size, shift_size
        if min(h, w) <= window:
            # the window covers the whole grid: no shift (diffusesg.py:189-192)
            window, shift = min(h, w), 0
        self.input_resolution = (h, w)
        self.num_heads, self.window, self.shift, self.dtype = num_heads, window, shift, dtype
        self.use_kernels = use_kernels
        self.affine = nn.Linear(NOISE_EMB_CHANNELS, 2 * dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, window, num_heads, dtype, use_kernels)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype, use_kernels)
        mask = (torch.from_numpy(shifted_window_attn_mask(h, w, window, shift))
                if shift > 0 else None)
        self.register_buffer("attn_mask", mask, persistent=False)
        self.tp = None  # parallel.tp.BlockSplit under tensor parallelism

    def forward(self, x, emb):
        h, w = self.input_resolution
        b, L, c = x.shape
        dt = self.dtype
        scale_shift = dense(emb, self.affine, dt)
        a, m = self.attn, self.mlp
        if self.tp is not None:
            t = self.tp
            out = swin_block_plain(
                x.reshape(b, h, w, c).to(dt), scale_shift, self.norm1.weight, self.norm1.bias,
                a.qkv.weight.to(dt), a.qkv.bias, a.proj.weight.to(dt), t.attn_bias(a.proj.bias),
                t.heads_of(a.rel_bias()), self.attn_mask, self.norm2.weight, self.norm2.bias,
                m.fc1.weight.to(dt), m.fc1.bias, m.fc2.weight.to(dt), t.mlp_bias(m.fc2.bias),
                t.heads, self.window, self.shift, attn_tp=t.attn, mlp_tp=t.mlp)
            return out.reshape(b, L, c)
        block = fused_swin_block if self.use_kernels else swin_block_plain
        out = block(
            x.reshape(b, h, w, c).to(dt), scale_shift, self.norm1.weight, self.norm1.bias,
            a.qkv.weight.to(dt), a.qkv.bias, a.proj.weight.to(dt), a.proj.bias,
            a.rel_bias(), self.attn_mask, self.norm2.weight, self.norm2.bias,
            m.fc1.weight.to(dt), m.fc1.bias, m.fc2.weight.to(dt), m.fc2.bias,
            self.num_heads, self.window, self.shift)
        return out.reshape(b, L, c)


class PatchMerging(nn.Module):
    """2x downsample: 2x2 gather, LayerNorm(4C), Linear 4C -> 2C without bias."""

    def __init__(self, input_resolution, dim: int, dtype=torch.float32,
                 use_kernels: bool = False):
        super().__init__()
        self.input_resolution, self.dtype = tuple(input_resolution), dtype
        self.use_kernels = use_kernels
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        h, w = self.input_resolution
        b, L, c = x.shape
        merge = patch_merge if self.use_kernels else patch_merge_plain
        out = merge(x.reshape(b, h, w, c).to(self.dtype), self.norm.weight, self.norm.bias,
                    self.reduction.weight.to(self.dtype))
        return out.reshape(b, L // 4, -1)


class PatchBreakup(nn.Module):
    """2x upsample, the inverse of PatchMerging, fed [x | skip]."""

    def __init__(self, input_resolution, dim: int, skip_connection: bool = True,
                 dtype=torch.float32, use_kernels: bool = False):
        super().__init__()
        self.input_resolution, self.dtype = tuple(input_resolution), dtype
        self.use_kernels = use_kernels
        dim_inner = dim if skip_connection else 2 * dim
        c_out = dim_inner // 4
        self.pre_linear = nn.Linear(dim, dim_inner, bias=False)
        self.norm = nn.LayerNorm(dim_inner, eps=LN_EPS)
        self.post_norm = nn.LayerNorm(c_out, eps=LN_EPS)
        self.post_linear = nn.Linear(c_out, c_out, bias=False)

    def forward(self, x, skip=None):
        h, w = self.input_resolution
        b, L, _ = x.shape
        dt = self.dtype
        grid = lambda t: t.reshape(b, h, w, t.shape[-1]).to(dt)  # noqa: E731
        breakup = patch_breakup if self.use_kernels else patch_breakup_plain
        out = breakup(grid(x), None if skip is None else grid(skip),
                      self.pre_linear.weight.to(dt), self.norm.weight, self.norm.bias,
                      self.post_norm.weight, self.post_norm.bias,
                      self.post_linear.weight.to(dt))
        return out.reshape(b, 4 * L, -1)


class BasicLayer(nn.Module):
    """A stage: optional upsample -> depth x SwinBlock -> optional downsample."""

    def __init__(self, dim: int, input_resolution, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: float = 4.0, downsample: bool = False,
                 upsample: bool = False, dtype=torch.float32, use_kernels: bool = False):
        super().__init__()
        res = tuple(input_resolution)
        self.upsample = (PatchBreakup(res, dim * 4, skip_connection=True, dtype=dtype,
                                      use_kernels=use_kernels) if upsample else None)
        if upsample:
            res = (res[0] * 2, res[1] * 2)
        self.blocks = nn.ModuleList([
            SwinBlock(dim, res, num_heads, window_size,
                      shift_size=0 if i % 2 == 0 else window_size // 2,
                      mlp_ratio=mlp_ratio, dtype=dtype, use_kernels=use_kernels)
            for i in range(depth)])
        self.downsample = (PatchMerging(res, dim, dtype=dtype, use_kernels=use_kernels)
                           if downsample else None)

    def forward(self, x, emb, skip=None):
        if self.upsample is not None:
            x = self.upsample(x, skip)
        for blk in self.blocks:
            x = blk(x, emb)
        if self.downsample is not None:
            x = self.downsample(x)
        return x


class PositionalEmbedding(nn.Module):
    """Sin/cos noise-level embedding, EDM/DDPM++ style, in fp32 (max
    positions 10000, no endpoint, as the model uses it)."""

    def __init__(self, num_channels: int):
        super().__init__()
        self.num_channels = num_channels

    def forward(self, x):
        half = self.num_channels // 2
        freqs = torch.arange(half, dtype=torch.float32, device=x.device) / half
        freqs = torch.pow(1.0 / 10000, freqs)
        args = x[:, None].float() * freqs[None, :]
        return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class PatchEmbed(nn.Module):
    """The entry's parameters: the patchify (the reference's strided Conv2d,
    computed as space-to-depth + Linear), an optional LayerNorm, and the
    noise affine's Linear emb -> (scale | shift).  ``ops.patch_embed``
    computes the entry from them."""

    def __init__(self, img_size: int, patch_size: int, in_chans: int, embed_dim: int,
                 patch_norm: bool = True, dtype=torch.float32):
        super().__init__()
        self.patch_size, self.dtype = patch_size, dtype
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS) if patch_norm else None
        self.affine = nn.Linear(NOISE_EMB_CHANNELS, 2 * embed_dim)

    def linear(self):
        """The patchify as a Linear (weight [D, p p Cin], its columns in
        (kh, kw, c) order; bias) in the compute dtype."""
        w = self.proj.weight.permute(0, 2, 3, 1).reshape(self.proj.out_channels, -1)
        return w.to(self.dtype), self.proj.bias.to(self.dtype)


class ReadOut(nn.Module):
    """The exit's un-patchify and two pointwise layers: the reference's
    ConvTranspose2d(p) and two 1x1 Conv2d (children ``0``, ``1``, ``2``),
    computed as a Linear put depth-to-space and two Linears by
    ``ops.readout_kernel``."""

    def __init__(self, patch_size: int, embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.patch_size, self.dtype = patch_size, dtype
        self.add_module("0", nn.ConvTranspose2d(embed_dim, embed_dim, patch_size, patch_size))
        self.add_module("1", nn.Conv2d(embed_dim, embed_dim, 1))
        self.add_module("2", nn.Conv2d(embed_dim, embed_dim, 1))

    def linears(self):
        """The three products as Linear (weight [out, in], bias) pairs in the
        compute dtype: the up-projection, its rows (kh, kw, cout), then the
        two 1x1 convs."""
        p, dt = self.patch_size, self.dtype
        up, pw1, pw2 = (getattr(self, k) for k in "012")
        w0 = up.weight.permute(2, 3, 1, 0).reshape(p * p * up.out_channels, -1)
        return [(w0.to(dt), up.bias.repeat(p * p).to(dt))] + [
            (conv.weight[:, :, 0, 0].to(dt), conv.bias.to(dt)) for conv in (pw1, pw2)]
