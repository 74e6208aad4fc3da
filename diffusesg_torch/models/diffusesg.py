"""DiffuseSG denoiser: Swin-Transformer U-Net over the N x N node-pair grid.

Counterpart of diffusesg_tpu/models/diffusesg.py, same channels-last
contract:

  inputs:  adj [B, N, N] or [B, N, N, C_a];  node [B, N] or [B, N, C_x];
           node_flags [B, N];  noise_labels [B];  optional self-cond tensors
           shaped like adj / node
  outputs: (adj_out, node_out), out channels squeezed when 1, masked, adj
           symmetrized when symmetric_noise.

The grid input is [sc_a ; adj] then [sc_x ; node] tiled as
[adj ; node_i ; node_j], as in the reference.

The two full-resolution ends are ops like every layer with a kernel, chosen
by ``use_kernels`` alone: the entry (input assembly, PatchEmbed, its
LayerNorm and noise affine) is ``ops.patch_embed``, the exit (the final
LayerNorm, ReadOut, the adjacency head and the node pooling)
``ops.readout_kernel.output_head``, or their plain versions with the
kernels off.  Each op decides from its operands where its kernel runs.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import patch_embed as pe
from ..ops import readout_kernel as rk
from ..ops.masking import mask_adjs, mask_nodes, symmetrize
from ..ops.mlp_block_kernel import LN_EPS
from .layers import (NOISE_EMB_CHANNELS, BasicLayer, Mlp, PatchEmbed, PositionalEmbedding,
                     ReadOut, dense)


class DiffuseSG(nn.Module):
    """Joint node + adjacency denoiser (reference: diffusesg.py:587-830)."""

    def __init__(self, img_size: int = 64, patch_size: int = 1, in_chans: int = 3,
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, out_chans_adj: int = 1, out_chans_node: int = 1,
                 patch_norm: bool = True, self_condition: bool = False,
                 symmetric_noise: bool = True, dtype=torch.float32, use_kernels: bool = False):
        super().__init__()
        n_layers = len(depths)
        pres = img_size // patch_size
        self.patches_resolution = (pres, pres)
        self.out_chans_adj, self.out_chans_node = out_chans_adj, out_chans_node
        self.self_condition, self.symmetric_noise, self.dtype = (
            self_condition, symmetric_noise, dtype)
        # the config's tpu.use_pallas_attention: every layer with a kernel
        # runs it (on), or its plain version (off)
        self.use_kernels = use_kernels
        in_ch = in_chans * 2 if self_condition else in_chans

        self.patch_embed = PatchEmbed(img_size, patch_size, in_ch, embed_dim, patch_norm, dtype)
        self.down_layers = nn.ModuleList([
            BasicLayer(int(embed_dim * 2 ** i), (pres // 2 ** i, pres // 2 ** i), depths[i],
                       num_heads[i], window_size, mlp_ratio, downsample=i < n_layers - 1,
                       upsample=False, dtype=dtype, use_kernels=use_kernels)
            for i in range(n_layers)])
        up = []
        for i in range(n_layers):
            rest = n_layers - i - 1
            scale = 2 ** rest if i == 0 else 2 ** (rest + 1)
            up.append(BasicLayer(int(embed_dim * 2 ** rest), (pres // scale, pres // scale),
                                 depths[rest], num_heads[rest], window_size, mlp_ratio,
                                 downsample=False, upsample=i > 0, dtype=dtype,
                                 use_kernels=use_kernels))
        self.up_layers = nn.ModuleList(up)

        self.map_noise = PositionalEmbedding(embed_dim)
        self.map_layer0 = nn.Linear(embed_dim, NOISE_EMB_CHANNELS)
        self.map_layer1 = nn.Linear(NOISE_EMB_CHANNELS, NOISE_EMB_CHANNELS)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.read_out = ReadOut(patch_size, embed_dim, dtype)
        self.readout_adj_mlp = Mlp(embed_dim, embed_dim, out_chans_adj, dtype, use_kernels)
        self.readout_node_mlp = Mlp(embed_dim, embed_dim, out_chans_node, dtype, use_kernels)

    def forward_features(self, x, emb):
        """The U-Net's stages over the embedded rows [B, L, D] -> [B, L, D]
        in the compute dtype."""
        skips = []
        for layer in self.down_layers:
            x = layer(x, emb)
            skips.append(x)
        for layer in self.up_layers:
            # the deepest layer's skip is popped and discarded (diffusesg.py:750-756)
            skip = skips.pop()
            x = layer(x, emb, skip) if layer.upsample is not None else layer(x, emb)
        return x

    def forward(self, adj, node, node_flags, noise_labels, self_cond_adj=None,
                self_cond_node=None):
        dt = self.dtype
        flag_node_only = node_flags.ndim == 3
        emb = self.map_noise(noise_labels)
        emb = F.silu(dense(emb, self.map_layer0, dt))
        emb = F.silu(dense(emb, self.map_layer1, dt))

        if adj.ndim == 3:
            adj = adj[..., None]
        if node.ndim == 2:
            node = node[..., None]
        sc_a = sc_x = None
        if self.self_condition:
            if self_cond_adj is not None:
                sc_a = self_cond_adj[..., None] if self_cond_adj.ndim == 3 else self_cond_adj
            if self_cond_node is not None:
                sc_x = self_cond_node[..., None] if self_cond_node.ndim == 2 else self_cond_node

        embed = self.patch_embed
        norm = (None, None) if embed.norm is None else (embed.norm.weight, embed.norm.bias)
        entry = pe.patch_embed if self.use_kernels else pe.patch_embed_plain
        x = entry(adj, node, node_flags, sc_a, sc_x, *embed.linear(), *norm,
                  dense(emb, embed.affine, dt), self.self_condition, embed.patch_size)
        x = self.forward_features(x, emb)

        ph, pw = self.patches_resolution
        a = self.readout_adj_mlp
        head = rk.output_head if self.use_kernels else rk.output_head_plain
        adj_out, node_feat = head(
            x.reshape(x.shape[0], ph, pw, -1), self.norm.weight, self.norm.bias,
            *(t for pair in self.read_out.linears() for t in pair),
            a.fc1.weight.to(dt), a.fc1.bias, a.fc2.weight.to(dt), a.fc2.bias, node_flags,
            patch_size=self.read_out.patch_size)
        if self.out_chans_adj == 1:
            adj_out = adj_out[..., 0]
        node_out = self.readout_node_mlp(node_feat).float()
        if self.out_chans_node == 1:
            node_out = node_out[..., 0]

        node_out = mask_nodes(node_out, node_flags) if not flag_node_only else node_out * 0.0
        adj_out = mask_adjs(adj_out, node_flags)
        if self.symmetric_noise:
            adj_out = symmetrize(adj_out)
        return adj_out, node_out
