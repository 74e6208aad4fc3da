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
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masking import mask_adjs, mask_nodes, symmetrize
from ..ops.mlp_block_kernel import LN_EPS, layer_norm
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
        """U-Net core over [B, H, W, C_in] -> [B, H, W, D] in the compute dtype."""
        x = self.patch_embed(x, emb)
        skips = []
        for layer in self.down_layers:
            x = layer(x, emb)
            skips.append(x)
        for layer in self.up_layers:
            # the deepest layer's skip is popped and discarded (diffusesg.py:750-756)
            skip = skips.pop()
            x = layer(x, emb, skip) if layer.upsample is not None else layer(x, emb)
        x = layer_norm(x, self.norm.weight, self.norm.bias).to(self.dtype)
        ph, pw = self.patches_resolution
        return self.read_out(x, ph, pw)

    def forward(self, adj, node, node_flags, noise_labels, self_cond_adj=None,
                self_cond_node=None):
        dt = self.dtype
        flag_node_only = node_flags.ndim == 3
        emb = self.map_noise(noise_labels)
        emb = F.silu(dense(emb, self.map_layer0, dt))
        emb = F.silu(dense(emb, self.map_layer1, dt))

        if adj.ndim == 3:
            adj = adj[..., None]
        node = node.float()
        if node.ndim == 2:
            node = node[..., None]
        if self.self_condition:
            sc_a = torch.zeros_like(adj) if self_cond_adj is None else (
                self_cond_adj[..., None] if self_cond_adj.ndim == 3 else self_cond_adj)
            sc_x = torch.zeros_like(node) if self_cond_node is None else (
                self_cond_node[..., None] if self_cond_node.ndim == 2 else self_cond_node)
            adj = torch.cat([sc_a.to(adj.dtype), adj], dim=-1)
            node = torch.cat([sc_x.float(), node], dim=-1)

        b, n = node.shape[:2]
        node_mat = node[:, :, None, :].expand(b, n, n, node.shape[-1])
        node_cat = mask_adjs(torch.cat([node_mat, node_mat.transpose(1, 2)], dim=-1), node_flags)
        x = torch.cat([adj.to(node_cat.dtype), node_cat], dim=-1).to(dt)
        shared = self.forward_features(x, emb)

        adj_out = self.readout_adj_mlp(shared).float()
        if self.out_chans_adj == 1:
            adj_out = adj_out[..., 0]
        # padding-aware pooled node readout: full-N mean divisor, fp32 sum
        node_feat = torch.mean(mask_adjs(shared, node_flags), dim=2, dtype=torch.float32).to(dt)
        node_out = self.readout_node_mlp(node_feat).float()
        if self.out_chans_node == 1:
            node_out = node_out[..., 0]

        node_out = mask_nodes(node_out, node_flags) if not flag_node_only else node_out * 0.0
        adj_out = mask_adjs(adj_out, node_flags)
        if self.symmetric_noise:
            adj_out = symmetrize(adj_out)
        return adj_out, node_out
