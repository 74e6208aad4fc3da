"""The denoiser's full-resolution entry at patch size 1: the grid input's
assembly, PatchEmbed's product, its LayerNorm and the noise affine.

No TPU kernel computes it: the JAX package leaves this composition to XLA
(diffusesg_tpu/models/diffusesg.py, layers.py::PatchEmbed).  On a CUDA
tensor ``patch_embed`` runs the hand-written kernel ``patch_embed``
(csrc/patch_embed.cu: one persistent launch that gathers each row's input
channels straight into the product's A fragments, multiplies on wgmma, and
applies the bias, the LayerNorm, the affine and SiLU before one bf16 write);
on a CPU tensor it runs ``patch_embed_plain``.  It is a forward alone, with
no backward: the model calls it only where no gradient is recorded
(``models/diffusesg.py``), and composes the pieces below, differentiated by
autograd, elsewhere.  Weights are in the PyTorch Linear layout ([out, in]).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_build
from .masking import mask_adjs
from .mlp_block_kernel import layer_norm
from .readout_kernel import readout_plan

NAME = "patch_embed"
WIDTH = 96          # the embedding the kernel writes: one m64n96 wgmma
MAX_CHANNELS = 32   # input channels it takes: two k16 steps


def assemble_plain(adj, node, node_flags, sc_adj, sc_node, self_condition: bool):
    """The grid input [B, N, N, Cin] in fp32 (reference: diffusesg.py:
    [sc_a ; adj] then [sc_x ; node] of node i and of node j, the node
    channels masked by both nodes' flags).  ``adj`` [B, N, N, Ca], ``node``
    [B, N, Cx]; a self-conditioning tensor that is None is zeros."""
    node = node.float()
    if self_condition:
        sc_a = torch.zeros_like(adj) if sc_adj is None else sc_adj
        sc_x = torch.zeros_like(node) if sc_node is None else sc_node
        adj = torch.cat([sc_a.to(adj.dtype), adj], dim=-1)
        node = torch.cat([sc_x.float(), node], dim=-1)
    b, n = node.shape[:2]
    node_mat = node[:, :, None, :].expand(b, n, n, node.shape[-1])
    node_cat = mask_adjs(torch.cat([node_mat, node_mat.transpose(1, 2)], dim=-1), node_flags)
    return torch.cat([adj.to(node_cat.dtype), node_cat], dim=-1)


def noise_affine_plain(x, scale_shift):
    """``silu(shift + x * (scale + 1))`` over [B, L, C] rows, ``scale_shift``
    [B, 2C] (scale | shift), in the dtype of both."""
    scale, shift = scale_shift[:, None, :].chunk(2, dim=-1)
    return F.silu(shift + x * (scale + 1.0))


def patch_embed_plain(adj, node, node_flags, sc_adj, sc_node, w, bias, ln_w, ln_b, scale_shift,
                      self_condition: bool):
    """[B, N * N, D] in ``w``'s dtype: the assembled input rounded to it,
    ``bf16(x W^T + bias)``, the fp32 LayerNorm rounded, the noise affine
    (``PatchEmbed`` at patch size 1 with its norm)."""
    dt = w.dtype
    x = assemble_plain(adj, node, node_flags, sc_adj, sc_node, self_condition).to(dt)
    b, n = x.shape[:2]
    x = F.linear(x.reshape(b, n * n, -1), w, bias)
    x = layer_norm(x, ln_w, ln_b).to(dt)
    return noise_affine_plain(x, scale_shift)


def covers(width: int, channels: int) -> bool:
    """Whether the kernel takes an embedding of ``width`` from ``channels``
    input channels."""
    return width == WIDTH and 0 < channels <= MAX_CHANNELS


def embed_tile() -> tuple[int, ...]:
    """The kernel's tile, from the library (csrc/patch_embed.cu): rows a
    tile, tiles a block works on at once (its warpgroups), blocks an SM."""
    return cuda_build.tile_of("dsg_patch_embed_tile")


def patch_embed(adj, node, node_flags, sc_adj, sc_node, w, bias, ln_w, ln_b, scale_shift,
                self_condition: bool):
    """The entry, forward alone: the kernel on CUDA tensors, the plain
    version on CPU.  ``w`` [96, Cin] and ``bias`` in the compute dtype,
    ``ln_w`` / ``ln_b`` fp32, ``scale_shift`` [B, 192]."""
    if adj.device.type == "cpu":
        return patch_embed_plain(adj, node, node_flags, sc_adj, sc_node, w, bias, ln_w, ln_b,
                                 scale_shift, self_condition)
    b, n, ca, cx = node.shape[0], node.shape[1], adj.shape[-1], node.shape[-1]
    d, cin = w.shape
    want = 2 * ca + 4 * cx if self_condition else ca + 2 * cx
    if (not covers(d, cin) or cin != want or tuple(adj.shape) != (b, n, n, ca)
            or tuple(node_flags.shape) != (b, n) or tuple(scale_shift.shape) != (b, 2 * d)):
        raise ValueError(f"patch_embed shapes adj{tuple(adj.shape)} node{tuple(node.shape)} "
                         f"flags{tuple(node_flags.shape)} w{tuple(w.shape)} are not supported "
                         f"(width {WIDTH}, up to {MAX_CHANNELS} input channels)")

    def rows(t, name):
        return None if t is None else cuda_build.require(t.float(), torch.float32, name)

    sc = (sc_adj, sc_node) if self_condition else (None, None)
    srcs = [rows(t, k) for t, k in ((adj, "adj"), (sc[0], "sc_adj"), (node, "node"),
                                    (sc[1], "sc_node"))]
    flags = node_flags.bool().contiguous()
    w = cuda_build.require(w, torch.bfloat16, "w")
    bias = cuda_build.require(bias, torch.bfloat16, "bias")
    ln_w = cuda_build.require(ln_w, torch.float32, "ln_w")
    ln_b = cuda_build.require(ln_b, torch.float32, "ln_b")
    scale_shift = cuda_build.require(scale_shift, torch.bfloat16, "scale_shift")
    m = b * n * n
    out = torch.empty((b, n * n, d), dtype=torch.bfloat16, device=adj.device)
    blocks = readout_plan(m, embed_tile(), cuda_build.sm_count(adj.device))
    p = cuda_build.ptr
    cuda_build.launch(NAME, adj.device, "dsg_patch_embed", *(p(t) for t in srcs), p(flags),
                      p(scale_shift), p(w), p(bias), p(ln_w), p(ln_b), p(out), m, n, ca, cx, cin,
                      int(self_condition), blocks)
    cuda_build.count_launch(NAME, f"N{n} Cin{cin}")
    return out
