"""The denoiser's full-resolution entry: the grid input's assembly,
PatchEmbed's patchify and product, its LayerNorm and the noise affine.

No TPU kernel computes it: the JAX package leaves this composition to XLA
(diffusesg_tpu/models/diffusesg.py, layers.py::PatchEmbed), as
``patch_embed_plain`` does here.  ``patch_embed`` runs the hand-written
kernel ``patch_embed`` instead (csrc/patch_embed.cu: one persistent launch
that gathers each row's input channels straight into the product's A
fragments, multiplies on wgmma, and applies the bias, the LayerNorm, the
affine and SiLU before one bf16 write), a forward alone, where it covers the
shapes and autograd records nothing through the operands.  Weights are in
the PyTorch Linear layout ([out, in]).
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


def patch_embed_plain(adj, node, node_flags, sc_adj, sc_node, w, bias, ln_w, ln_b, scale_shift,
                      self_condition: bool, patch_size: int = 1):
    """[B, (N / p)^2, D] in ``w``'s dtype.  The grid input [B, N, N, Cin] is
    assembled in fp32 as the reference does ([sc_a ; adj] then [sc_x ; node]
    of node i and of node j, the node channels masked by both nodes' flags;
    a self-conditioning tensor that is None is zeros) and rounded; then p x p
    patches (``w`` [D, p p Cin], its columns (kh, kw, c)), ``x W^T + bias``,
    the fp32 LayerNorm rounded (none where ``ln_w`` is None), and
    ``silu(shift + x * (scale + 1))`` with ``scale_shift`` [B, 2D]."""
    dt, p = w.dtype, patch_size
    node = node.float()
    if self_condition:
        sc_a = torch.zeros_like(adj) if sc_adj is None else sc_adj
        sc_x = torch.zeros_like(node) if sc_node is None else sc_node
        adj = torch.cat([sc_a.to(adj.dtype), adj], dim=-1)
        node = torch.cat([sc_x.float(), node], dim=-1)
    b, n = node.shape[:2]
    node_mat = node[:, :, None, :].expand(b, n, n, node.shape[-1])
    node_cat = mask_adjs(torch.cat([node_mat, node_mat.transpose(1, 2)], dim=-1), node_flags)
    x = torch.cat([adj.to(node_cat.dtype), node_cat], dim=-1).to(dt)
    b, h, ww, c = x.shape
    x = x.reshape(b, h // p, p, ww // p, p, c).permute(0, 1, 3, 2, 4, 5)
    x = F.linear(x.reshape(b, (h // p) * (ww // p), p * p * c), w, bias)
    if ln_w is not None:
        x = layer_norm(x, ln_w, ln_b).to(dt)
    scale, shift = scale_shift[:, None, :].chunk(2, dim=-1)
    return F.silu(shift + x * (scale + 1.0))


def covers(width: int, channels: int) -> bool:
    """Whether the kernel takes an embedding of ``width`` from ``channels``
    input channels."""
    return width == WIDTH and 0 < channels <= MAX_CHANNELS


def embed_tile(device) -> tuple[int, ...]:
    """The kernel's tile, from the library (csrc/patch_embed.cu): rows a
    tile, tiles a block works on at once (its warpgroups), blocks an SM."""
    return cuda_build.tile_of(device, "dsg_patch_embed_tile")


def patch_embed(adj, node, node_flags, sc_adj, sc_node, w, bias, ln_w, ln_b, scale_shift,
                self_condition: bool, patch_size: int = 1):
    """The entry: ``patch_embed_fwd`` where its kernel covers the shapes and
    autograd records nothing through the operands, else ``patch_embed_plain``."""
    args = (adj, node, node_flags, sc_adj, sc_node, w, bias, ln_w, ln_b, scale_shift,
            self_condition)
    if (patch_size == 1 and ln_w is not None and node_flags.ndim == 2 and covers(*w.shape)
            and not cuda_build.records(*args[:-1])):
        return patch_embed_fwd(*args)
    return patch_embed_plain(*args, patch_size)


def patch_embed_fwd(adj, node, node_flags, sc_adj, sc_node, w, bias, ln_w, ln_b, scale_shift,
                    self_condition: bool):
    """The entry at patch size 1, forward alone: the kernel on CUDA tensors,
    the plain version on CPU.  ``w`` [96, Cin] and ``bias`` in the compute
    dtype, ``ln_w`` / ``ln_b`` fp32, ``scale_shift`` [B, 192]."""
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
    blocks = readout_plan(m, embed_tile(adj.device), cuda_build.sm_count(adj.device))
    p = cuda_build.ptr
    cuda_build.launch(NAME, adj.device, "dsg_patch_embed", *(p(t) for t in srcs), p(flags),
                      p(scale_shift), p(w), p(bias), p(ln_w), p(ln_b), p(out), m, n, ca, cx, cin,
                      int(self_condition), blocks)
    cuda_build.count_launch(NAME, f"N{n} Cin{cin}")
    return out
