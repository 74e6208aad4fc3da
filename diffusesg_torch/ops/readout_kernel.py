"""The denoiser's two-layer output heads: ``gelu(x @ W1^T + b1) @ W2^T + b2``,
and the whole output head at full resolution around the adjacency one.

Counterpart of diffusesg_tpu/ops/readout_kernel.py.  On a CUDA tensor the
head's forward runs as the hand-written kernel ``readout`` (csrc/readout.cu:
one persistent launch, both products on wgmma, the hidden kept on chip; C a
multiple of 16 up to 128, hidden 96, 1 to 16 outputs); on a CPU tensor it
runs the plain version below.  ``readout_mlp`` is a
``torch.autograd.Function`` whose backward recomputes the plain version and
differentiates it, as the JAX ``custom_vjp`` differentiates its XLA
composition.  Weights are in the PyTorch
Linear layout ([out, in]); GELU is the exact erf form in both versions.

The denoiser's exit (the final LayerNorm, ReadOut's three products, the
adjacency head and the node pooling) is one composition that takes its
adjacency head, ``output_head_composed``.  ``output_head`` runs it as one
launch (``readout_kernel_head``, in which ``shared`` never reaches device
memory) where the kernel covers the shapes and autograd records nothing
through the operands.  The pooling comes back as fixed-order partial sums,
two a node, which the wrapper adds and divides by N.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import cuda_build
from .masking import mask_adjs
from .mlp_block_kernel import layer_norm

NAME = "readout"


def readout_mlp_plain(x, w1, b1, w2, b2):
    """[N, C] -> [N, out] float32; products in fp32 over the given values,
    the hidden rounded to x's dtype (reference: readout_mlp_xla)."""
    h = F.linear(x.float(), w1.float(), b1.float())
    h = F.gelu(h).to(x.dtype)
    return F.linear(h.float(), w2.float(), b2.float())


def readout_tile(device) -> tuple[int, ...]:
    """The kernel's tile, from the library (csrc/readout.cu): rows a tile,
    tiles a block works on at once (its warpgroups), blocks an SM holds."""
    return cuda_build.tile_of(device, "dsg_readout_tile")


def readout_plan(m: int, tile: tuple[int, ...], sms: int = 132) -> int:
    """Blocks of the persistent readout kernel over ``m`` rows: one wave of
    resident blocks (``sms`` x ``tile[2]``), or as many as give every
    warpgroup of the block one tile where the tiles are fewer."""
    rows, groups, per_sm = tile[:3]
    tiles = -(-m // rows)
    return max(1, min(-(-tiles // groups), sms * per_sm))


def readout_mlp_fwd(x, w1, b1, w2, b2):
    """Forward alone: the kernel on CUDA tensors, the plain version on CPU."""
    if x.device.type == "cpu":
        return readout_mlp_plain(x, w1, b1, w2, b2)
    m, c = x.shape
    hidden, n_out = w1.shape[0], w2.shape[0]
    x = cuda_build.require(x, torch.bfloat16, "x")
    w1 = cuda_build.require(w1, torch.bfloat16, "w1")
    w2 = cuda_build.require(w2, torch.bfloat16, "w2")
    b1 = cuda_build.require(b1, torch.float32, "b1")
    b2 = cuda_build.require(b2, torch.float32, "b2")
    if (w1.shape[1] != c or w2.shape[1] != hidden or hidden != 96 or c % 16 or not 0 < c <= 128
            or not 1 <= n_out <= 16):
        raise ValueError(f"readout shapes x{tuple(x.shape)} w1{tuple(w1.shape)} "
                         f"w2{tuple(w2.shape)} are not supported (C a multiple of 16 up to "
                         "128, hidden 96, 1 to 16 outputs)")
    out = torch.empty((m, n_out), dtype=torch.float32, device=x.device)
    blocks = readout_plan(m, readout_tile(x.device), cuda_build.sm_count(x.device))
    p = cuda_build.ptr
    cuda_build.launch(NAME, x.device, "dsg_readout",
                      p(x), p(w1), p(b1), p(w2), p(b2), p(out), m, c, hidden, n_out, blocks)
    cuda_build.count_launch(NAME, f"C{c}->{n_out}")
    return out


class _Readout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return readout_mlp_fwd(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dout):
        return cuda_build.plain_vjp(readout_mlp_plain, ctx.saved_tensors, dout)


def readout_mlp(x, w1, b1, w2, b2):
    """Readout head, differentiable (the kernel forward on CUDA tensors)."""
    return _Readout.apply(x, w1, b1, w2, b2)


def node_pool_plain(shared, node_flags):
    """[B, N, N, C] -> [B, N, C] fp32: each node's masked mean over j,
    summed in fp32 with the full N as the divisor (the padding-aware pooled
    node readout)."""
    return torch.mean(mask_adjs(shared, node_flags), dim=2, dtype=torch.float32)


def output_head_composed(adj_head, x, ln_w, ln_b, w0, b0, w1, b1, w2, b2, fc1_w, fc1_b, fc2_w,
                         fc2_b, node_flags, patch_size: int = 1):
    """The exit over the U-Net's rows ``x`` [B, H, W, D] in the compute dtype:
    ``shared`` = ReadOut(bf16(LayerNorm(x))), ``w0``'s rows (kh, kw, d) put
    depth-to-space, each product rounded to the dtype; returns (``adj_head``
    over ``shared``, rounded to the dtype, as fp32 [B, pH, pW, n_out]; the
    node pooling of ``shared``, fp32 [B, pH, D]).  ``w*`` and ``b*`` in the
    compute dtype, ``ln_*`` and ``fc*_b`` fp32."""
    dt = w0.dtype
    b, h, w, _ = x.shape
    p = patch_size
    s = F.linear(layer_norm(x, ln_w, ln_b).to(dt), w0, b0)
    d = s.shape[-1] // (p * p)
    s = s.reshape(b, h, w, p, p, d).permute(0, 1, 3, 2, 4, 5).reshape(b, h * p, w * p, d)
    for wt, bias in ((w1, b1), (w2, b2)):
        s = F.linear(s, wt, bias)
    adj = adj_head(s.reshape(-1, d), fc1_w, fc1_b, fc2_w, fc2_b)
    return adj.reshape(*s.shape[:3], -1).to(dt).float(), node_pool_plain(s, node_flags)


# the kernel's reference, and the exit with the kernels off
output_head_plain = functools.partial(output_head_composed, readout_mlp_plain)


def head_covers(n: int, width: int, n_out: int) -> bool:
    """Whether ``output_head``'s kernel takes an N x N grid of ``width``
    channels with an adjacency head of ``n_out`` outputs."""
    return 0 < n <= 64 and width == 96 and 1 <= n_out <= 16


def head_tile(device) -> tuple[int, ...]:
    """The output head's tile, from the library, as ``readout_tile``'s."""
    return cuda_build.tile_of(device, "dsg_readout_head_tile")


def output_head(x, ln_w, ln_b, w0, b0, w1, b1, w2, b2, fc1_w, fc1_b, fc2_w, fc2_b, node_flags,
                patch_size: int = 1):
    """The exit: ``output_head_fwd`` where its kernel covers the shapes and
    autograd records nothing through the operands, else the composition with
    ``readout_mlp`` (the readout kernel's forward, ``plain_vjp`` behind it)."""
    args = (x, ln_w, ln_b, w0, b0, w1, b1, w2, b2, fc1_w, fc1_b, fc2_w, fc2_b, node_flags)
    _, h, w, d = x.shape
    if (patch_size == 1 and h == w and node_flags.ndim == 2 and head_covers(h, d, fc2_w.shape[0])
            and not cuda_build.records(*args)):
        return output_head_fwd(*args)
    return output_head_composed(readout_mlp, *args, patch_size=patch_size)


def output_head_fwd(x, ln_w, ln_b, w0, b0, w1, b1, w2, b2, fc1_w, fc1_b, fc2_w, fc2_b,
                    node_flags):
    """The exit at patch size 1, forward alone: the kernel on CUDA tensors,
    the plain version on CPU.  Returns what ``output_head_plain`` returns."""
    if x.device.type == "cpu":
        return output_head_plain(x, ln_w, ln_b, w0, b0, w1, b1, w2, b2, fc1_w, fc1_b, fc2_w,
                                 fc2_b, node_flags)
    b, n, n2, d = x.shape
    n_out = fc2_w.shape[0]
    if (n2 != n or not head_covers(n, d, n_out) or tuple(node_flags.shape) != (b, n)
            or any(tuple(w.shape) != (d, d) for w in (w0, w1, w2, fc1_w))
            or tuple(fc2_w.shape) != (n_out, d)):
        raise ValueError(f"output head shapes x{tuple(x.shape)} fc2{tuple(fc2_w.shape)} "
                         f"flags{tuple(node_flags.shape)} are not supported (N up to 64, "
                         "width 96, 1 to 16 outputs)")
    bf, f32 = torch.bfloat16, torch.float32
    args = [cuda_build.require(t, dt, k) for t, dt, k in (
        (x, bf, "x"), (ln_w, f32, "ln_w"), (ln_b, f32, "ln_b"), (w0, bf, "w0"), (b0, bf, "b0"),
        (w1, bf, "w1"), (b1, bf, "b1"), (w2, bf, "w2"), (b2, bf, "b2"), (fc1_w, bf, "fc1_w"),
        (fc1_b, f32, "fc1_b"), (fc2_w, bf, "fc2_w"), (fc2_b, f32, "fc2_b"))]
    flags = node_flags.bool().contiguous()
    m = b * n * n
    out = torch.empty((b, n, n, n_out), dtype=f32, device=x.device)
    part = torch.empty((b * n, 2, d), dtype=f32, device=x.device)
    blocks = readout_plan(m, head_tile(x.device), cuda_build.sm_count(x.device))
    p = cuda_build.ptr
    cuda_build.launch(NAME, x.device, "dsg_readout_head", *(p(t) for t in args), p(flags),
                      p(out), p(part), m, n, n_out, blocks)
    cuda_build.count_launch(NAME, f"head N{n}->{n_out}")
    return out, part.sum(1).div_(n).reshape(b, n, d)
