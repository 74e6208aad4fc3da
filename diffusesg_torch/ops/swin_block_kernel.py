"""The attention half of a Swin block on a pre-rolled grid.

Counterpart of diffusesg_tpu/ops/swin_block_kernel.py (the first-generation
half-block kernel, entry ``fused_swin_attn_block``):

    a = silu(shift + x * (scale + 1));   y = a + proj(W-MSA(qkv(LN1(a))))

with the JAX entry's contract: ``x`` [B, H, W, C] is ALREADY rolled when the
block is shifted, the shifted-window ``mask`` [nW, L, L] comes with it, and
there is no ``shift`` argument.  On a CUDA tensor it launches the hand-written
kernels ``swin_attn`` (forward, csrc/swin_attn.cu) and ``swin_attn_bwd``
(backward, csrc/swin_attn_bwd.cu), the same device code ``swin_block_v3``
runs with ``shift = 0``: the TPU's generations of this kernel differ in how
they tile VMEM (one window row per program here, multi-row tiles and packed
heads later), and a Hopper block holds no stage's weights in shared memory
either way, so one device kernel serves all of them.  The JAX entry
differentiates its XLA composition; this one gets the kernel backward.  The
entry owns no device function and no launch counter: its launches are
``swin_attn``'s (and ``swin_attn_bwd``'s).  On a CPU tensor it is
``swin_attn_block_plain``.  Weights are in the PyTorch Linear layout
([out, in]).
"""
from __future__ import annotations

from .swin_block_v3 import swin_attn, swin_attn_block_plain

__all__ = ["fused_swin_attn_block", "swin_attn_block_plain"]


def fused_swin_attn_block(x, scale_shift, ln_gamma, ln_beta, wqkv, bqkv, wproj, bproj,
                          rel_bias, mask, num_heads: int, window: int):
    """x [B, H, W, C] (pre-rolled), scale_shift [B, 2C], rel_bias [nH, L, L],
    mask [nW, L, L] or None -> [B, H, W, C], differentiable."""
    return swin_attn(x, scale_shift, ln_gamma, ln_beta, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                     num_heads, window, 0)
