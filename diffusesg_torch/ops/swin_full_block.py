"""One whole Swin block on a pre-rolled grid.

Counterpart of diffusesg_tpu/ops/swin_full_block.py (the second-generation
whole-block kernel with block-diagonal head groups, entry
``fused_swin_block``):

    a   = silu(shift + x * (scale + 1))
    y   = a + proj(W-MSA(qkv(LN1(a))))
    out = y + fc2(gelu(fc1(LN2(y))))

with the JAX entry's contract: ``x`` [B, H, W, C] is ALREADY rolled when the
block is shifted, the ``mask`` [nW, L, L] comes with it, and there is no
``shift`` argument.  On a CUDA tensor it launches the hand-written kernels
``swin_attn`` and then ``token_mlp`` (and their backward kernels), the same
device code as ``swin_block_v3.fused_swin_block`` with ``shift = 0``: the
head-group packing that sets this TPU kernel apart feeds a 128-wide matrix
unit from head_dim 32, while a Hopper warp's MMA tile is 16 wide and takes
one head as it is, so the generations collapse into one device kernel.  The
GELU is the exact erf form (the model's), where the TPU kernel's fused MLP
uses the tanh form.  The entry owns no device function and no launch counter:
its launches are ``swin_attn``'s and ``token_mlp``'s.  On a CPU tensor it is
``swin_block_plain``.  Weights are in the PyTorch Linear layout ([out, in]).
"""
from __future__ import annotations

from . import swin_block_v3
# attention half then MLP half; on a pre-rolled x with the default shift 0
# (reference: swin_block_xla with the erf GELU)
from .swin_block_v3 import swin_block_plain  # noqa: F401


def fused_swin_block(x, scale_shift, ln1_g, ln1_b, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                     ln2_g, ln2_b, w1, b1, w2, b2, num_heads: int, window: int):
    """x [B, H, W, C] (pre-rolled) -> [B, H, W, C], differentiable."""
    return swin_block_v3.fused_swin_block(x, scale_shift, ln1_g, ln1_b, wqkv, bqkv, wproj, bproj,
                                          rel_bias, mask, ln2_g, ln2_b, w1, b1, w2, b2,
                                          num_heads, window, 0)
