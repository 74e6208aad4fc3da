"""MLP half of a Swin block: ``y = x + fc2(gelu(fc1(LN(x))))`` per token.

Counterpart of diffusesg_tpu/ops/mlp_block_kernel.py (forward only).  On a
CUDA tensor it runs as the hand-written kernel ``token_mlp``
(csrc/token_mlp.cu), which serves every Swin block's MLP half (the TPU's
``fused_mlp_block`` and the MLP half of ``fused_swin_block_v3``); on a CPU
tensor it runs the plain version below.  Weights are in the PyTorch Linear
layout ([out, in]).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_build

NAME = "token_mlp"
LN_EPS = 1e-6


def layer_norm(x, gamma, beta):
    """fp32 LayerNorm with the model's epsilon of 1e-6."""
    return F.layer_norm(x.float(), (x.shape[-1],), gamma.float(), beta.float(), LN_EPS)


def mlp_block_plain(x, ln_gamma, ln_beta, w1, b1, w2, b2):
    """x [..., C] -> same shape (reference: mlp_block_xla, exact erf GELU)."""
    h = layer_norm(x, ln_gamma, ln_beta).to(x.dtype)
    h = F.linear(h.float(), w1.float(), b1.float())
    h = F.gelu(h).to(x.dtype)
    out = F.linear(h.float(), w2.float(), b2.float())
    return x + out.to(x.dtype)


def token_mlp(x, ln_gamma, ln_beta, w1, b1, w2, b2):
    """MLP half; the kernel on CUDA tensors, the plain version on CPU."""
    if x.device.type == "cpu":
        return mlp_block_plain(x, ln_gamma, ln_beta, w1, b1, w2, b2)
    c = x.shape[-1]
    hidden = w1.shape[0]
    xf = cuda_build.require(x, torch.bfloat16, "x").reshape(-1, c)
    w1 = cuda_build.require(w1, torch.bfloat16, "w1")
    w2 = cuda_build.require(w2, torch.bfloat16, "w2")
    g, bt, b1, b2 = (cuda_build.require(t, torch.float32, n) for t, n in
                     ((ln_gamma, "ln_gamma"), (ln_beta, "ln_beta"), (b1, "b1"), (b2, "b2")))
    if w1.shape[1] != c or tuple(w2.shape) != (c, hidden) or c % 8 or hidden % 8:
        raise ValueError(f"token_mlp shapes C={c} w1{tuple(w1.shape)} "
                         f"w2{tuple(w2.shape)} are not supported")
    m = xf.shape[0]
    hn = torch.empty_like(xf)
    hid = torch.empty((m, hidden), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(xf)
    p = cuda_build.ptr
    rc = cuda_build.lib().dsg_token_mlp(
        p(xf), p(g), p(bt), p(w1), p(b1), p(w2), p(b2), p(hn), p(hid), p(out), m, c, hidden,
        cuda_build.stream_ptr(x.device))
    cuda_build.check(rc, NAME)
    cuda_build.count_launch(NAME, f"C{c}")
    return out.reshape(x.shape)
