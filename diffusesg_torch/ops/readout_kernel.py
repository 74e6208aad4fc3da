"""The denoiser's two-layer output heads: ``gelu(x @ W1^T + b1) @ W2^T + b2``.

Counterpart of diffusesg_tpu/ops/readout_kernel.py.  On a CUDA tensor the
head runs as the hand-written kernel ``readout`` (csrc/readout.cu); on a
CPU tensor it runs the plain version below.  Weights are in the PyTorch
Linear layout ([out, in]); GELU is the exact erf form in both versions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_build

NAME = "readout"


def readout_mlp_plain(x, w1, b1, w2, b2):
    """[N, C] -> [N, out] float32; products in fp32 over the given values,
    the hidden rounded to x's dtype (reference: readout_mlp_xla)."""
    h = F.linear(x.float(), w1.float(), b1.float())
    h = F.gelu(h).to(x.dtype)
    return F.linear(h.float(), w2.float(), b2.float())


def readout_mlp(x, w1, b1, w2, b2):
    """Readout head; the kernel on CUDA tensors, the plain version on CPU."""
    if x.device.type == "cpu":
        return readout_mlp_plain(x, w1, b1, w2, b2)
    m, c = x.shape
    hidden, n_out = w1.shape[0], w2.shape[0]
    x = cuda_build.require(x, torch.bfloat16, "x")
    w1 = cuda_build.require(w1, torch.bfloat16, "w1")
    w2 = cuda_build.require(w2, torch.bfloat16, "w2")
    b1 = cuda_build.require(b1, torch.float32, "b1")
    b2 = cuda_build.require(b2, torch.float32, "b2")
    if w1.shape[1] != c or w2.shape[1] != hidden or not 1 <= n_out <= 16:
        raise ValueError(f"readout shapes x{tuple(x.shape)} w1{tuple(w1.shape)} "
                         f"w2{tuple(w2.shape)} are not supported")
    hid = torch.empty((m, hidden), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((m, n_out), dtype=torch.float32, device=x.device)
    p = cuda_build.ptr
    rc = cuda_build.lib().dsg_readout(
        p(x), p(w1), p(b1), p(w2), p(b2), p(hid), p(out), m, c, hidden, n_out,
        cuda_build.stream_ptr(x.device))
    cuda_build.check(rc, NAME)
    cuda_build.count_launch(NAME, f"C{c}->{n_out}")
    return out
