"""MLP half of a Swin block: ``y = x + fc2(gelu(fc1(LN(x))))`` per token.

Counterpart of diffusesg_tpu/ops/mlp_block_kernel.py.  ``token_mlp`` is a
``torch.autograd.Function``: on a CUDA tensor its forward is the
hand-written kernel ``token_mlp`` (csrc/token_mlp.cu, one fused launch in
which the [M, 4C] hidden stays on chip, plus a closing pass where the hidden
dimension is split across blocks), which serves every
Swin block's MLP half (the TPU's ``fused_mlp_block`` and the MLP half of
``fused_swin_block_v3``), and its backward the kernel ``token_mlp_bwd``
(csrc/token_mlp_bwd.cu; the TPU's ``_mlp_bwd_kernel`` and, at C = 768,
``_mlp_bwd_export_kernel``).  On a CPU tensor both run the plain versions
below.  The forward saves ``x`` and the parameters and nothing else; the
backward recomputes.  Weights are in the PyTorch Linear layout ([out, in]).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import cuda_build

NAME = "token_mlp"
NAME_BWD = "token_mlp_bwd"
LN_EPS = 1e-6


def up(t: torch.Tensor) -> torch.Tensor:
    """fp32 for the 16-bit types, unchanged otherwise (fp64 stays fp64, so
    the plain versions can be checked against autograd in double)."""
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


def layer_norm(x, gamma, beta):
    """fp32 LayerNorm with the model's epsilon of 1e-6."""
    x = up(x)
    return F.layer_norm(x, (x.shape[-1],), up(gamma), up(beta), LN_EPS)


def ln_stats(x):
    """(hbar, rstd) of the model's LayerNorm: biased variance, eps inside."""
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mean) ** 2).mean(-1, keepdim=True) + LN_EPS)
    return (x - mean) * rstd, rstd


def ln_vjp(dhn, hbar, rstd, gamma):
    """LayerNorm's vjp w.r.t. its input, given d(normalized * gamma + beta)."""
    dh = dhn * gamma
    return rstd * (dh - dh.mean(-1, keepdim=True) - hbar * (dh * hbar).mean(-1, keepdim=True))


def gelu_erf_grad(u):
    """d/du of the exact erf GELU: Phi(u) + u * phi(u)."""
    return (0.5 * (1.0 + torch.erf(u / math.sqrt(2.0)))
            + u * torch.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi))


def mlp_block_plain(x, ln_gamma, ln_beta, w1, b1, w2, b2):
    """x [..., C] -> same shape (reference: mlp_block_xla, exact erf GELU)."""
    h = layer_norm(x, ln_gamma, ln_beta).to(x.dtype)
    h = F.linear(up(h), up(w1), up(b1))
    h = F.gelu(h).to(x.dtype)
    out = F.linear(up(h), up(w2), up(b2))
    return x + out.to(x.dtype)


def mlp_bwd_plain(x, dout, ln_gamma, ln_beta, w1, b1, w2):
    """Backward of ``mlp_block_plain`` step by step, with the kernel's
    rounding points: x, dout [n, C] -> (dx, dgamma, dbeta, dw1, db1, dw2, db2).
    ``hn``, ``m`` and ``du`` are rounded to x's dtype once before the product
    that consumes them, ``gelu'(u)`` to fp16 when x is bf16; every sum is fp32
    (reference: _mlp_bwd_kernel, with the erf GELU's derivative)."""
    dt = x.dtype
    gamma = up(ln_gamma)
    hbar, rstd = ln_stats(up(x))
    hn = up((hbar * gamma + up(ln_beta)).to(dt))
    u = hn @ up(w1).T + up(b1)
    m = up(F.gelu(u).to(dt))
    gp = gelu_erf_grad(u)
    if dt == torch.bfloat16:
        gp = gp.to(torch.float16).float()
    dof = up(dout)
    du = up(((dof @ up(w2)) * gp).to(dt))
    dw2 = dof.T @ m
    db2 = dof.sum(0)
    dw1 = du.T @ hn
    db1 = du.sum(0)
    dhn = du @ up(w1)
    dgamma = (dhn * hbar).sum(0)
    dbeta = dhn.sum(0)
    dx = dof + ln_vjp(dhn, hbar, rstd, gamma)
    return (dx.to(dt), dgamma.to(ln_gamma.dtype), dbeta.to(ln_beta.dtype), dw1.to(w1.dtype),
            db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b1.dtype))


def _checked(x, ln_gamma, ln_beta, w1, b1, w2):
    c, hidden = x.shape[-1], w1.shape[0]
    xf = cuda_build.require(x, torch.bfloat16, "x").reshape(-1, c)
    w1 = cuda_build.require(w1, torch.bfloat16, "w1")
    w2 = cuda_build.require(w2, torch.bfloat16, "w2")
    g, bt, b1 = (cuda_build.require(t, torch.float32, n) for t, n in
                 ((ln_gamma, "ln_gamma"), (ln_beta, "ln_beta"), (b1, "b1")))
    if w1.shape[1] != c or tuple(w2.shape) != (c, hidden) or c % 8 or hidden % 8:
        raise ValueError(f"token_mlp shapes C={c} w1{tuple(w1.shape)} "
                         f"w2{tuple(w2.shape)} are not supported")
    return xf, g, bt, w1, b1, w2


@functools.lru_cache(maxsize=None)
def mlp_tile(c: int) -> tuple[int, int, int]:
    """The fused forward kernel's tile at C, from the library
    (csrc/token_mlp.cu MlpConfig): token rows a block, hidden columns a
    chunk, and the blocks an SM holds (the card's occupancy)."""
    geom = (ctypes.c_int * 3)()
    rc = cuda_build.lib().dsg_token_mlp_tile(c, geom)
    if rc == -1:
        raise ValueError(f"token_mlp is not built for C={c}")
    cuda_build.check(rc, NAME)
    return tuple(geom)


def mlp_fwd_plan(m: int, hidden: int, tile: tuple[int, int, int],
                 sms: int = 132) -> dict[str, int]:
    """Grid plan of the fused ``token_mlp``: into how many ``splits`` of
    ``chunks`` hidden chunks each to cut the hidden dimension, so that the
    row tiles times the splits fill about one wave of resident blocks
    (``sms`` x the blocks an SM holds) without passing it.  ``tile`` is
    ``mlp_tile(C)``.  Every split gets at least one chunk; one split (no
    partials) when the row tiles alone fill the wave."""
    rows, chunk, per_sm = tile
    n_chunks = hidden // chunk
    want = max(1, min(n_chunks, sms * per_sm // -(-m // rows)))
    per_split = -(-n_chunks // want)
    return dict(splits=-(-n_chunks // per_split), chunks=per_split)


def token_mlp_fwd(x, ln_gamma, ln_beta, w1, b1, w2, b2):
    """Forward alone: the kernel on CUDA tensors, the plain version on CPU."""
    if x.device.type == "cpu":
        return mlp_block_plain(x, ln_gamma, ln_beta, w1, b1, w2, b2)
    xf, g, bt, w1, b1, w2 = _checked(x, ln_gamma, ln_beta, w1, b1, w2)
    b2 = cuda_build.require(b2, torch.float32, "b2")
    m, c = xf.shape
    hidden = w1.shape[0]
    tile = mlp_tile(c)
    if hidden % tile[1]:
        raise ValueError(f"token_mlp needs a hidden width that is a multiple of its chunk "
                         f"{tile[1]}; got C={c} hidden={hidden}")
    plan = mlp_fwd_plan(m, hidden, tile, cuda_build.sm_count(x.device))
    part = None
    if plan["splits"] > 1:
        part = torch.empty((plan["splits"], m, c), dtype=torch.float32, device=x.device)
    out = torch.empty_like(xf)
    p = cuda_build.ptr
    rc = cuda_build.lib().dsg_token_mlp(
        p(xf), p(g), p(bt), p(w1), p(b1), p(w2), p(b2), p(part), p(out), m, c, hidden,
        plan["splits"], plan["chunks"], cuda_build.stream_ptr(x.device))
    cuda_build.check(rc, NAME)
    cuda_build.count_launch(NAME, f"C{c}")
    return out.reshape(x.shape)


def mlp_bwd_splits(m: int, c: int, hidden: int) -> dict[str, int]:
    """Grid plan of ``token_mlp_bwd``'s reductions over the ``m`` tokens: the
    split-K count of the two weight-gradient GEMMs (128 x 64 output tiles),
    the row splits of the two bias sums (256 columns per block) and the
    blocks of the closing row pass (8 rows per block and step)."""
    tiles = -(-c // 128) * -(-hidden // 64)
    return dict(w=cuda_build.split_count(tiles, m, 256, 32),
                b1=cuda_build.split_count(-(-hidden // 256), m, 64),
                b2=cuda_build.split_count(-(-c // 256), m, 64),
                ln=min(cuda_build.TARGET_BLOCKS, -(-m // 8)))


def token_mlp_bwd(x, dout, ln_gamma, ln_beta, w1, b1, w2):
    """Backward of the MLP half: the kernel on CUDA tensors, the plain
    version on CPU.  Returns (dx, dgamma, dbeta, dw1, db1, dw2, db2), each in
    its primal's dtype."""
    if x.device.type == "cpu":
        shape = x.shape
        grads = mlp_bwd_plain(x.reshape(-1, shape[-1]), dout.reshape(-1, shape[-1]), ln_gamma,
                              ln_beta, w1, b1, w2)
        return (grads[0].reshape(shape),) + grads[1:]
    xf, g, bt, w1, b1, w2 = _checked(x, ln_gamma, ln_beta, w1, b1, w2)
    m, c = xf.shape
    hidden = w1.shape[0]
    if c > 768:
        raise ValueError(f"token_mlp_bwd covers C <= 768, got {c}")
    do = cuda_build.require(dout, torch.bfloat16, "dout").reshape(m, c)
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    sp = mlp_bwd_splits(m, c, hidden)
    hn = torch.empty((m, c), dtype=bf, device=dev)
    mid, du = (torch.empty((m, hidden), dtype=bf, device=dev) for _ in range(2))
    gp = torch.empty((m, hidden), dtype=torch.float16, device=dev)
    dhn = torch.empty((m, c), dtype=f32, device=dev)
    part_w1, part_w2 = (torch.empty((sp["w"], c * hidden), dtype=f32, device=dev)
                        for _ in range(2))
    part_b1 = torch.empty((sp["b1"], hidden), dtype=f32, device=dev)
    part_b2 = torch.empty((sp["b2"], c), dtype=f32, device=dev)
    part_ln = torch.empty((sp["ln"], 2 * c), dtype=f32, device=dev)
    dx = torch.empty((m, c), dtype=bf, device=dev)
    dgb = torch.empty((2, c), dtype=f32, device=dev)
    dw1 = torch.empty((hidden, c), dtype=f32, device=dev)
    dw2 = torch.empty((c, hidden), dtype=f32, device=dev)
    db1 = torch.empty((hidden,), dtype=f32, device=dev)
    db2 = torch.empty((c,), dtype=f32, device=dev)
    p = cuda_build.ptr
    rc = cuda_build.lib().dsg_token_mlp_bwd(
        p(xf), p(do), p(g), p(bt), p(w1), p(b1), p(w2),
        p(hn), p(mid), p(gp), p(du), p(dhn), p(part_w1), p(part_w2), p(part_b1), p(part_b2),
        p(part_ln), p(dx), p(dgb), p(dw1), p(db1), p(dw2), p(db2),
        m, c, hidden, sp["w"], sp["b1"], sp["b2"], sp["ln"], cuda_build.stream_ptr(dev))
    cuda_build.check(rc, NAME_BWD)
    cuda_build.count_launch(NAME_BWD, f"C{c}")
    return dx.reshape(x.shape), dgb[0], dgb[1], dw1.to(bf), db1, dw2.to(bf), db2


class _TokenMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_gamma, ln_beta, w1, b1, w2, b2):
        ctx.save_for_backward(x, ln_gamma, ln_beta, w1, b1, w2)
        return token_mlp_fwd(x, ln_gamma, ln_beta, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dout):
        x = ctx.saved_tensors[0]
        return token_mlp_bwd(x, dout.to(x.dtype).contiguous(), *ctx.saved_tensors[1:])


def token_mlp(x, ln_gamma, ln_beta, w1, b1, w2, b2):
    """MLP half, differentiable: kernels on CUDA tensors (forward
    ``token_mlp``, backward ``token_mlp_bwd``), the plain versions on CPU."""
    return _TokenMlp.apply(x, ln_gamma, ln_beta, w1, b1, w2, b2)
