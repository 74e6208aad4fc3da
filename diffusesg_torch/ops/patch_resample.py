"""PatchMerging / PatchBreakup: the U-Net's 2x down- and upsampling.

Counterpart of diffusesg_tpu/ops/patch_resample.py.  On a CUDA tensor the
forwards run as the hand-written kernels ``patch_merge`` and
``patch_breakup`` (csrc/patch_resample.cu); on a CPU tensor as the plain
versions below.  The merge is one launch of the Hopper GEMM
(csrc/hopper_gemm.cuh) whose prologue gathers and normalizes the rows in
shared memory (C a multiple of 8, 4C up to 1536).  Both are
``torch.autograd.Function``s that save their inputs; the backward recomputes
the plain version and differentiates it, as the JAX ``custom_vjp``
differentiates its XLA composition (the TPU has no backward kernel for them
either).  Channel orders match the reference: merge concatenates
[x(0,0), x(1,0), x(0,1), x(1,1)] (h-offset fastest), breakup maps chunk k
to the offset (ho = k % 2, wo = k // 2).  Weights are in the PyTorch Linear
layout ([out, in]).

The breakup takes the U-Net's skip as a second argument: the plain version
concatenates it, the kernel reads both sources without a copy.  Its two
products run on the Hopper GEMM (csrc/hopper_gemm.cuh); where 4c <= 384 the
first one's epilogue applies both LayerNorms and the depth-to-space scatter
(two launches), wider rows take a row pass between the products (three).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_build
from .mlp_block_kernel import layer_norm


def patch_merge_plain(x, ln_g, ln_b, w):
    """[B, H, W, C] -> [B, H/2, W/2, 2C] (reference: patch_merge_xla)."""
    b, h, ww, c = x.shape
    x = x.reshape(b, h // 2, 2, ww // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
    x = x.reshape(b, h // 2, ww // 2, 4 * c)
    x = layer_norm(x, ln_g, ln_b).to(w.dtype)
    return F.linear(x.float(), w.float()).to(w.dtype)


def merge_tile(c: int, wide: bool = False) -> tuple[int, ...]:
    """The tile of ``patch_merge``'s GEMM at width C (64-row panels where
    4C <= 384 if ``wide``), from the library (csrc/patch_resample.cu
    ``merge_tile``): rows, columns, blocks an SM holds, 0."""
    return cuda_build.tile_of("dsg_patch_merge_tile", c, int(wide))


def merge_plan(m: int, c: int, n: int, sms: int = 132) -> dict[str, int]:
    """Grid plan of ``patch_merge`` over ``m`` merged tokens, width C and
    ``n`` output columns: 64-row panels where ``wide_panels`` says so, and
    ``gemm_plan``'s column split on the tile taken."""
    wide = cuda_build.wide_panels(m, n, lambda w: merge_tile(c, w), sms)
    plan = cuda_build.gemm_plan(m, n, merge_tile(c, wide), sms)
    return dict(wide=int(wide), tiles=plan["tiles"])


def patch_merge_fwd(x, ln_g, ln_b, w):
    """Forward alone: the kernel on CUDA tensors, the plain version on CPU."""
    if x.device.type == "cpu":
        return patch_merge_plain(x, ln_g, ln_b, w)
    b, h, ww, c = x.shape
    c_out = w.shape[0]
    if h % 2 or ww % 2 or c % 8 or 4 * c > 1536 or w.shape[1] != 4 * c or c_out % 8:
        raise ValueError(f"patch_merge shapes x{tuple(x.shape)} w{tuple(w.shape)} "
                         "are not supported (an even grid, C a multiple of 8 up to 384, "
                         "outputs a multiple of 8)")
    x = cuda_build.require(x, torch.bfloat16, "x")
    w = cuda_build.require(w, torch.bfloat16, "w")
    g = cuda_build.require(ln_g, torch.float32, "ln_g")
    bt = cuda_build.require(ln_b, torch.float32, "ln_b")
    out = torch.empty((b, h // 2, ww // 2, c_out), dtype=torch.bfloat16, device=x.device)
    plan = merge_plan(b * (h // 2) * (ww // 2), c, c_out, cuda_build.sm_count(x.device))
    p = cuda_build.ptr
    cuda_build.launch("patch_merge", x.device, "dsg_patch_merge", p(x), p(g), p(bt), p(w),
                      p(out), b, h, ww, c, c_out, plan["wide"], plan["tiles"])
    cuda_build.count_launch("patch_merge", f"{h}x{ww}xC{c}")
    return out


def patch_breakup_plain(x, skip, w_in, ln1_g, ln1_b, ln2_g, ln2_b, w_out):
    """[B, H, W, C1] (+ skip [B, H, W, C2]) -> [B, 2H, 2W, c]
    (reference: patch_breakup_xla on the concatenated input)."""
    if skip is not None:
        x = torch.cat([x, skip], dim=-1)
    b, h, ww, _ = x.shape
    dim = w_in.shape[0]
    c_out = dim // 4
    y = F.linear(x.to(w_in.dtype).float(), w_in.float())
    y = layer_norm(y, ln1_g, ln1_b).to(w_in.dtype)
    y = y.reshape(b, h, ww, 2, 2, c_out).permute(0, 1, 4, 2, 3, 5)  # [b, h, ho, w, wo, c]
    y = y.reshape(b, 2 * h, 2 * ww, c_out)
    y = layer_norm(y, ln2_g, ln2_b).to(w_out.dtype)
    return F.linear(y.float(), w_out.float()).to(w_out.dtype)


def breakup_tile(cin: int, dim: int, which: str) -> tuple[int, ...]:
    """The tile of ``patch_breakup``'s first (``"in"``: Cin -> dim) or second
    (``"out"``: c -> c) GEMM, from the library (csrc/patch_resample.cu):
    rows, columns, blocks an SM holds, and 1 where the first GEMM holds whole
    output rows (the fused path, no fp32 rows in device memory)."""
    return cuda_build.tile_of("dsg_patch_breakup_tile", cin, dim, ("in", "out").index(which))


class _PatchMerge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_g, ln_b, w):
        ctx.save_for_backward(x, ln_g, ln_b, w)
        return patch_merge_fwd(x, ln_g, ln_b, w)

    @staticmethod
    def backward(ctx, dout):
        return cuda_build.plain_vjp(patch_merge_plain, ctx.saved_tensors, dout)


def patch_merge(x, ln_g, ln_b, w):
    """PatchMerging, differentiable (the kernel forward on CUDA tensors)."""
    return _PatchMerge.apply(x, ln_g, ln_b, w)


def patch_breakup_fwd(x, skip, w_in, ln1_g, ln1_b, ln2_g, ln2_b, w_out):
    """Forward alone: the kernel on CUDA tensors, the plain version on CPU."""
    if x.device.type == "cpu":
        return patch_breakup_plain(x, skip, w_in, ln1_g, ln1_b, ln2_g, ln2_b, w_out)
    b, h, ww, c1 = x.shape
    c2 = 0 if skip is None else skip.shape[-1]
    dim = w_in.shape[0]
    c = dim // 4
    if (w_in.shape[1] != c1 + c2 or dim % 64 or c > 384 or c1 % 8 or c2 % 8
            or (c1 + c2) % 16 or (c2 and c1 % 64) or tuple(w_out.shape) != (c, c)
            or (skip is not None and skip.shape[:3] != x.shape[:3])):
        raise ValueError(f"patch_breakup shapes x{tuple(x.shape)} w_in{tuple(w_in.shape)} "
                         "are not supported (4c a multiple of 64 up to 1536, Cin of 16, "
                         "C1 of 64 beside a skip)")
    bf, f32 = torch.bfloat16, torch.float32
    x = cuda_build.require(x, bf, "x")
    if skip is not None:
        skip = cuda_build.require(skip, bf, "skip")
    w_in = cuda_build.require(w_in, bf, "w_in")
    w_out = cuda_build.require(w_out, bf, "w_out")
    g1, b1, g2, b2 = (cuda_build.require(t, f32, n) for t, n in (
        (ln1_g, "ln1_g"), (ln1_b, "ln1_b"), (ln2_g, "ln2_g"), (ln2_b, "ln2_b")))
    m = b * h * ww
    sms = cuda_build.sm_count(x.device)
    tile_in = breakup_tile(c1 + c2, dim, "in")
    plan_in = cuda_build.gemm_plan(m, dim, tile_in, sms)
    plan_out = cuda_build.gemm_plan(4 * m, c, breakup_tile(c1 + c2, dim, "out"), sms)
    y = None if tile_in[3] else torch.empty((m, dim), dtype=f32, device=x.device)
    scattered = torch.empty((4 * m, c), dtype=bf, device=x.device)
    out = torch.empty((b, 2 * h, 2 * ww, c), dtype=bf, device=x.device)
    p = cuda_build.ptr
    cuda_build.launch(
        "patch_breakup", x.device, "dsg_patch_breakup",
        p(x), p(skip), c1, c2, p(w_in), p(g1), p(b1), p(g2), p(b2), p(w_out), p(y),
        p(scattered), p(out), b, h, ww, dim, plan_in["tiles"], plan_out["tiles"])
    cuda_build.count_launch("patch_breakup", f"{h}x{ww}xC{c1 + c2}->{c}")
    return out


class _PatchBreakup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, skip, w_in, ln1_g, ln1_b, ln2_g, ln2_b, w_out):
        ctx.save_for_backward(x, skip, w_in, ln1_g, ln1_b, ln2_g, ln2_b, w_out)
        return patch_breakup_fwd(x, skip, w_in, ln1_g, ln1_b, ln2_g, ln2_b, w_out)

    @staticmethod
    def backward(ctx, dout):
        return cuda_build.plain_vjp(patch_breakup_plain, ctx.saved_tensors, dout)


def patch_breakup(x, skip, w_in, ln1_g, ln1_b, ln2_g, ln2_b, w_out):
    """PatchBreakup, differentiable (the kernel forward on CUDA tensors)."""
    return _PatchBreakup.apply(x, skip, w_in, ln1_g, ln1_b, ln2_g, ln2_b, w_out)
