"""PatchMerging / PatchBreakup: the U-Net's 2x down- and upsampling.

Counterpart of diffusesg_tpu/ops/patch_resample.py.  On a CUDA tensor the
forwards run as the hand-written kernels ``patch_merge`` and
``patch_breakup`` (csrc/patch_resample.cu); on a CPU tensor as the plain
versions below.  The merge is one launch of the Hopper GEMM
(csrc/hopper_gemm.cuh) whose prologue gathers and normalizes the rows in
shared memory (C a multiple of 8, 4C up to 1536).  Both are
``torch.autograd.Function``s that save their inputs.  Their backwards
(``patch_merge_bwd``, ``patch_breakup_bwd``) run kernels on CUDA tensors
(csrc/patch_resample.cu: the products on the Hopper GEMM, a row pass for the
LayerNorms' vjps, fixed-order reductions) that recompute what they need from
the saved inputs; on CPU tensors they recompute the plain version and
differentiate it (``cuda_build.plain_vjp``), as the JAX ``custom_vjp``
differentiates its XLA composition.  Channel orders match the reference: merge concatenates
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


# the backwards' GEMM tiles, as dsg_patch_resample_bwd_tile numbers them
BWD_TILES = ("merge_dhn", "merge_dw", "breakup_y", "breakup_dh", "breakup_dx", "breakup_dw_out",
             "breakup_dw_in")
# the least share of its last wave's block slots a weight gradient's split fills
WAVE_FILL = 0.9


def bwd_tile(which: str, k: int) -> tuple[int, ...]:
    """A tile of the backwards' GEMMs from the library (csrc/patch_resample.cu
    ``dsg_patch_resample_bwd_tile``): the products at K = ``k`` ("merge_dhn",
    "breakup_y", "breakup_dh", "breakup_dx"), the weight gradients at ``k``
    output columns ("merge_dw", "breakup_dw_out", "breakup_dw_in"): rows,
    columns, blocks an SM holds, 0."""
    return cuda_build.tile_of("dsg_patch_resample_bwd_tile", BWD_TILES.index(which), k)


def wgrad_split(tiles: int, tokens: int, per_sm: int, sms: int = 132) -> tuple[int, int]:
    """(splits, chunk) of a weight gradient's token-axis contraction
    (csrc/backward.cuh ``launch_wgrad``) whose output is ``tiles`` blocks:
    the fewest splits whose blocks fill ``WAVE_FILL`` of the card's block
    slots (``sms`` x ``per_sm``) over their waves, else the fullest; chunks
    of whole 64-token boxes, at least ``TOKEN_SPLIT_MIN`` tokens each unless
    there are fewer.  Block z covers [z chunk, (z + 1) chunk), and no split
    is empty."""
    slots = sms * per_sm
    most = max(1, tokens // cuda_build.TOKEN_SPLIT_MIN)

    def fill(s):
        return tiles * s / (-(-tiles * s // slots) * slots)
    splits = next((s for s in range(1, most + 1) if fill(s) >= WAVE_FILL), None)
    if splits is None:
        splits = max(range(1, most + 1), key=fill)
    chunk = -(-(-(-tokens // splits)) // cuda_build.TOKEN_BOX) * cuda_build.TOKEN_BOX
    return -(-tokens // chunk), chunk


def row_blocks(m: int, which: str, width: int, sms: int = 132) -> int:
    """Blocks of a backward row pass ("merge" at K = ``width``, "breakup" at
    c = ``width``) over ``m`` rows, four warps a block and a row a warp at a
    time: one wave of the blocks the card holds (the library's occupancy),
    fewer where the rows are few."""
    per_sm = cuda_build.blocks_per_sm("dsg_patch_resample_bwd_rows_per_sm",
                                      ("merge", "breakup").index(which), width)
    return max(1, min(sms * per_sm, -(-m // 4)))


def merge_bwd_plan(m: int, c: int, c_out: int, sms: int = 132) -> dict[str, int]:
    """Grid plan of ``patch_merge_bwd`` over ``m`` merged tokens at width C
    with ``c_out`` outputs: the column split of dhn = dy W (``gemm_plan``,
    K = c_out rounded up to 16), the row pass's blocks, and the token split
    of dW = dy^T hn (``wgrad_split``)."""
    k = 4 * c
    dhn = cuda_build.gemm_plan(m, k, bwd_tile("merge_dhn", -(-c_out // 16) * 16), sms)["tiles"]
    wt = bwd_tile("merge_dw", k)
    splits, chunk = wgrad_split(-(-c_out // wt[0]) * -(-k // wt[1]), m, wt[2], sms)
    return dict(dhn=dhn, rows=row_blocks(m, "merge", k, sms), w=splits, kchunk=chunk)


def patch_merge_bwd(x, ln_g, ln_b, w, dout):
    """Backward of PatchMerging: (dx, d ln_g, d ln_b, dw), each in its
    primal's dtype.  The kernels on CUDA tensors; on CPU tensors the plain
    version differentiated (``plain_vjp``)."""
    if x.device.type == "cpu":
        return cuda_build.plain_vjp(patch_merge_plain, (x, ln_g, ln_b, w), dout)
    b, h, ww, c = x.shape
    c_out = w.shape[0]
    if h % 2 or ww % 2 or c % 8 or 4 * c > 1536 or w.shape[1] != 4 * c or c_out % 8:
        raise ValueError(f"patch_merge_bwd shapes x{tuple(x.shape)} w{tuple(w.shape)} "
                         "are not supported")
    bf, f32, dev = torch.bfloat16, torch.float32, x.device
    x = cuda_build.require(x, bf, "x")
    w = cuda_build.require(w, bf, "w")
    g = cuda_build.require(ln_g, f32, "ln_g")
    bt = cuda_build.require(ln_b, f32, "ln_b")
    m, k = b * (h // 2) * (ww // 2), 4 * c
    dy = dout.to(bf).contiguous().reshape(m, c_out)
    # dhn = dy W takes K in steps of 16: zero columns of dy and rows of W where c_out is not
    pad = -c_out % 16
    dy_k, w_k = (dy, w) if not pad else (F.pad(dy, (0, pad)), F.pad(w, (0, 0, 0, pad)))
    plan = merge_bwd_plan(m, c, c_out, cuda_build.sm_count(dev))

    def buf(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)
    dhn, hn = buf(m, k, dtype=bf), buf(m, k, dtype=bf)
    part_w, part_ln = buf(plan["w"], c_out * k), buf(plan["rows"], 2 * k)
    dx, dw, dln = torch.empty_like(x), torch.empty_like(w), buf(2 * k)
    p = cuda_build.ptr
    cuda_build.launch("patch_merge_bwd", dev, "dsg_patch_merge_bwd",
                      p(x), p(g), p(bt), p(dy), p(dy_k), p(w_k), c_out + pad, p(dhn), p(hn),
                      p(part_w), p(part_ln), p(dx), p(dw), p(dln), b, h, ww, c, c_out,
                      plan["dhn"], plan["rows"], plan["w"], plan["kchunk"])
    cuda_build.count_launch("patch_merge_bwd", f"{h}x{ww}xC{c}")
    return dx, dln[:k], dln[k:], dw


class _PatchMerge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_g, ln_b, w):
        ctx.save_for_backward(x, ln_g, ln_b, w)
        return patch_merge_fwd(x, ln_g, ln_b, w)

    @staticmethod
    def backward(ctx, dout):
        return patch_merge_bwd(*ctx.saved_tensors, dout)


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


def breakup_bwd_plan(m: int, c1: int, c2: int, dim: int, sms: int = 132) -> dict[str, int]:
    """Grid plan of ``patch_breakup_bwd`` over ``m`` input tokens of C1 + C2
    channels and 4c = ``dim``: the column splits (``gemm_plan``) of y =
    [x | skip] W_in^T (``y``), dh2 = dout W_out (``dh``) and [dx | dskip] =
    dy W_in over the three terms of dy (``dx``), the row pass's blocks, and
    the token splits (``wgrad_split``) of dW_out over the 4m output tokens and
    of dW_in (one plan for its x and skip launches, from the larger)."""
    cin, c = c1 + c2, dim // 4
    y = cuda_build.gemm_plan(m, dim, bwd_tile("breakup_y", cin), sms)["tiles"]
    dh = cuda_build.gemm_plan(4 * m, c, bwd_tile("breakup_dh", c), sms)["tiles"]
    dx = cuda_build.gemm_plan(m, cin, bwd_tile("breakup_dx", 3 * dim), sms)["tiles"]
    wo = bwd_tile("breakup_dw_out", c)
    w_out, kchunk_out = wgrad_split(-(-c // wo[0]) * -(-c // wo[1]), 4 * m, wo[2], sms)
    wi = [bwd_tile("breakup_dw_in", j) for j in (c1, c2) if j]
    tiles = max(-(-3 * dim // t[0]) * -(-j // t[1]) for t, j in zip(wi, (c1, c2)))
    w_in, kchunk_in = wgrad_split(tiles, m, min(t[2] for t in wi), sms)
    return dict(y=y, dh=dh, dx=dx, rows=row_blocks(m, "breakup", c, sms), w_out=w_out,
                kchunk_out=kchunk_out,
                w_in=w_in, kchunk_in=kchunk_in)


def patch_breakup_bwd(x, skip, w_in, ln1_g, ln1_b, ln2_g, ln2_b, w_out, dout):
    """Backward of PatchBreakup: (dx, dskip, dw_in, d ln1_g, d ln1_b,
    d ln2_g, d ln2_b, dw_out), each in its primal's dtype (dskip None without
    a skip).  The kernels on CUDA tensors; on CPU tensors the plain version
    differentiated (``plain_vjp``)."""
    args = (x, skip, w_in, ln1_g, ln1_b, ln2_g, ln2_b, w_out)
    if x.device.type == "cpu":
        return cuda_build.plain_vjp(patch_breakup_plain, args, dout)
    b, h, ww, c1 = x.shape
    c2 = 0 if skip is None else skip.shape[-1]
    dim = w_in.shape[0]
    c = dim // 4
    if (w_in.shape[1] != c1 + c2 or dim % 64 or c > 384 or c1 % 8 or c2 % 8
            or (c1 + c2) % 16 or (c2 and c1 % 64) or tuple(w_out.shape) != (c, c)
            or (skip is not None and skip.shape[:3] != x.shape[:3])):
        raise ValueError(f"patch_breakup_bwd shapes x{tuple(x.shape)} w_in{tuple(w_in.shape)} "
                         "are not supported")
    bf, f32, dev = torch.bfloat16, torch.float32, x.device
    x = cuda_build.require(x, bf, "x")
    if skip is not None:
        skip = cuda_build.require(skip, bf, "skip")
    w_in = cuda_build.require(w_in, bf, "w_in")
    w_out = cuda_build.require(w_out, bf, "w_out")
    g1, b1, g2, b2 = (cuda_build.require(t, f32, n) for t, n in (
        (ln1_g, "ln1_g"), (ln1_b, "ln1_b"), (ln2_g, "ln2_g"), (ln2_b, "ln2_b")))
    m, cin = b * h * ww, c1 + c2
    do = dout.to(bf).contiguous()
    plan = breakup_bwd_plan(m, c1, c2, dim, cuda_build.sm_count(dev))

    def buf(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)
    y, dy = buf(m, dim), buf(m, 3 * dim, dtype=bf)
    dh, h2 = buf(4 * m, c, dtype=bf), buf(4 * m, c, dtype=bf)
    w3 = buf(3 * dim, cin, dtype=bf)
    part_w = buf(plan["w_out"] * c * c + plan["w_in"] * 3 * dim * cin)
    part_ln = buf(plan["rows"], 10 * c)
    dx = torch.empty_like(x)
    dskip = None if skip is None else torch.empty_like(skip)
    dw_in, dw_out, dln = torch.empty_like(w_in), torch.empty_like(w_out), buf(10 * c)
    p = cuda_build.ptr
    cuda_build.launch(
        "patch_breakup_bwd", dev, "dsg_patch_breakup_bwd",
        p(x), p(skip), c1, c2, p(w_in), p(g1), p(b1), p(g2), p(b2), p(w_out), p(do),
        p(y), p(dh), p(h2), p(dy), p(w3), p(part_w), p(part_ln),
        p(dx), p(dskip), p(dw_in), p(dw_out), p(dln), b, h, ww, dim,
        plan["y"], plan["dh"], plan["dx"], plan["rows"], plan["w_out"], plan["kchunk_out"],
        plan["w_in"], plan["kchunk_in"])
    cuda_build.count_launch("patch_breakup_bwd", f"{h}x{ww}xC{cin}->{c}")
    dg1, db1, dg2, db2 = dln.split([dim, dim, c, c])
    return dx, dskip, dw_in, dg1, db1, dg2, db2, dw_out


class _PatchBreakup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, skip, w_in, ln1_g, ln1_b, ln2_g, ln2_b, w_out):
        ctx.save_for_backward(x, skip, w_in, ln1_g, ln1_b, ln2_g, ln2_b, w_out)
        return patch_breakup_fwd(x, skip, w_in, ln1_g, ln1_b, ln2_g, ln2_b, w_out)

    @staticmethod
    def backward(ctx, dout):
        return patch_breakup_bwd(*ctx.saved_tensors, dout)


def patch_breakup(x, skip, w_in, ln1_g, ln1_b, ln2_g, ln2_b, w_out):
    """PatchBreakup, differentiable (the kernel forward on CUDA tensors)."""
    return _PatchBreakup.apply(x, skip, w_in, ln1_g, ln1_b, ln2_g, ln2_b, w_out)
