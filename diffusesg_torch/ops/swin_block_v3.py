"""One whole Swin block: the attention half, then the MLP half.

Counterpart of diffusesg_tpu/ops/swin_block_v3.py:

    a   = silu(shift + x * (scale + 1))
    y   = a + proj(W-MSA(qkv(LN1(a))))          (+ shifted-window mask)
    out = y + fc2(gelu(fc1(LN2(y))))

``swin_attn`` is a ``torch.autograd.Function``: on a CUDA tensor its forward
is the hand-written kernel ``swin_attn`` (csrc/swin_attn.cu: one launch per
block: the noise affine and LN1 of a block's windows, then per head qkv, the
window core and its share of proj, with q, k, v and the attention output on
chip, and the residual in the epilogue; a closing pass where ``attn_plan``
splits the heads) and its backward the kernel ``swin_attn_bwd`` (csrc/swin_attn_bwd.cu; the TPU's
``_attn_bwd_kernel``: one launch, ``window_attn_bwd_kernel_fused``, at VG's
64x64 C96 stage, a chain of launches at the others); on a CPU tensor both run
the plain versions below.  It
saves ``x``, ``scale_shift``, the parameters and ``rel_bias``; the backward
recomputes everything else.  ``fused_swin_block`` composes it with
``token_mlp``, so the only activation kept between the halves is ``y``, the
residual the JAX ``custom_vjp`` keeps.

Unlike the JAX entry, ``x`` is NOT pre-rolled: ``shift`` is passed in.  The
plain versions roll and unroll like the reference; the kernels fold the roll
into their window index math, so all take and return the unrolled spatial
layout, gradients included.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_build
from .mlp_block_kernel import layer_norm, ln_stats, ln_vjp, mlp_block_plain, token_mlp, up

NAME = "swin_attn"
NAME_BWD = "swin_attn_bwd"
WINDOWS = (8, 10)  # window sizes the kernels are built for (L = 64 and 100)


def window_core_plan(n_windows: int, num_heads: int, classes: int, per_sm: int,
                     sms: int = 132) -> int:
    """Windows per block of a window core (window attention alone, K11's
    ``window_attn_kernel``, and the backward's).  A block serves one head
    and one of ``classes`` mask classes (window index mod the class count; 1
    without a mask) and walks a run of that class's windows, so the bias is
    staged once per run.  The runs are as short as one wave of resident
    blocks (``sms`` x ``per_sm``, the blocks an SM holds) allows: every block
    is in flight at once, and none is empty."""
    classes = max(classes, 1)
    per_class = -(-n_windows // classes)
    blocks = max(1, min(per_class, sms * per_sm // (num_heads * classes)))
    return -(-per_class // blocks)


def core_blocks(n_windows: int, classes: int, wpb: int) -> int:
    """Blocks per head of a window-core grid of ``classes`` mask classes
    with runs of ``wpb`` windows (``window_core_plan``): the backward core
    writes one d(rel_bias) partial per block."""
    return classes * -(-(n_windows // classes) // wpb)


def attn_tile(device, c: int, L: int) -> tuple[int, ...]:
    """The tile of the ``swin_attn`` kernel at width C and window length L,
    from the library (csrc/swin_attn.cu ``dsg_swin_attn_tile``): rows,
    windows a block, blocks an SM holds, the most heads a block holds."""
    return cuda_build.tile_of(device, "dsg_swin_attn_tile", c, L)


def attn_plan(n_windows: int, heads: int, classes: int, tile: tuple[int, ...],
              sms: int = 132) -> dict[str, int]:
    """Grid plan of the ``swin_attn`` kernel: ``tiles`` blocks of
    ``tile[1]`` whole windows of one of ``classes`` mask classes (1 without
    a mask), each for every head or a group of ``heads`` consecutive heads
    (``groups`` of them, grid y).  One group where a block holds every head
    (``tile[3]``) and the tiles fill a wave of resident blocks (``sms`` x
    ``tile[2]``, the blocks an SM holds); else as many groups as fill that
    wave without passing it, and at least as many as the block needs.  Each
    group's proj is an fp32 partial that the closing pass adds in group
    order."""
    _, wpb, per_sm, most = tile[:4]
    classes = max(classes, 1)
    tiles = classes * -(-(n_windows // classes) // wpb)
    want = max(-(-heads // most), min(heads, sms * per_sm // tiles))
    per = -(-heads // want)
    return dict(tiles=tiles, groups=-(-heads // per), heads=per)


def _to_windows(t, window: int):
    """[B, H, W, K] -> [B * nW, L, K], windows in raster order."""
    b, h, w, k = t.shape
    t = t.reshape(b, h // window, window, w // window, window, k)
    return t.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, k)


def _from_windows(t, b: int, h: int, w: int, window: int):
    """Inverse of ``_to_windows``."""
    k = t.shape[-1]
    t = t.reshape(b, h // window, w // window, window, window, k)
    return t.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, k)


def _heads(t, num_heads: int):
    """[nWB, L, C] -> [nWB, nH, L, hd]."""
    return t.reshape(t.shape[0], t.shape[1], num_heads, -1).transpose(1, 2)


def _scores(q, k, rel_bias, mask):
    scores = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5 + up(rel_bias)[None]
    if mask is not None:
        nw = mask.shape[0]
        scores = scores + up(mask)[:, None].repeat(scores.shape[0] // nw, 1, 1, 1)
    return scores


def swin_attn_block_plain(x, scale_shift, ln_gamma, ln_beta, wqkv, bqkv, wproj, bproj,
                          rel_bias, mask, num_heads: int, window: int, shift: int = 0,
                          tp=None):
    """Attention half, x [B, H, W, C] (unrolled), scale_shift [B, 2C],
    rel_bias [nH, L, L], mask [nW, L, L] or None (reference:
    swin_attn_block_xla, with the roll of layers.SwinBlock around it).

    ``tp`` (a ``parallel.tp.ModelGroup``) runs this rank's heads of a block
    split over a model group: ``wqkv`` / ``bqkv`` their q, k and v rows,
    ``wproj`` their columns, ``rel_bias`` their tables, ``bproj`` None but on
    model rank 0; the LayerNorm's output enters the group (Megatron's f) and
    the projection's partial sums leave it (g)."""
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    b, h, w, c = x.shape
    dt = x.dtype
    scale, sh = up(scale_shift)[:, None, None, :].chunk(2, dim=-1)
    a = F.silu(sh + up(x) * (scale + 1.0)).to(dt)
    hn = layer_norm(a, ln_gamma, ln_beta).to(dt)
    if tp is not None:
        hn = tp.enter(hn)

    qkv = F.linear(up(_to_windows(hn, window)), up(wqkv), up(bqkv)).to(dt)
    q, k, v = (_heads(up(t), num_heads) for t in qkv.chunk(3, dim=-1))
    probs = torch.softmax(_scores(q, k, rel_bias, mask), dim=-1).to(dt)
    out = (up(probs) @ v).to(dt).transpose(1, 2).reshape(-1, window * window,
                                                         q.shape[1] * q.shape[3])
    out = F.linear(up(out), up(wproj), None if bproj is None else up(bproj))
    if tp is not None:
        out = tp.leave(out)
    out = _from_windows(out, b, h, w, window)
    y = (up(a) + out).to(dt)
    if shift > 0:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    return y


def _softmax_vjp(q, k, v, d_o, rel_bias, mask):
    """Probabilities and d(scores) of the window core, fp32, from its
    operands q, k, v, d(out) [nWB, nH, L, hd]."""
    probs = torch.softmax(_scores(q, k, rel_bias, mask), dim=-1)
    d_p = d_o @ v.transpose(-1, -2)
    return probs, probs * (d_p - (probs * d_p).sum(-1, keepdim=True))


def window_core_drel_plain(qkv, dattn, rel_bias, mask, num_heads: int, window: int,
                           shift: int = 0):
    """d(rel_bias) of the backward window core alone, from the bf16 operands
    it reads: qkv [B, H, W, 3C] and d(attn) [B, H, W, C] in unrolled raster
    order, as ``_swin_attn_bwd_kernel`` and ``swin_attn_bwd_operands_plain``
    return them (the rest of ``swin_attn_bwd_plain``'s d(rel_bias))."""
    if shift > 0:
        qkv, dattn = (torch.roll(t, (-shift, -shift), dims=(1, 2)) for t in (qkv, dattn))
    q, k, v = (_heads(up(t), num_heads) for t in _to_windows(qkv, window).chunk(3, dim=-1))
    d_o = _heads(up(_to_windows(dattn, window)), num_heads)
    return _softmax_vjp(q, k, v, d_o, rel_bias, mask)[1].sum(0)


def _bwd_recompute(x, scale_shift, dy, ln_gamma, ln_beta, wqkv, bqkv, wproj, window: int):
    """The recompute that opens ``swin_attn_bwd_plain``, on rolled x and dy:
    (pre, hbar, rstd) of the noise affine and LN1, and the bf16-rounded
    hn, qkv and d(attn) in windows [nWB, L, C / 3C / C], held in fp32."""
    dt = x.dtype
    scale, sh = up(scale_shift)[:, None, None, :].chunk(2, dim=-1)
    pre = sh + up(x) * (scale + 1.0)
    hbar, rstd = ln_stats(up(F.silu(pre).to(dt)))
    hn_w = up(_to_windows((hbar * up(ln_gamma) + up(ln_beta)).to(dt), window))
    qkv = up((hn_w @ up(wqkv).T + up(bqkv)).to(dt))
    dattn = up((_to_windows(up(dy), window) @ up(wproj)).to(dt))
    return pre, hbar, rstd, hn_w, qkv, dattn


def swin_attn_bwd_operands_plain(x, scale_shift, dy, ln_gamma, ln_beta, wqkv, bqkv, wproj,
                                 window: int, shift: int = 0):
    """hn, qkv and d(attn) as ``swin_attn_bwd_plain`` recomputes them, in x's
    dtype and unrolled raster order [B, H, W, C / 3C / C]: the operands of
    the window core and the weight gradients, laid out as
    ``_swin_attn_bwd_kernel`` returns its own."""
    if shift > 0:
        x, dy = (torch.roll(t, (-shift, -shift), dims=(1, 2)) for t in (x, dy))
    b, h, w, _ = x.shape
    ops = _bwd_recompute(x, scale_shift, dy, ln_gamma, ln_beta, wqkv, bqkv, wproj, window)[3:]
    ops = [_from_windows(t, b, h, w, window).to(x.dtype) for t in ops]
    if shift > 0:
        ops = [torch.roll(t, (shift, shift), dims=(1, 2)) for t in ops]
    return tuple(ops)


def swin_attn_bwd_plain(x, scale_shift, dy, ln_gamma, ln_beta, wqkv, bqkv, wproj, rel_bias,
                        mask, num_heads: int, window: int, shift: int = 0):
    """Backward of ``swin_attn_block_plain`` step by step, with the kernel's
    rounding points: x, dy [B, H, W, C] (unrolled) -> (dx, dscale_shift,
    dgamma, dbeta, dwqkv, dbqkv, dwproj, dbproj, drel_bias).  ``hn``, ``qkv``,
    the probabilities, ``attn``, ``dattn``, ``dS`` and ``dqkv`` are rounded to
    x's dtype once before the product that consumes them; the softmax, its
    vjp and every sum over tokens are fp32 (reference: _attn_bwd_kernel,
    without its lane packing)."""
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        dy = torch.roll(dy, (-shift, -shift), dims=(1, 2))
    b, h, w, c = x.shape
    dt = x.dtype
    gamma = up(ln_gamma)
    xf, dyf = up(x), up(dy)
    scale = up(scale_shift)[:, None, None, :c]
    pre, hbar, rstd, hn_w, qkv, dattn = _bwd_recompute(x, scale_shift, dy, ln_gamma, ln_beta,
                                                       wqkv, bqkv, wproj, window)
    q, k, v = (_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    dy_w = _to_windows(dyf, window)
    d_o = _heads(dattn, num_heads)
    probs, d_s = _softmax_vjp(q, k, v, d_o, rel_bias, mask)
    pb = up(probs.to(dt))
    attn_w = up((pb @ v).to(dt)).transpose(1, 2).reshape(-1, window * window, c)
    drel = d_s.sum(0)
    d_sb = up(d_s.to(dt))
    att_scale = q.shape[-1] ** -0.5
    dq = att_scale * (d_sb @ k)
    dk = att_scale * (d_sb.transpose(-1, -2) @ q)
    dv = pb.transpose(-1, -2) @ d_o
    dqkv_w = up(torch.cat([t.transpose(1, 2).reshape(-1, window * window, c)
                           for t in (dq, dk, dv)], dim=-1).to(dt))

    flat = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
    dwproj = flat(dy_w).T @ flat(attn_w)
    dbproj = flat(dyf).sum(0)
    dwqkv = flat(dqkv_w).T @ flat(hn_w)
    dbqkv = flat(dqkv_w).sum(0)
    dhn = _from_windows(dqkv_w @ up(wqkv), b, h, w, window)
    dgamma = (dhn * hbar).sum((0, 1, 2))
    dbeta = dhn.sum((0, 1, 2))
    da = dyf + ln_vjp(dhn, hbar, rstd, gamma)
    sig = torch.sigmoid(pre)
    dpre = da * sig * (1.0 + pre * (1.0 - sig))
    dx = (dpre * (scale + 1.0)).to(dt)
    dss = torch.cat([(dpre * xf).sum((1, 2)), dpre.sum((1, 2))], dim=-1)
    if shift > 0:
        dx = torch.roll(dx, (shift, shift), dims=(1, 2))
    return (dx, dss.to(scale_shift.dtype), dgamma.to(ln_gamma.dtype), dbeta.to(ln_beta.dtype),
            dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype), dwproj.to(wproj.dtype),
            dbproj.to(bqkv.dtype), drel.to(rel_bias.dtype))


def _checked(x, scale_shift, ln_gamma, ln_beta, wqkv, bqkv, wproj, rel_bias, mask,
             num_heads: int, window: int):
    b, h, w, c = x.shape
    if window not in WINDOWS or c != 32 * num_heads or h % window or w % window:
        raise ValueError(f"swin_attn covers windows {WINDOWS} and head_dim 32; got "
                         f"window={window} C={c} heads={num_heads} grid={h}x{w}")
    L = window * window
    if tuple(rel_bias.shape) != (num_heads, L, L):
        raise ValueError(f"rel_bias{tuple(rel_bias.shape)} is not [{num_heads}, {L}, {L}]")
    n_win = (h // window) * (w // window)
    if mask is not None and tuple(mask.shape) != (n_win, L, L):
        raise ValueError(f"mask{tuple(mask.shape)} is not [{n_win}, {L}, {L}]")
    bf, f32 = torch.bfloat16, torch.float32
    x = cuda_build.require(x, bf, "x")
    ss = cuda_build.require(scale_shift, bf, "scale_shift")
    wqkv = cuda_build.require(wqkv, bf, "wqkv")
    wproj = cuda_build.require(wproj, bf, "wproj")
    g, bt, bqkv, rel = (cuda_build.require(t, f32, n) for t, n in (
        (ln_gamma, "ln_gamma"), (ln_beta, "ln_beta"), (bqkv, "bqkv"), (rel_bias, "rel_bias")))
    if mask is not None:
        mask = cuda_build.require(mask, f32, "mask")
    return x, ss, g, bt, wqkv, bqkv, wproj, rel, mask


def _shape_key(h: int, w: int, c: int, shift: int) -> str:
    return f"{h}x{w}xC{c}" + (f" shift{shift}" if shift else "")


def swin_attn_fwd(x, scale_shift, ln_gamma, ln_beta, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                  num_heads: int, window: int, shift: int = 0):
    """Forward alone: the kernel on CUDA tensors, the plain version on CPU."""
    if x.device.type == "cpu":
        return swin_attn_block_plain(x, scale_shift, ln_gamma, ln_beta, wqkv, bqkv, wproj,
                                     bproj, rel_bias, mask, num_heads, window, shift)
    x, ss, g, bt, wqkv, bqkv, wproj, rel, mask = _checked(
        x, scale_shift, ln_gamma, ln_beta, wqkv, bqkv, wproj, rel_bias, mask, num_heads, window)
    bproj = cuda_build.require(bproj, torch.float32, "bproj")
    b, h, w, c = x.shape
    n_win = (h // window) * (w // window)
    plan = attn_plan(b * n_win, num_heads, n_win if mask is not None else 1,
                     attn_tile(x.device, c, window * window), cuda_build.sm_count(x.device))
    part = (torch.empty((plan["groups"], b * h * w, c), dtype=torch.float32, device=x.device)
            if plan["groups"] > 1 else None)
    out = torch.empty_like(x)
    p = cuda_build.ptr
    cuda_build.launch(
        NAME, x.device, "dsg_swin_attn",
        p(x), p(ss), p(g), p(bt), p(wqkv), p(bqkv), p(wproj), p(bproj), p(rel), p(mask),
        p(part), p(out), b, h, w, c, num_heads, window, shift, plan["groups"])
    cuda_build.count_launch(NAME, _shape_key(h, w, c, shift) + f" g{plan['groups']}")
    return out


def attn_bwd_splits(b: int, h: int, w: int, c: int, num_heads: int, window: int) -> dict[str, int]:
    """The reductions of ``swin_attn_bwd`` beside its GEMMs and its window
    core: row splits of the two bias sums over the B*H*W tokens and the
    blocks per sample of the closing row pass."""
    m = b * h * w
    return dict(bqkv=cuda_build.split_count(-(-3 * c // 256), m, 64),
                bproj=cuda_build.split_count(-(-c // 256), m, 64),
                rows=min(-(-h * w // 8), max(1, -(-cuda_build.TARGET_BLOCKS // b))))


def attn_bwd_tile(device, c: int, which: str, wide: bool = False) -> tuple[int, ...]:
    """A tile of ``swin_attn_bwd``'s GEMMs at width C from the library
    (csrc/swin_attn_bwd.cu ``dsg_swin_attn_bwd_tile``): "qkv" the recompute
    (64-row panels if ``wide``), "stream" dy Wproj and dqkv Wqkv, "wgrad" the
    weight gradients; rows, columns, blocks an SM holds, 0."""
    return cuda_build.tile_of(device, "dsg_swin_attn_bwd_tile", c,
                              ("qkv", "stream", "wgrad").index(which), int(wide))


def attn_bwd_gemm_plan(m: int, c: int, device) -> dict[str, int]:
    """Grid plan of ``swin_attn_bwd``'s GEMMs over ``m`` tokens at width C:
    the qkv recompute's panels and column split as the forward's
    (``wide_panels``, ``gemm_plan``), the column splits of the two streamed
    products, and the token split of the two weight gradients (``w``
    splits of ``kchunk`` tokens, planned on dWqkv's tiles)."""
    sms = cuda_build.sm_count(device)
    wide = cuda_build.wide_panels(m, 3 * c, lambda wd: attn_bwd_tile(device, c, "qkv", wd), sms)
    stream, wt = attn_bwd_tile(device, c, "stream"), attn_bwd_tile(device, c, "wgrad")
    splits, chunk = cuda_build.token_split(-(-3 * c // wt[0]) * -(-c // wt[1]), m, wt[2], sms)
    qkv = attn_bwd_tile(device, c, "qkv", wide)
    return dict(wide=int(wide), qkv=cuda_build.gemm_plan(m, 3 * c, qkv, sms)["tiles"],
                dattn=cuda_build.gemm_plan(m, c, stream, sms)["tiles"],
                dhn=cuda_build.gemm_plan(m, c, stream, sms)["tiles"], w=splits, kchunk=chunk)


def attn_bwd_fused_tile(device, c: int, L: int) -> tuple[int, ...] | None:
    """The tile of the fused backward kernel ``window_attn_bwd_kernel_fused``
    at width C and window length L, from the library (csrc/swin_attn_bwd.cu
    ``dsg_swin_attn_bwd_fused_tile``): rows, 0, blocks an SM holds, 0; None
    where it does not cover (C, L): it holds two windows' panels beside the
    head's working set and the handed-over dhn at C96 and window 8 only, and
    every other shape runs the chain of launches."""
    try:
        return cuda_build.tile_of(device, "dsg_swin_attn_bwd_fused_tile", c, L)
    except ValueError:
        return None


def attn_bwd_fused_plan(n_windows: int, tile: tuple[int, ...], sms: int = 132) -> int:
    """Blocks of the fused backward: one wave of resident blocks (``sms`` x
    ``tile[2]``, the blocks an SM holds), at most one a window.  Block x
    walks windows x, x + blocks, ... and keeps one d(rel_bias) partial."""
    return max(1, min(n_windows, sms * tile[2]))


def swin_attn_bwd(x, scale_shift, dy, ln_gamma, ln_beta, wqkv, bqkv, wproj, rel_bias, mask,
                  num_heads: int, window: int, shift: int = 0):
    """Backward of the attention half: the kernel on CUDA tensors, the plain
    version on CPU.  Returns (dx, dscale_shift, dgamma, dbeta, dwqkv, dbqkv,
    dwproj, dbproj, drel_bias), each in its primal's dtype."""
    if x.device.type == "cpu":
        return swin_attn_bwd_plain(x, scale_shift, dy, ln_gamma, ln_beta, wqkv, bqkv, wproj,
                                   rel_bias, mask, num_heads, window, shift)
    return _swin_attn_bwd_kernel(x, scale_shift, dy, ln_gamma, ln_beta, wqkv, bqkv, wproj,
                                 rel_bias, mask, num_heads, window, shift)[0]


def _swin_attn_bwd_kernel(x, scale_shift, dy, ln_gamma, ln_beta, wqkv, bqkv, wproj, rel_bias,
                          mask, num_heads: int, window: int, shift: int = 0):
    """The launch of ``swin_attn_bwd``: its nine gradients, and the bf16 hn,
    qkv and d(attn) [B, H, W, C / 3C / C] of its recompute, which its window
    core and weight gradients read (``swin_attn_bwd_operands_plain`` gives
    the plain version's; ``window_core_drel_plain`` checks the core alone).
    Where the fused kernel runs, qkv and d(attn) stay on chip: None."""
    x, ss, g, bt, wqkv, bqkv, wproj, rel, mask = _checked(
        x, scale_shift, ln_gamma, ln_beta, wqkv, bqkv, wproj, rel_bias, mask, num_heads, window)
    b, h, w, c = x.shape
    if c > 768:
        raise ValueError(f"swin_attn_bwd covers C <= 768, got {c}")
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    dy = cuda_build.require(dy, bf, "dy")
    if dy.shape != x.shape:
        raise ValueError(f"dy{tuple(dy.shape)} does not match x{tuple(x.shape)}")
    m, L = b * h * w, window * window
    sms = cuda_build.sm_count(dev)
    gp = attn_bwd_gemm_plan(m, c, dev)
    fused = attn_bwd_fused_tile(dev, c, L)
    if fused is not None:
        return _swin_attn_bwd_fused(x, ss, dy, g, bt, wqkv, bqkv, wproj, rel, mask, num_heads,
                                    window, shift, fused, gp)
    sp = attn_bwd_splits(b, h, w, c, num_heads, window)
    # the backward core's grid as the forward's: runs of one mask class
    n_win = b * (h // window) * (w // window)
    classes = (h // window) * (w // window) if mask is not None else 1
    per_sm = cuda_build.blocks_per_sm(dev, "dsg_swin_attn_bwd_core_per_sm", L)
    wpb = window_core_plan(n_win, num_heads, classes, per_sm, sms)

    def buf(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    hn, dattn, attn = (buf(m, c, dtype=bf) for _ in range(3))
    qkv, dqkv = (buf(m, 3 * c, dtype=bf) for _ in range(2))
    dhn = buf(m, c)
    part_w = buf(gp["w"], 4 * c * c)
    part_bqkv, part_bproj = buf(sp["bqkv"], 3 * c), buf(sp["bproj"], c)
    part_rel = buf(core_blocks(n_win, classes, wpb), num_heads, L, L)
    part_rows = buf(b * sp["rows"], 4 * c)
    dx = torch.empty_like(x)
    dss, dgb = buf(b, 2 * c), buf(2, c)
    dw, dbqkv, dbproj = buf(4 * c * c), buf(3 * c), buf(c)  # dw: dWqkv then dWproj
    drel = buf(num_heads, L, L)
    p = cuda_build.ptr
    cuda_build.launch(
        NAME_BWD, dev, "dsg_swin_attn_bwd",
        p(x), p(ss), p(dy), p(g), p(bt), p(wqkv), p(bqkv), p(wproj), p(rel), p(mask),
        p(hn), p(qkv), p(dattn), p(attn), p(dqkv), p(dhn), p(part_w), p(part_bqkv),
        p(part_bproj), p(part_rel), p(part_rows),
        p(dx), p(dss), p(dgb), p(dw), p(dbqkv), p(dbproj), p(drel),
        b, h, w, c, num_heads, window, shift, gp["wide"], gp["qkv"], gp["dattn"], gp["dhn"],
        gp["w"], gp["kchunk"], sp["bqkv"], sp["bproj"], wpb, sp["rows"])
    cuda_build.count_launch(NAME_BWD, _shape_key(h, w, c, shift))
    dwqkv, dwproj = dw[:3 * c * c].view(3 * c, c), dw[3 * c * c:].view(c, c)
    grads = dx, dss.to(bf), dgb[0], dgb[1], dwqkv.to(bf), dbqkv, dwproj.to(bf), dbproj, drel
    return grads, (hn.view(b, h, w, c), qkv.view(b, h, w, 3 * c), dattn.view(b, h, w, c))


def _swin_attn_bwd_fused(x, ss, dy, g, bt, wqkv, bqkv, wproj, rel, mask, num_heads: int,
                         window: int, shift: int, tile: tuple[int, ...], gp: dict[str, int]):
    """``_swin_attn_bwd_kernel`` through ``window_attn_bwd_kernel_fused``
    (operands checked): its nine gradients and the bf16 hn it stores for
    dWqkv; qkv and d(attn) never reach device memory (None)."""
    b, h, w, c = x.shape
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    m, L = b * h * w, window * window
    nw = (h // window) * (w // window)
    blocks = attn_bwd_fused_plan(b * nw, tile, cuda_build.sm_count(dev))

    def buf(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    hn, attn = buf(m, c, dtype=bf), buf(m, c, dtype=bf)
    dqkv = buf(m, 3 * c, dtype=bf)
    part_rel, part_win = buf(blocks, num_heads, L, L), buf(b * nw, 8 * c)
    part_b, part_w = buf(b, 8 * c), buf(gp["w"], 4 * c * c)
    dx = torch.empty_like(x)
    dss, dgb = buf(b, 2 * c), buf(2, c)
    dw, dbias, drel = buf(4 * c * c), buf(4 * c), buf(num_heads, L, L)  # dbias: dbproj | dbqkv
    wproj_t = wproj.t().contiguous()
    p = cuda_build.ptr
    cuda_build.launch(
        NAME_BWD, dev, "dsg_swin_attn_bwd_fused",
        p(x), p(ss), p(dy), p(g), p(bt), p(wqkv), p(bqkv), p(wproj_t), p(rel), p(mask),
        p(hn), p(attn), p(dqkv), p(part_rel), p(part_win), p(part_b), p(part_w),
        p(dx), p(dss), p(dgb), p(dw), p(dbias), p(drel),
        b, h, w, c, num_heads, window, shift, blocks, gp["w"], gp["kchunk"])
    cuda_build.count_launch(NAME_BWD, _shape_key(h, w, c, shift) + " fused")
    dwqkv, dwproj = dw[:3 * c * c].view(3 * c, c), dw[3 * c * c:].view(c, c)
    grads = (dx, dss.to(bf), dgb[0], dgb[1], dwqkv.to(bf), dbias[c:], dwproj.to(bf), dbias[:c],
             drel)
    return grads, (hn.view(b, h, w, c), None, None)


class _SwinAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale_shift, ln_gamma, ln_beta, wqkv, bqkv, wproj, bproj, rel_bias,
                mask, num_heads, window, shift):
        ctx.save_for_backward(x, scale_shift, ln_gamma, ln_beta, wqkv, bqkv, wproj, rel_bias,
                              mask)
        ctx.geometry = (num_heads, window, shift)
        return swin_attn_fwd(x, scale_shift, ln_gamma, ln_beta, wqkv, bqkv, wproj, bproj,
                             rel_bias, mask, num_heads, window, shift)

    @staticmethod
    def backward(ctx, dy):
        x, ss, g, bt, wqkv, bqkv, wproj, rel, mask = ctx.saved_tensors
        dx, dss, dg, db, dwqkv, dbqkv, dwproj, dbproj, drel = swin_attn_bwd(
            x, ss, dy.to(x.dtype).contiguous(), g, bt, wqkv, bqkv, wproj, rel, mask,
            *ctx.geometry)
        # the mask is a constant of the geometry: no gradient
        return dx, dss, dg, db, dwqkv, dbqkv, dwproj, dbproj, drel, None, None, None, None


def swin_attn(x, scale_shift, ln_gamma, ln_beta, wqkv, bqkv, wproj, bproj, rel_bias, mask,
              num_heads: int, window: int, shift: int = 0):
    """Attention half, differentiable: kernels on CUDA tensors (forward
    ``swin_attn``, backward ``swin_attn_bwd``), the plain versions on CPU."""
    return _SwinAttn.apply(x, scale_shift, ln_gamma, ln_beta, wqkv, bqkv, wproj, bproj,
                           rel_bias, mask, num_heads, window, shift)


def swin_block_plain(x, scale_shift, ln1_g, ln1_b, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                     ln2_g, ln2_b, w1, b1, w2, b2, num_heads: int, window: int,
                     shift: int = 0, attn_tp=None, mlp_tp=None):
    """Whole block, plain: ``swin_attn_block_plain`` then ``mlp_block_plain``
    (reference: swin_attn_block_xla and mlp_block_xla, the model's path with
    its kernels switched off); differentiated by autograd.  ``attn_tp`` /
    ``mlp_tp``: the model group each half is split over (tensor parallel,
    parallel/tp.py), None for a half that is not."""
    y = swin_attn_block_plain(x, scale_shift, ln1_g, ln1_b, wqkv, bqkv, wproj, bproj, rel_bias,
                              mask, num_heads, window, shift, tp=attn_tp)
    return mlp_block_plain(y, ln2_g, ln2_b, w1, b1, w2, b2, tp=mlp_tp)


def fused_swin_block(x, scale_shift, ln1_g, ln1_b, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                     ln2_g, ln2_b, w1, b1, w2, b2, num_heads: int, window: int,
                     shift: int = 0):
    """Whole block: ``swin_attn`` then ``token_mlp`` (kernels on CUDA)."""
    y = swin_attn(x, scale_shift, ln1_g, ln1_b, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                  num_heads, window, shift)
    return token_mlp(y, ln2_g, ln2_b, w1, b1, w2, b2)
