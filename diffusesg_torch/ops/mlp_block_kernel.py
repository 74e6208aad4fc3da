"""MLP half of a Swin block: ``y = x + fc2(gelu(fc1(LN(x))))`` per token.

Counterpart of diffusesg_tpu/ops/mlp_block_kernel.py.  ``token_mlp`` is a
``torch.autograd.Function``: on a CUDA tensor its forward is the
hand-written kernel ``token_mlp`` (csrc/token_mlp.cu, one fused wgmma launch
in which the [M, 4C] hidden stays on chip, plus a closing pass where a
tile's hidden chunks are cut between blocks, ``mlp_fwd_plan``), which serves every
Swin block's MLP half (the TPU's ``fused_mlp_block`` and the MLP half of
``fused_swin_block_v3``), and its backward the kernel ``token_mlp_bwd``
(csrc/token_mlp_bwd.cu; the TPU's ``_mlp_bwd_kernel`` and, at C = 768,
``_mlp_bwd_export_kernel``): one fused row-tile launch where the library has
a tile for C (C96, C192), else a chain of wgmma GEMMs, then the two weight
gradients (``mlp_bwd_plan``).  On a CPU tensor both run the plain versions
below.  The forward saves ``x`` and the parameters and nothing else; the
backward recomputes.  Weights are in the PyTorch Linear layout ([out, in]).
"""
from __future__ import annotations

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


def mlp_block_plain(x, ln_gamma, ln_beta, w1, b1, w2, b2, tp=None):
    """x [..., C] -> same shape (reference: mlp_block_xla, exact erf GELU).
    ``tp`` (a ``parallel.tp.ModelGroup``) runs this rank's hidden columns of
    an MLP split over a model group (``w1`` / ``b1`` their rows, ``w2``
    their columns, ``b2`` None but on model rank 0), between Megatron's f
    and g."""
    h = layer_norm(x, ln_gamma, ln_beta).to(x.dtype)
    if tp is not None:
        h = tp.enter(h)
    h = F.linear(up(h), up(w1), up(b1))
    h = F.gelu(h).to(x.dtype)
    out = F.linear(up(h), up(w2), None if b2 is None else up(b2))
    if tp is not None:
        out = tp.leave(out)
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


def mlp_tile(device, c: int) -> tuple[int, int, int, int]:
    """The fused forward kernel's tile at C, from the library
    (csrc/token_mlp.cu MlpConfig): token rows a block, hidden columns a
    chunk, the blocks an SM holds (the card's occupancy), and the column
    groups a row tile's fc2 columns are cut into, a block each (2 at C768)."""
    return cuda_build.tile_of(device, "dsg_token_mlp_tile", c)


# What a tile's fixed work (LN2 prologue, ramp, epilogue) and the closing
# pass cost, in hidden chunks' time: on the H100 3.5-7 and 3-5.5 from C96 to
# C384 (PERF.md §6, PR 19).  mlp_fwd_plan weighs them where whole tiles
# leave more than 1 - WHOLE_TILE_FILL of the card's slots idle.
SEGMENT_CHUNKS = 5
CLOSE_CHUNKS = 4
WHOLE_TILE_FILL = 0.9


def mlp_units(m: int, hidden: int, tile) -> tuple[int, int]:
    """(tiles, hidden chunks a tile) of ``token_mlp`` over ``m`` tokens: a
    tile is a row tile's column group, and the launch's units are tiles x
    chunks, unit u = (u // chunks, u % chunks)."""
    return -(-m // tile[0]) * tile[3], hidden // tile[1]


def mlp_plan_costs(tiles: int, chunks: int, slots: int) -> tuple[float, float]:
    """(whole, cut): the time of ``tiles`` x ``chunks`` units on ``slots``
    block slots, in chunks, with one block a whole tile (waves of a tile's
    chunks and fixed work), and with every slot taking an even share of the
    units (its chunks, the fixed work of every tile it touches, and the
    closing pass)."""
    blocks, units = min(slots, tiles * chunks), tiles * chunks
    whole = -(-tiles // slots) * (chunks + SEGMENT_CHUNKS)
    cut = -(-units // blocks) + SEGMENT_CHUNKS * (tiles / blocks + 1) + CLOSE_CHUNKS
    return whole, cut


def mlp_fwd_plan(m: int, hidden: int, tile: tuple[int, ...], sms: int = 132) -> dict[str, int]:
    """Grid plan of the fused ``token_mlp`` over ``m`` tokens: ``blocks``
    blocks take even, ordered shares of the ``tiles`` x ``chunks`` units
    (``mlp_units``); ``split`` is 1 where a tile is cut between blocks, which
    then write fp32 partials (two slots a block) that a closing pass adds in
    block order.  ``tile`` is ``mlp_tile(C)``.  The card has ``sms`` x the
    blocks an SM holds slots (132 x 1 on the H100).  The plan takes one block
    a whole tile where whole tiles keep ``WHOLE_TILE_FILL`` of the slots busy
    over their waves; else that or cut tiles, so that every slot is busy to
    the end, whichever ``mlp_plan_costs`` finds cheaper.

    - Whole tiles that fill their waves at the benchmark's shapes at batch
      64: VG M = 262,144 / 65,536 / 16,384 / 4,096 at C96 / C192 / C384 /
      C768 (2048 / 512 / 256 / 128 tiles, 0.97 of 16 / 4 / 2 / 1 waves; last
      waves of 68 / 116 / 124 / 128 blocks), and training at 1000 graphs
      (16x the VG rows, 0.97-0.997): a cut would add partials and a closing
      pass for under a tenth of idle slots.
    - Whole tiles, the cheaper, at COCO M = 25,600 / 6,400 at C192 / C384
      (200 / 100 tiles, last waves of 68 / 100 blocks).  Cutting them fills
      every SM but costs more: on the H100 at 700 W, device time 87.5 us
      (76.0 in the kernel, 11.5 in the closing pass) against 77.8 whole at
      C192, 68.3 (57.8 + 10.5) against 59.0 at C384: nearly every block gets
      a second tile's fixed work.
    - Cut tiles at COCO M = 102,400 at C96 (800 tiles, 0.87 of 7 waves: 132
      blocks of 36-37 units; 121.3 us against 129.0 whole), and where tiles
      are few against the slots (VG's C384 and C768 at batch 16: 64 and 32
      tiles)."""
    tiles, chunks = mlp_units(m, hidden, tile)
    slots = sms * tile[2]
    whole, cut = mlp_plan_costs(tiles, chunks, slots)
    fills = tiles >= WHOLE_TILE_FILL * -(-tiles // slots) * slots
    blocks = tiles if fills or whole <= cut else min(slots, tiles * chunks)
    return dict(blocks=blocks, tiles=tiles, chunks=chunks, split=int(tiles % blocks != 0))


def token_mlp_fwd(x, ln_gamma, ln_beta, w1, b1, w2, b2):
    """Forward alone: the kernel on CUDA tensors, the plain version on CPU."""
    if x.device.type == "cpu":
        return mlp_block_plain(x, ln_gamma, ln_beta, w1, b1, w2, b2)
    xf, g, bt, w1, b1, w2 = _checked(x, ln_gamma, ln_beta, w1, b1, w2)
    b2 = cuda_build.require(b2, torch.float32, "b2")
    m, c = xf.shape
    hidden = w1.shape[0]
    tile = mlp_tile(x.device, c)
    if hidden % tile[1]:
        raise ValueError(f"token_mlp needs a hidden width that is a multiple of its chunk "
                         f"{tile[1]}; got C={c} hidden={hidden}")
    plan = mlp_fwd_plan(m, hidden, tile, cuda_build.sm_count(x.device))
    part = None
    if plan["split"]:
        part = torch.empty((2 * plan["blocks"], tile[0], c // tile[3]), dtype=torch.float32,
                           device=x.device)
    out = torch.empty_like(xf)
    p = cuda_build.ptr
    cuda_build.launch(NAME, x.device, "dsg_token_mlp",
                      p(xf), p(g), p(bt), p(w1), p(b1), p(w2), p(b2), p(part), p(out), m, c,
                      hidden, plan["blocks"])
    cuda_build.count_launch(NAME, f"C{c}")
    return out.reshape(x.shape)


def mlp_bwd_tile(device, width: int, which: str, wide: bool = False) -> tuple[int, ...]:
    """A tile of ``token_mlp_bwd`` from the library (csrc/token_mlp_bwd.cu
    ``dsg_token_mlp_bwd_tile``): "fused" the fused row tile at C (rows,
    hidden chunk, blocks an SM, 1), "fc1" (64-row panels if ``wide``) and
    "stream" the chain's recompute and streamed products at C, "wgrad" the
    weight gradients' tile at ``width`` output columns (rows, columns,
    blocks an SM, 0).  Raises ValueError where no tile covers the width (for
    "fused": where the chain takes C)."""
    which_i = ("fused", "fc1", "stream", "wgrad").index(which)
    return cuda_build.tile_of(device, "dsg_token_mlp_bwd_tile", width, which_i, int(wide))


def mlp_bwd_fused_tile(device, c: int) -> tuple[int, ...] | None:
    """The fused row tile at C, or None where the chain takes C."""
    try:
        return mlp_bwd_tile(device, c, "fused")
    except ValueError:
        return None


def mlp_bwd_splits(m: int, c: int, hidden: int) -> dict[str, int]:
    """The reductions over the ``m`` tokens that the chain of ``token_mlp_bwd``
    (C where no fused tile covers) runs beside its GEMMs: the row splits of
    the two bias sums (256 columns per block) and the blocks of the closing
    row pass (8 rows per block and step)."""
    return dict(b1=cuda_build.split_count(-(-hidden // 256), m, 64),
                b2=cuda_build.split_count(-(-c // 256), m, 64),
                ln=min(cuda_build.TARGET_BLOCKS, -(-m // 8)))


def mlp_bwd_plan(m: int, c: int, hidden: int, device) -> dict[str, int]:
    """Grid plan of ``token_mlp_bwd`` over ``m`` tokens at width C: ``fused``
    (one row-tile launch of ``blocks`` blocks, each walking every hidden
    chunk) where the library has a fused tile for C, else the chain's
    fc1's panels (``wide``, as ``swin_block_v3.attn_bwd_gemm_plan``) and the
    column splits of its three GEMMs (``gemm_plan``: ``fc1``, ``dm``,
    ``dhn``) and ``mlp_bwd_splits``; and for both the token split of the two
    weight gradients (``w`` splits of ``kchunk`` tokens, one plan for both,
    from the larger of their tile counts)."""
    sms = cuda_build.sm_count(device)
    wt1, wt2 = mlp_bwd_tile(device, c, "wgrad"), mlp_bwd_tile(device, hidden, "wgrad")
    tiles = max(-(-hidden // wt1[0]) * -(-c // wt1[1]), -(-c // wt2[0]) * -(-hidden // wt2[1]))
    splits, chunk = cuda_build.token_split(tiles, m, min(wt1[2], wt2[2]), sms)
    plan = dict(fused=0, blocks=0, wide=0, fc1=1, dm=1, dhn=1, w=splits, kchunk=chunk, b1=1, b2=1,
                ln=1)
    fused = mlp_bwd_fused_tile(device, c)
    if fused is not None:
        plan.update(fused=1, blocks=-(-m // fused[0]))
    else:
        stream = mlp_bwd_tile(device, c, "stream")
        wide = cuda_build.wide_panels(m, hidden, lambda wd: mlp_bwd_tile(device, c, "fc1", wd), sms)
        fc1 = mlp_bwd_tile(device, c, "fc1", wide)
        plan.update(wide=int(wide), fc1=cuda_build.gemm_plan(m, hidden, fc1, sms)["tiles"],
                    dm=cuda_build.gemm_plan(m, hidden, stream, sms)["tiles"],
                    dhn=cuda_build.gemm_plan(m, c, stream, sms)["tiles"],
                    **mlp_bwd_splits(m, c, hidden))
    return plan


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
    if c > 768 or c % 32 or hidden % 64:
        raise ValueError(f"token_mlp_bwd covers C <= 768 (a multiple of 32) and a hidden width "
                         f"that is a multiple of 64; got C={c} hidden={hidden}")
    do = cuda_build.require(dout, torch.bfloat16, "dout").reshape(m, c)
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    plan = mlp_bwd_plan(m, c, hidden, dev)

    def buf(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    hn, mid, du = buf(m, c, dtype=bf), buf(m, hidden, dtype=bf), buf(m, hidden, dtype=bf)
    part_w = buf(plan["w"], 2 * c * hidden)
    gp = dhn = part_vec = part_b1 = part_b2 = part_ln = None
    if plan["fused"]:
        part_vec = buf(2 * plan["blocks"], hidden + 3 * c)
    else:
        gp, dhn = buf(m, hidden, dtype=torch.float16), buf(m, c)
        part_b1, part_b2 = buf(plan["b1"], hidden), buf(plan["b2"], c)
        part_ln = buf(plan["ln"], 2 * c)
    dx = buf(m, c, dtype=bf)
    dw = buf(2, c * hidden)
    vecs = buf(hidden + 3 * c)  # db1 | dgamma | dbeta | db2
    p = cuda_build.ptr
    cuda_build.launch(
        NAME_BWD, dev, "dsg_token_mlp_bwd",
        p(xf), p(do), p(g), p(bt), p(w1), p(b1), p(w2),
        p(hn), p(mid), p(gp), p(du), p(dhn), p(part_w), p(part_vec), p(part_b1), p(part_b2),
        p(part_ln), p(dx), p(dw), p(vecs),
        m, c, hidden, plan["fused"], plan["wide"], plan["fc1"], plan["dm"], plan["dhn"], plan["w"],
        plan["kchunk"], plan["b1"], plan["b2"], plan["ln"])
    cuda_build.count_launch(NAME_BWD, f"C{c}")
    db1, dgamma, dbeta, db2 = vecs.split([hidden, c, c, c])
    return (dx.reshape(x.shape), dgamma, dbeta, dw[0].view(hidden, c).to(bf), db1,
            dw[1].view(c, hidden).to(bf), db2)


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
