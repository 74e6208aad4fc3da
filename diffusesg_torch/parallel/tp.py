"""Tensor parallelism (Megatron column / row) over a model group.

Counterpart of diffusesg_tpu/parallel/tp.py.  The processes form a (data,
model) grid (``mesh.make_grid``): the batch splits over the data group, and
within a model group each Swin block's attention and MLP split Megatron's
way.  Column-parallel, split on the output rows of the torch weight:
``attn.qkv.weight`` / ``.bias`` and ``mlp.fc1.weight`` / ``.bias`` of the
blocks; row-parallel, split on its input columns: ``attn.proj.weight`` and
``mlp.fc2.weight``.  Everything else is replicated, as in the JAX package:
the norms, the biases after the row-parallel products, the relative-bias
tables, the readout heads (whose ``fc1`` / ``fc2`` the rules do not match),
merge, breakup and the noise MLP.

One process per card needs every rank to hold whole heads, so the split is
by heads, not contiguous: rank r holds the q, k and v rows of its heads
(JAX annotates the fused [C, 3C] axis and lets XLA move the data).  An
attention whose heads the model group does not divide, or an MLP whose
hidden columns it does not, stays replicated, with a warning that names the
leaves (tp.py:77-110); the numbers are the same either way.

The forward of a split half runs its plain composition over the local
heads or hidden columns between Megatron's two functions: ``enter`` (f:
identity forward, all-reduce of the gradient backward) on the LayerNorm's
output and ``leave`` (g: all-reduce forward, identity backward) on the
partial products, whose bias rank 0 alone adds.  A replicated leaf that a
rank uses only in part (the bias table's columns of its heads, the bias
only rank 0 adds) has its gradient summed over the model group
(``finish_grads``), and the gradient clip takes the global norm with every
split leaf's shards summed and every replicated leaf counted once.  Nothing
on this path reads a device value on the host or copies a host value to
the device after the first step (the clip's indices of the split leaves
are made once per layout), so a compiled step captures it, its collectives
inside (train/compiled.py).

No kernel runs here, as in JAX: its tensor parallelism runs the XLA path
and configs with tp > 1 set ``use_pallas_attention: false`` (tp.py:29-36);
``shard_model`` raises on a model whose kernels are on.
"""
from __future__ import annotations

import dataclasses
import logging
import re
from typing import Any

import torch
import torch.distributed as dist

# the rule table in the port's names: which torch axis is split
_COL_PARALLEL = re.compile(r"\.blocks\.\d+\.(attn\.qkv|mlp\.fc1)\.(weight|bias)$")
_ROW_PARALLEL = re.compile(r"\.blocks\.\d+\.(attn\.proj|mlp\.fc2)\.weight$")

# how a parameter lies over the model group: its q, k and v rows by heads,
# its rows or columns in contiguous blocks, replicated with a gradient each
# rank computes in part, or replicated (None)
QKV, ROWS, COLS, PARTIAL = "qkv", "rows", "cols", "partial"


def tp_axis(name: str, ndim: int) -> int | None:
    """The axis of the torch parameter ``name`` split over the model group:
    0 (output rows) for a column-parallel product, 1 (input columns) for a
    row-parallel one, None for a replicated leaf (the JAX package's
    ``_tp_axis`` in the port's names and layouts)."""
    if _COL_PARALLEL.search(name):
        return 0
    if _ROW_PARALLEL.search(name) and ndim == 2:
        return 1
    return None


class _Enter(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        out = dy.float()  # summed in fp32 whatever the activations' type
        dist.all_reduce(out, group=ctx.group)
        return out.to(dy.dtype), None


class _Leave(torch.autograd.Function):
    """Megatron's g: the partial results summed over the group, identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, dy):
        return dy, None


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """This process's model group: ``size`` ranks that split one model,
    ``rank`` this one's place in it, ``group`` their process group."""
    rank: int
    size: int
    group: Any

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.group)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        return _Leave.apply(x, self.group)


@dataclasses.dataclass(frozen=True)
class BlockSplit:
    """How one Swin block lies over the model group: ``attn`` / ``mlp`` the
    group for a half that is split (None: replicated), ``heads`` the heads
    this rank runs from ``head0``."""
    attn: ModelGroup | None
    mlp: ModelGroup | None
    heads: int
    head0: int

    def heads_of(self, rel_bias: torch.Tensor) -> torch.Tensor:
        return rel_bias[self.head0:self.head0 + self.heads]

    def attn_bias(self, bias):
        return bias if self.attn is None or self.attn.rank == 0 else None

    def mlp_bias(self, bias):
        return bias if self.mlp is None or self.mlp.rank == 0 else None


@dataclasses.dataclass
class TPLayout:
    """A tensor-parallel state's split: ``kinds[i]`` how parameter i lies
    (``QKV``, ``ROWS``, ``COLS``, ``PARTIAL`` or None), ``world`` the grid;
    ``split`` the device indices of the split parameters and of the others,
    made at the first ``finish_grads`` (indices of a known count, where a
    boolean mask would read its count on the host)."""
    world: Any
    kinds: list
    split: tuple | None = None


def _qkv_rows(c: int, part: int, rank: int) -> torch.Tensor:
    """The rows of a fused [3C, ...] qkv parameter that hold the q, k and v
    of the heads of ``rank`` (C / ``part`` channels each)."""
    local = c // part
    return torch.cat([torch.arange(j * c + rank * local, j * c + (rank + 1) * local)
                      for j in range(3)])


def _local(t: torch.Tensor, kind, mg: ModelGroup) -> torch.Tensor:
    """This rank's shard of a whole parameter (or moment, or EMA) ``t``."""
    if kind == QKV:
        return t[_qkv_rows(t.shape[0] // 3, mg.size, mg.rank).to(t.device)].clone()
    if kind == ROWS:
        return t.chunk(mg.size, 0)[mg.rank].clone()
    if kind == COLS:
        return t.chunk(mg.size, 1)[mg.rank].clone()
    return t


def _whole(t: torch.Tensor, kind, mg: ModelGroup, device: torch.device) -> torch.Tensor:
    """The whole parameter from every rank's shard ``t``: a COLLECTIVE of
    the model group (on ``device``, where its collectives run) for a split
    ``kind``, ``t`` itself otherwise."""
    if kind not in (QKV, ROWS, COLS):
        return t
    t = t.to(device).contiguous()
    parts = [torch.empty_like(t) for _ in range(mg.size)]
    dist.all_gather(parts, t, group=mg.group)
    if kind == ROWS:
        return torch.cat(parts, 0)
    if kind == COLS:
        return torch.cat(parts, 1)
    thirds = [p.chunk(3, 0) for p in parts]
    return torch.cat([thirds[r][j] for j in range(3) for r in range(mg.size)], 0)


@torch.no_grad()
def shard_model(model, mg: ModelGroup) -> list:
    """Split ``model``'s Swin blocks over the model group ``mg`` in place, by
    the rule table (``tp_axis``): each split parameter is replaced by this
    rank's shard and each block told its split (``SwinBlock.tp``).  Returns
    the kind of every parameter, aligned with ``model.parameters()``.
    Raises on a model whose kernels are on (tp.py:29-36); logs the leaves
    that stay replicated."""
    from ..models.layers import SwinBlock
    if model.use_kernels:
        raise ValueError("tensor parallelism runs the plain composition, as the JAX package "
                         "runs its XLA path: set tpu.use_pallas_attention: false "
                         "(diffusesg_tpu/parallel/tp.py:29-36)")
    kinds, fallbacks = {}, []
    for prefix, blk in model.named_modules():
        if not isinstance(blk, SwinBlock):
            continue
        split = {"attn": blk.num_heads % mg.size == 0,
                 "mlp": blk.mlp.fc1.out_features % mg.size == 0}
        for half, ok in split.items():
            for lname, lin in getattr(blk, half).named_children():
                for pname, p in list(lin.named_parameters(recurse=False)):
                    name = f"{prefix}.{half}.{lname}.{pname}"
                    axis = tp_axis(name, p.ndim)
                    if axis is None:
                        if ok and lname in ("proj", "fc2"):  # the bias rank 0 adds
                            kinds[id(p)] = PARTIAL
                    elif not ok:
                        fallbacks.append(f"{name} shape={tuple(p.shape)} axis={axis}")
                    else:
                        kind = COLS if axis == 1 else QKV if lname == "qkv" else ROWS
                        shard = torch.nn.Parameter(_local(p, kind, mg))
                        setattr(lin, pname, shard)
                        kinds[id(shard)] = kind
        if split["attn"]:
            kinds[id(blk.attn.relative_position_bias_table)] = PARTIAL
        heads = blk.num_heads // mg.size if split["attn"] else blk.num_heads
        blk.tp = BlockSplit(attn=mg if split["attn"] else None,
                            mlp=mg if split["mlp"] else None, heads=heads,
                            head0=mg.rank * heads if split["attn"] else 0)
    if fallbacks:
        logging.warning("tensor parallelism: %d leaves stay REPLICATED (their heads or hidden "
                        "columns do not divide over model=%d): %s", len(fallbacks), mg.size,
                        "; ".join(fallbacks))
    return [kinds.get(id(p)) for p in model.parameters()]


def shard_tp_state(state, world):
    """A single-device ``TrainState`` split over the grid ``world``
    (``mesh.make_grid``): the model's blocks by ``shard_model``, the Adam
    moments and the EMAs as their parameters (tp.py:113-145), then, over a
    data group of more than one rank, Adam and the EMAs ZeRO-1 sharded over
    the data group (``sharded_step.shard_train_state``).  COLLECTIVE."""
    from ..train.train_state import TrainState, load_opt_state, opt_state_dict
    from .sharded_step import shard_train_state
    mg = world.model
    saved = opt_state_dict(state.opt)
    kinds = shard_model(state.model, mg)
    params = state.params()
    emas = [[_local(e, k, mg) for e, k in zip(ema, kinds)] for ema in state.ema_params]
    opt = state.spec.build(params)
    moments = {i: {k: (_local(v, kinds[i], mg) if k != "step" else v) for k, v in st.items()}
               for i, st in saved["state"].items()}
    load_opt_state(opt, {"state": moments, "param_groups": saved["param_groups"]})
    out = TrainState(step=state.step, model=state.model, spec=state.spec, opt=opt,
                     ema_params=emas, ema_betas=list(state.ema_betas),
                     tp=TPLayout(world=world, kinds=kinds))
    if world.size > 1:
        out = shard_train_state(out, world)
    return out


@torch.no_grad()
def finish_grads(state) -> None:
    """After the data group's all-reduce: sum over the model group the
    gradients of the replicated leaves each rank computes in part, then clip
    by the global norm (every split leaf's shards summed, every replicated
    leaf once).  A model group of one clips as the single-device step does.
    Every parameter takes part (zeros where the backward left no
    gradient)."""
    layout, params = state.tp, state.params()
    mg = layout.world.model
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    partial = [p for p, k in zip(params, layout.kinds) if k == PARTIAL]
    if partial:
        flat = torch.cat([p.grad.reshape(-1) for p in partial])
        dist.all_reduce(flat, group=mg.group)
        torch._foreach_copy_([p.grad for p in partial], [v.view_as(p) for v, p in zip(
            flat.split([p.numel() for p in partial]), partial)])
    max_norm = state.spec.max_grad_norm
    if mg.size == 1:
        torch.nn.utils.clip_grad_norm_(params, max_norm)
        return
    grads = [p.grad for p in params]
    if layout.split is None:
        split = [k in (QKV, ROWS, COLS) for k in layout.kinds]
        layout.split = tuple(torch.tensor([i for i, s in enumerate(split) if s == want],
                                          dtype=torch.long, device=grads[0].device)
                             for want in (True, False))
    sq = torch.stack(torch._foreach_norm(grads)).float() ** 2
    shard_sq = sq[layout.split[0]].sum()
    dist.all_reduce(shard_sq, group=mg.group)
    total = (shard_sq + sq[layout.split[1]].sum()).sqrt()
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    torch._foreach_mul_(grads, coef)


@torch.no_grad()
def gather_tp_state(state, extra: dict | None = None) -> dict | None:
    """A tensor-parallel state in the single-device checkpoint format
    (``utils/checkpoint.py``'s payload, its tensors on the state's device,
    some shared with the state) on global rank 0, None on the
    others: Adam and the EMAs gathered over the data group first (under
    ZeRO-1), then every split leaf over the model group of data rank 0.
    COLLECTIVE."""
    from ..train.train_state import whole_emas_and_opt
    layout = state.tp
    world, mg, kinds = layout.world, layout.world.model, layout.kinds
    emas, opt = whole_emas_and_opt(state)
    if world.rank != 0:
        return None
    dev = world.device
    params = [_whole(p.detach(), k, mg, dev) for p, k in zip(state.params(), kinds)]
    emas = [[_whole(e, k, mg, dev) for e, k in zip(ema, kinds)] for ema in emas]
    moments = {i: {k: (_whole(v, kinds[i], mg, dev) if k != "step" else v)
                   for k, v in s.items()}
               for i, s in sorted(opt["state"].items())}
    if mg.rank != 0:
        return None
    names = state.param_names()
    sd = {k: v.detach() for k, v in state.model.state_dict().items()}
    sd.update(zip(names, params))
    return {
        "step": int(state.step),
        "params": sd,
        "ema_params": emas,
        "ema_betas": list(state.ema_betas),
        "opt_state": {"state": moments, "param_groups": opt["param_groups"]},
        "extra": dict(extra or {}),
    }
