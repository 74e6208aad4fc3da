"""The world of processes and the collectives its callers use.

Counterpart of diffusesg_tpu/parallel/mesh.py, one card per process:
  * the 1-D data mesh          -> ``World``: rank, size, device, group
  * ``make_mesh_2d`` (tp.py)   -> ``make_grid``: the (data, model) process grid,
                                  a ``World`` of the data group with its model
                                  group (parallel/tp.py)
  * ``resolve_spmd_mode``      -> the same choice of ``shard_map`` or ``gspmd``
  * ``per_host_batch_size``    -> the same formula, the world size for the
                                  process count
  * ``gather_to_host``         -> an ``all_gather`` joined in rank order
  * ``sync_hosts``, ``is_main_process``

The JAX package's GSPMD layout helpers have no counterpart under one
process per card: ``make_mesh`` is the process group itself, ``replicated``
/ ``replicate_tree`` are each rank's own copy of the model,
``batch_sharding`` / ``shard_batch`` are each rank's rows of the batch
(``data/loader.Batches`` with ``process_index``; ``GlobalRows`` for the
draws), and ``zero1_sharding`` / ``largest_divisible_axis`` (the largest
divisible axis of every leaf) are ``parallel/zero.py``'s flat buffers, of
which each rank owns one contiguous range.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .distributed import barrier


@dataclasses.dataclass(frozen=True)
class World:
    """The data-parallel world of this process: ``size`` processes, one card
    (or the CPU) each, ``rank`` this one's place in it, ``device`` where its
    collectives run, ``group`` their process group (None: the default one).
    On a (data, model) grid (``make_grid``) it is the data group, and
    ``model`` the process's model group (parallel/tp.py ``ModelGroup``); a
    plain data-parallel world is the grid (world, 1), with no model group."""
    rank: int
    size: int
    device: torch.device
    group: Any = None
    model: Any = None


class GlobalRows:
    """This rank's rows of the global batch's draws: each normal or uniform
    draw of leading size b is made at size ``world.size * b`` from the
    shared stream and sliced to rows [rank * b, (rank + 1) * b); Bernoulli
    draws (the self-conditioning coin) are the shared ones."""

    def __init__(self, noise, world: World):
        self.noise, self.world = noise, world

    def _rows(self, draw, shape):
        b = shape[0]
        full = draw((self.world.size * b,) + tuple(shape[1:]))
        return full[self.world.rank * b:(self.world.rank + 1) * b]

    def normal(self, step, kind, shape):
        return self._rows(lambda s: self.noise.normal(step, kind, s), shape)

    def uniform(self, step, kind, shape):
        return self._rows(lambda s: self.noise.uniform(step, kind, s), shape)

    def bernoulli(self, step, kind, p):
        return self.noise.bernoulli(step, kind, p)


def current_world() -> World | None:
    """The world of the default process group, or None when none is up; its
    device is this process's card under NCCL, the CPU under gloo."""
    if not dist.is_initialized():
        return None
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    return World(rank=dist.get_rank(), size=dist.get_world_size(), device=device)


def make_grid(dp: int, tp: int) -> World:
    """This process's place in a (data ``dp``, model ``tp``) grid over the
    process group (the counterpart of ``make_mesh_2d``, tp.py:52-60): the
    model axis innermost, so consecutive ranks share a model group and the
    data groups are strided by ``tp``.  COLLECTIVE: every rank creates every
    group, in the same order (``dist.new_group``)."""
    from .tp import ModelGroup
    world = current_world()
    size = 1 if world is None else world.size
    if world is None or dp * tp != size:
        raise ValueError(f"a {dp}x{tp} grid needs {dp * tp} processes in a process group, "
                         f"have {size if world is not None else 'none'}")
    data_groups = [dist.new_group([d * tp + m for d in range(dp)]) for m in range(tp)]
    model_groups = [dist.new_group([d * tp + m for m in range(tp)]) for d in range(dp)]
    d, m = divmod(world.rank, tp)
    return World(rank=d, size=dp, device=world.device, group=data_groups[m],
                 model=ModelGroup(rank=m, size=tp, group=model_groups[d]))


def resolve_spmd_mode(config, world_size: int) -> str:
    """``tpu.spmd_mode``: ``shard_map`` (each rank runs the local step on its
    slice of the batch, gradients averaged) or ``gspmd`` (the single-device
    step over the global batch, Adam and the EMAs ZeRO-1 sharded).  ``auto``
    picks ``shard_map`` when the run has more than one process and the
    kernels are on, as the JAX package does (mesh.py:38-64).  Both modes run
    the kernels here, since every rank runs its own local batch, so an
    explicit ``gspmd`` with the kernels on draws no warning."""
    tpu = config.tpu if "tpu" in config else None
    mode = tpu.get("spmd_mode", "auto") if tpu is not None else "auto"
    kernels = bool(tpu.get("use_pallas_attention", False)) if tpu is not None else False
    if mode == "auto":
        mode = "shard_map" if (world_size > 1 and kernels) else "gspmd"
    if mode not in ("shard_map", "gspmd"):
        raise ValueError(f"unknown tpu.spmd_mode {mode!r}")
    return mode


def per_host_batch_size(global_batch: int, world_size: int) -> int:
    """Rows each process feeds per step for a configured GLOBAL batch: the
    reference's DDP split (each rank loads batch_size // world_size rows,
    dataloader.py:24-33), the JAX formula (mesh.py:67-77) with one card per
    process (so at least one row)."""
    return max(1, global_batch // max(1, world_size))


def _wire(x: torch.Tensor, world: World) -> torch.Tensor:
    """``x`` as the backend can carry it: on the process's card for NCCL,
    bool as uint8 (gloo has no bool reduction)."""
    x = x.to(world.device)
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def gather_to_host(x, world: World | None = None) -> np.ndarray:
    """Every rank's ``x`` joined along the first axis in rank order, on the
    host (the reference's ``gather_tensors``, dist_training.py:170-195).
    COLLECTIVE: every rank calls it, with arrays of one shape (the loaders'
    wrap-padding makes them so).  Without a process group, ``x`` itself."""
    world = world or current_world()
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x.detach()
    if world is None:
        return t.cpu().numpy()
    src = _wire(t.contiguous(), world)
    parts = [torch.empty_like(src) for _ in range(world.size)]
    dist.all_gather(parts, src, group=world.group)
    out = torch.cat([p if t.ndim else p.reshape(1) for p in parts]).cpu()
    return out.to(torch.bool).numpy() if t.dtype == torch.bool else out.numpy()


def fetch_to_host(metrics: list[dict], world: World | None = None) -> list[dict]:
    """Device metrics of many steps -> numpy, in one pass.  A step's scalars
    are already reduced over the ranks and are taken as they are; its
    per-sample vectors are rank-local and come back as the global batch,
    gathered in rank order (the metric layout of train_step.py, the JAX
    package's ``_metrics_specs``).  COLLECTIVE with a process group."""
    world = world or current_world()
    host = [{k: v.detach().float().cpu().numpy() for k, v in m.items()} for m in metrics]
    if world is None or not metrics:
        return host
    for key in [k for k, v in metrics[0].items() if v.ndim > 0]:
        stacked = torch.stack([m[key].detach().float() for m in metrics])  # [S, b]
        full = gather_to_host(stacked, world)                               # [W * S, b]
        full = full.reshape(world.size, len(metrics), -1)
        for s, h in enumerate(host):
            h[key] = full[:, s].reshape(-1)
    return host


def all_reduce_sum(x: torch.Tensor, world: World, mean: bool = False) -> torch.Tensor:
    """The sum (or mean) of ``x`` over the ranks, as a new tensor; ``x`` is
    read, not written, and no gradient passes."""
    out = x.detach().clone()
    dist.all_reduce(out, group=world.group)
    return out.div_(world.size) if mean else out


def all_gather_flat(out: torch.Tensor, part: torch.Tensor, world: World) -> None:
    """Every rank's ``part`` joined in rank order into ``out`` (``world.size``
    times its size); in place where ``part`` is this rank's slice of
    ``out``.  COLLECTIVE."""
    dist.all_gather_into_tensor(out, part, group=world.group)


# gradients travel in flat buckets of about this many bytes (DDP's default)
BUCKET_BYTES = 25 * 2 ** 20


@torch.no_grad()
def all_reduce_grads(params, world: World, mean: bool = True) -> None:
    """Sum (``mean``: average) every parameter's gradient over the ranks, in
    place, through flat buckets: the plain all-reduce that ``lax.pmean`` of
    the gradients is.  A parameter without a gradient takes part with zeros
    and leaves with the reduced one, so every rank reduces the same buckets
    whichever parts of the model its step ran (the ``shard_map`` mode's
    per-rank self-conditioning coin)."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    bucket, size = [], 0
    for i, p in enumerate(params):
        bucket.append(p.grad)
        size += p.grad.numel() * p.grad.element_size()
        last = i + 1 == len(params)
        if size >= BUCKET_BYTES or last or params[i + 1].grad.dtype != p.grad.dtype:
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat, group=world.group)
            if mean:
                flat.div_(world.size)
            torch._foreach_copy_(bucket, [v.view_as(g) for v, g in zip(
                flat.split([g.numel() for g in bucket]), bucket)])
            bucket, size = [], 0


def any_rank(flag: bool, world: World | None = None) -> bool:
    """True when ``flag`` is True on any rank.  COLLECTIVE."""
    world = world or current_world()
    if world is None:
        return bool(flag)
    t = _wire(torch.tensor([int(bool(flag))], dtype=torch.int32), world)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=world.group)
    return bool(t.item())


def sync_hosts() -> None:
    """Barrier across the processes (reference: dist_training.py:87-91
    ``ddp_sync``)."""
    barrier()


def is_main_process() -> bool:
    """Rank-0 gate of every write (reference: dist_training.py:151-159)."""
    return not dist.is_initialized() or dist.get_rank() == 0
