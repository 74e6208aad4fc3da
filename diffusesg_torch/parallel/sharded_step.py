"""The ``gspmd`` data-parallel mode: the single-device step over the global
batch, with Adam and the K EMAs ZeRO-1 sharded.

Counterpart of diffusesg_tpu/parallel/sharded_step.py (the reference's DDP +
``ZeroRedundancyOptimizer``, utils/dist_training.py:62-85 and
utils/learning_utils.py:130-135).  The global batch is the ranks' rows in
rank order.  Every rank makes the global draws (sigmas, noise, one
self-conditioning coin) from the same stream and takes its own rows
(``GlobalRows``); the IoU loss divides by the global count of valid nodes
and the batch mean is the local sum over the global batch
(train/train_step.py ``make_loss_fn(global_world=...)``); the gradients are
then summed over the ranks, so every rank clips the single-device gradient
of the global batch.

ZeRO-1: ``torch.optim.Adam`` (``capturable`` on a card, as the
single-device step's, so the two agree bit for bit at world 1) inside
``ZeroRedundancyOptimizer``, which
assigns whole parameters to ranks (largest first, each to the rank holding
the fewest elements so far), steps the owned ones and broadcasts them.  Each
rank keeps the EMAs of the parameters it owns.  The JAX package shards
every leaf along its largest divisible axis instead; the layouts differ,
the numbers do not.  Checkpoints gather the state to rank 0 first
(utils/checkpoint.py), in the single-device format.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.optim import ZeroRedundancyOptimizer

from ..train.train_state import TrainState, load_opt_state, opt_state_dict, set_lr
from ..train.train_step import EvalStep, TrainStep, TrainStepConfig, make_loss_fn
from .mesh import World


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


def shard_train_state(state: TrainState, world: World) -> TrainState:
    """ZeRO-1 placement of a single-device state: Adam (and any state it
    holds, e.g. after a restore) becomes a ``ZeroRedundancyOptimizer`` over
    the same parameters, each rank keeping its partition, and each rank
    keeps the EMAs of the parameters it owns; the others' entries become
    None.  COLLECTIVE."""
    params = state.params()
    zero = ZeroRedundancyOptimizer(params, optimizer_class=torch.optim.Adam,
                                   process_group=world.group,
                                   **state.spec.adam_kwargs(params[0].device))
    set_lr(zero, float(state.opt.param_groups[0]["lr"]))
    if state.opt.state:
        load_opt_state(zero, opt_state_dict(state.opt))
        if zero.optim.defaults.get("capturable"):  # ZeRO loads step counts onto the CPU
            for p, st in zero.optim.state.items():
                st["step"] = st["step"].to(p.device)
    held = {id(p) for g in zero.optim.param_groups for p in g["params"]}
    mine = [i for i, p in enumerate(state.params()) if id(p) in held]
    per_rank = [None] * world.size
    dist.all_gather_object(per_rank, mine, group=world.group)
    owners = [0] * len(state.params())
    for rank, idxs in enumerate(per_rank):
        for i in idxs:
            owners[i] = rank
    emas = [[e if owners[i] == world.rank else None for i, e in enumerate(ema)]
            for ema in state.ema_params]
    return TrainState(step=state.step, model=state.model, spec=state.spec, opt=zero,
                      ema_params=emas, ema_betas=list(state.ema_betas), owners=owners,
                      tp=state.tp)


@torch.no_grad()
def gather_emas(state: TrainState, idxs, to: int | None = None) -> list[list[torch.Tensor]]:
    """EMA copies ``idxs`` whole, each a list aligned with the parameters,
    from the ranks that own their parts: one broadcast of a flat buffer per
    rank.  With ``to`` only that rank keeps the result (the others get
    empty lists).  Ranks are those of the ZeRO-1 group.  COLLECTIVE."""
    group = state.opt.process_group
    world_size, rank = dist.get_world_size(group), dist.get_rank(group)
    params = state.params()
    out = [[None] * len(params) for _ in idxs]
    for src in range(world_size):
        owned = [i for i, o in enumerate(state.owners) if o == src]
        if not owned:
            continue
        if rank == src:
            flat = torch.cat([state.ema_params[k][i].reshape(-1) for k in idxs for i in owned])
        else:
            n = len(idxs) * sum(params[i].numel() for i in owned)
            flat = torch.empty(n, dtype=params[owned[0]].dtype, device=params[owned[0]].device)
        dist.broadcast(flat, src=dist.get_global_rank(group, src), group=group)
        if to is not None and rank != to:
            continue
        parts = iter(flat.split([params[i].numel() for _ in idxs for i in owned]))
        for j in range(len(idxs)):
            for i in owned:
                out[j][i] = next(parts).view_as(params[i]).clone()
    return out if to is None or rank == to else [[] for _ in idxs]


def make_sharded_train_step(model, cfg: TrainStepConfig, world: World, tp: bool = False):
    """(state, noise, adjs, nodes, flags) -> (state, metrics) on this rank's
    rows of the global batch, ``state`` from ``shard_train_state``: the
    loss of the global batch, the gradients summed over ``world``, clip,
    the ZeRO-1 Adam step, the owned EMAs.  The scalar metrics are those of
    the global batch; the per-sample vectors stay local.

    ``tp`` (sharded_step.py:21-83, ``tp=True``): ``world`` is a grid's data
    group (``mesh.make_grid``) and ``state`` from ``tp.shard_tp_state``;
    the model runs split over the model group, the gradients are summed
    over the data group and then, for the leaves each model rank computes
    in part, over the model group, and the clip takes the global norm
    (``tp.finish_grads``).  A data group of one is the single-device step's
    loss and metrics."""
    if tp:
        from .tp import finish_grads
        data = world if world.size > 1 else None
        step = TrainStep(make_loss_fn(model, cfg, global_world=data), data,
                         reduce="sum" if data is not None else "mean", finish_grads=finish_grads)
        return lambda state, noise, *batch: step(state, GlobalRows(noise, world), *batch)
    step = TrainStep(make_loss_fn(model, cfg, global_world=world), world, reduce="sum")

    def sharded_step(state, noise, adjs, nodes, flags):
        return step(state, GlobalRows(noise, world), adjs, nodes, flags)

    return sharded_step


def make_sharded_eval_step(model, cfg: TrainStepConfig, world: World):
    """(params, noise, step, adjs, nodes, flags) -> metrics of the global
    batch (the test pass data-parallel over ``world``)."""
    step = EvalStep(make_loss_fn(model, cfg, global_world=world), world, reduce="sum")

    def sharded_step(params, noise, count, adjs, nodes, flags):
        return step(params, GlobalRows(noise, world), count, adjs, nodes, flags)

    return sharded_step
