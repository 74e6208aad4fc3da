"""The ``gspmd`` data-parallel mode: the single-device step over the global
batch, with Adam and the K EMAs ZeRO-1 sharded.

Counterpart of diffusesg_tpu/parallel/sharded_step.py (the reference's DDP +
``ZeroRedundancyOptimizer``, utils/dist_training.py:62-85 and
utils/learning_utils.py:130-135).  The global batch is the ranks' rows in
rank order.  Every rank makes the global draws (sigmas, noise, one
self-conditioning coin) from the same stream and takes its own rows
(``GlobalRows``); the IoU loss divides by the global count of valid nodes,
all-reduced before the step (train/train_step.py ``global_valid_count``),
and the batch mean is the local sum over the global batch
(``make_loss_fn(global_world=...)``); the gradients are then summed over
the ranks, so every rank clips the single-device gradient of the global
batch.

ZeRO-1 (parallel/zero.py ``FlatZero``): the parameters are views of one
flat buffer a dtype and each rank owns a contiguous range of it, where it
runs Adam (``capturable`` on a card, as the single-device step's) and the
EMAs; one all-gather a dtype then brings every rank the new parameters.
At world 1 the step is the single-device step bit for bit.  Checkpoints
gather the state to the single-device format first (utils/checkpoint.py).

On a card the steps are compiled (train/compiled.py): the valid-node count
and the draws before the graphs, (a) the forward and backward per
self-conditioning coin, the all-reduce of the gradients, (b) clip, Adam and
the EMAs, then the all-gather; the collectives on the caller's stream.
"""
from __future__ import annotations

from ..train.compiled import CompiledEvalStep, CompiledTrainStep
from ..train.train_state import TrainState, opt_state_dict
from ..train.train_step import EvalStep, TrainStep, TrainStepConfig, make_loss_fn
from .mesh import World
from .zero import FlatZero


def shard_train_state(state: TrainState, world: World) -> TrainState:
    """ZeRO-1 placement of a single-device state over ``world``: the model's
    parameters become views of flat buffers (``FlatZero``), Adam (and any
    state it holds, e.g. after a restore) becomes a capturable Adam over
    this rank's ranges, and the EMAs those ranges' copies.  The state's
    model is changed in place.  No collective: every rank holds the same
    single-device state."""
    saved = opt_state_dict(state.opt)
    zero = FlatZero(state.params(), world)
    opt = state.spec.build(zero.shards())
    zero.load_opt_state(opt, saved)
    return TrainState(step=state.step, model=state.model, spec=state.spec, opt=opt,
                      ema_params=[zero.owned(ema) for ema in state.ema_params],
                      ema_betas=list(state.ema_betas), zero=zero, tp=state.tp)


def make_sharded_train_step(model, cfg: TrainStepConfig, world: World, tp: bool = False,
                            compiled: bool = True) -> CompiledTrainStep:
    """(state, noise, adjs, nodes, flags) -> (state, metrics) on this rank's
    rows of the global batch, ``state`` from ``shard_train_state``: the
    loss of the global batch, the gradients summed over ``world``, clip,
    the ZeRO-1 Adam step, the owned EMAs, the all-gather.  The scalar
    metrics are those of the global batch; the per-sample vectors stay
    local.  On a card the step replays captured CUDA graphs;
    ``compiled=False`` runs it eagerly.

    ``tp`` (sharded_step.py:21-83, ``tp=True``): ``world`` is a grid's data
    group (``mesh.make_grid``) and ``state`` from ``tp.shard_tp_state``;
    the model runs split over the model group, the gradients are summed
    over the data group and then, for the leaves each model rank computes
    in part, over the model group, and the clip takes the global norm
    (``tp.finish_grads``).  A data group of one is the single-device step's
    loss and metrics; its compiled step is one graph per coin, the model
    group's collectives inside."""
    finish_grads = None
    if tp:
        from .tp import finish_grads
        world = world if world.size > 1 else None
    step = TrainStep(make_loss_fn(model, cfg, global_world=world), world, global_batch=True,
                     finish_grads=finish_grads, cfg=cfg)
    return CompiledTrainStep(step, compiled)


def make_sharded_eval_step(model, cfg: TrainStepConfig, world: World,
                           compiled: bool = True) -> CompiledEvalStep:
    """(params, noise, step, adjs, nodes, flags) -> metrics of the global
    batch (the test pass data-parallel over ``world``); compiled on a card
    unless ``compiled=False``."""
    step = EvalStep(make_loss_fn(model, cfg, global_world=world), world, global_batch=True,
                    cfg=cfg)
    return CompiledEvalStep(step, compiled)
