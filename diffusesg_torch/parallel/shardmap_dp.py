"""The ``shard_map`` data-parallel mode: each rank runs the local step.

Counterpart of diffusesg_tpu/parallel/shardmap_dp.py.  Each rank runs the
single-device step (kernels included) on its slice of the global batch,
draws from a stream of its own, and averages the gradients and the scalar
metrics over the ranks before the clip (train/train_step.py with a
``world``).  Parameters, Adam and the EMAs stay replicated: every rank
applies the same averaged gradient to the same state.

RNG: a rank draws from ``noise.fold_in(world.rank)``, the counterpart of
``fold_in(key, axis_index)``: the same distribution as one global draw, a
different stream than the single-device program.  So the self-conditioning
coin is drawn per rank, and the IoU loss divides by the valid nodes of the
local shard, as the reference's DDP ranks did.  A ``TorchNoise`` advances
as it draws, so the stream is folded once, where it is made (``go_training``
for the train and eval steps), and handed to every call.

On a card the steps are compiled (train/compiled.py): the train step as
two captured graphs per self-conditioning variant around the all-reduce
of the gradients, which runs on the caller's stream between them.

Sampling is batch-parallel and needs no collective: ``sg_go_sampling``
folds its stream once per rank and runs ``make_sample_fn`` on the rank's
shard, so the JAX package's ``make_shardmap_sample_fn`` has no separate
counterpart.
"""
from __future__ import annotations

from ..train.compiled import CompiledEvalStep, CompiledTrainStep
from ..train.train_step import TrainStepConfig, make_eval_step, make_train_step
from .mesh import World


def make_shardmap_train_step(model, cfg: TrainStepConfig, world: World, compiled: bool = True):
    """(state, noise, adjs, nodes, flags) -> (state, metrics) on this rank's
    rows, ``noise`` this rank's stream (``noise.fold_in(world.rank)``): the
    gradients and scalar metrics averaged over ``world``, the per-sample
    metrics local.  ``compiled=False`` runs it eagerly on a card too."""
    return CompiledTrainStep(make_train_step(model, cfg, world), compiled)


def make_shardmap_eval_step(model, cfg: TrainStepConfig, world: World, compiled: bool = True):
    """(params, noise, step, adjs, nodes, flags) -> metrics on this rank's
    rows, ``noise`` this rank's stream, the scalars averaged over ``world``."""
    return CompiledEvalStep(make_eval_step(model, cfg, world), compiled)
