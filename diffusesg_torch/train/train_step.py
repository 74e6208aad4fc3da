"""The training and evaluation step.

Counterpart of diffusesg_tpu/train/train_step.py: sigma draw, noising,
preconditioned forward with stochastic self-conditioning, rainbow + IoU
losses, backward, clip, Adam and the K EMA updates.  On one device, or on
each rank of a data-parallel world (``world``, the counterpart of the JAX
step's ``axis_name``): the gradients and the scalar metrics are averaged
over the ranks between the backward and the clip, as ``lax.pmean`` averages
them there; parallel/shardmap_dp.py and parallel/sharded_step.py build the
two data-parallel steps on it.  Metrics stay on the device: nothing in a
step reads a value back to the host.

A step is a sequence of named stages (``TrainStep.stages``), which the
eager step runs in order and train/compiled.py runs as graphs, with the
data group's collectives between them.  What a step needs from the other
ranks before its forward (the ``gspmd`` loss's global count of valid
nodes, ``global_valid_count``) is made before the stages, as the draws are.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.func import functional_call

from ..diffusion.edm import NodeAdjEDMObjective
from ..models.channels import get_node_adj_num_type
from ..models.precond import precond_forward_train
from ..ops.attribute_code import attribute_int_to_one_hot
from ..parallel.mesh import GlobalRows, all_reduce_grads, all_reduce_sum
from .loss import NodeAdjRainbowLoss, bbox_iou_aux_loss
from .train_state import TrainState, apply_emas, set_ema_weights, set_lr


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    precond: str = "edm"
    sigma_dist: str = "edm"
    self_condition: bool = True
    symmetric_noise: bool = False
    edge_loss_weight: float = 1.0
    node_loss_weight: float = 1.0
    iou_loss_type: str = "iou"
    iou_loss_weight: float = 1.0
    flag_node_only: bool = False
    # one_hot datasets store ints and are encoded per mini-batch
    node_encoding: str = "ddpm"
    edge_encoding: str = "ddpm"
    num_node_type: int = 0  # one-hot class counts (bbox excluded)
    num_edge_type: int = 0


def encode_one_hot_batch(adjs_gt, nodes_gt, node_flags, cfg: TrainStepConfig):
    """Per-batch deferred one-hot encoding: one_hot datasets carry int labels
    ([B,N,N] adjs; nodes as [B,N,1+4], the int type in channel 0, then bbox)."""
    if cfg.node_encoding == "one_hot" and not cfg.flag_node_only:
        oh = attribute_int_to_one_hot(nodes_gt[..., 0], node_flags, cfg.num_node_type,
                                      flag_ddpm_range=True, flag_nodes=True)
        nodes_gt = torch.cat([oh, nodes_gt[..., 1:]], dim=-1)
    if cfg.edge_encoding == "one_hot":
        adjs_gt = attribute_int_to_one_hot(adjs_gt, node_flags, cfg.num_edge_type,
                                           flag_ddpm_range=True, flag_adjs=True)
    return adjs_gt, nodes_gt


def make_loss_fn(model, cfg: TrainStepConfig, global_world=None):
    """loss(params, noise, step, adjs, nodes, flags, total_valid=None) ->
    (scalar, aux dict).  ``params`` is None for the model's own parameters
    or a name -> tensor dict (an EMA copy) applied with
    ``torch.func.functional_call``; ``noise`` is the source of the step's
    random draws.

    ``global_world`` (a ``parallel.mesh.World``) makes this rank's part of
    the loss of the global batch (the ``gspmd`` mode): the IoU loss divides
    by ``total_valid``, the global count of valid nodes
    (``global_valid_count``, made by the caller before the step: no
    collective runs inside the loss), and the batch mean is the local sum
    over the global batch, every rank feeding as many rows."""
    objective = NodeAdjEDMObjective(precond=cfg.precond, sigma_dist=cfg.sigma_dist,
                                    symmetric_noise=cfg.symmetric_noise)
    rainbow = NodeAdjRainbowLoss(cfg.edge_loss_weight, cfg.node_loss_weight)

    def loss_fn(params, noise, step: int, adjs_gt, nodes_gt, node_flags, total_valid=None):
        adjs_gt, nodes_gt = encode_one_hot_batch(adjs_gt, nodes_gt, node_flags, cfg)
        ob = objective.get_input_output(noise, step, adjs_gt, nodes_gt, node_flags)

        def denoiser_fn(*args):
            return model(*args) if params is None else functional_call(model, params, args)

        D_a, D_x = precond_forward_train(denoiser_fn, cfg.precond, cfg.self_condition, noise,
                                         step, ob.net_input_a, ob.net_input_x, node_flags,
                                         ob.sigmas)
        loss_adj, loss_node = rainbow(D_a, D_x, ob.net_target_a, ob.net_target_x, node_flags,
                                      loss_weight=ob.weights)
        if uses_valid_count(cfg):
            if global_world is not None and total_valid is None:
                raise ValueError("the global batch's loss divides by the global count of valid "
                                 "nodes: pass total_valid (global_valid_count)")
            iou = bbox_iou_aux_loss(D_x, ob.net_target_x, node_flags, ob.weights,
                                    cfg.iou_loss_type, total_valid)
            loss_node = loss_node + cfg.iou_loss_weight * iou
        if cfg.flag_node_only:
            loss_node = loss_node * 0.0
        if global_world is None:
            loss = loss_adj.mean() + loss_node.mean()
        else:
            rows = global_world.size * loss_adj.shape[0]
            loss = loss_adj.sum() / rows + loss_node.sum() / rows
        return loss, {"loss_adj": loss_adj, "loss_node": loss_node, "sigmas": ob.sigmas}

    return loss_fn


def uses_valid_count(cfg: TrainStepConfig) -> bool:
    """Whether the loss divides by a count of valid nodes (the IoU loss)."""
    return cfg.iou_loss_weight > 0.0 and not cfg.flag_node_only


def global_valid_count(node_flags, world) -> torch.Tensor:
    """The global batch's count of valid nodes: this rank's, summed over
    ``world``.  It depends on the flags alone, so it is made before the
    step.  COLLECTIVE."""
    return all_reduce_sum(node_flags.float().sum(), world)


def train_step_config_from(config) -> TrainStepConfig:
    """Config -> TrainStepConfig (mirrors the reference trainer's wiring)."""
    node_only = config.train.get("node_only", False)
    info = get_node_adj_num_type(config.dataset.name, config.flag_sg, "one_hot", node_only,
                                 flag_node_bbox=False)
    return TrainStepConfig(
        precond=config.mcmc.precond,
        sigma_dist=config.mcmc.sigma_dist,
        self_condition=config.train.self_cond,
        symmetric_noise=not config.flag_sg,
        edge_loss_weight=config.train.edge_loss_weight,
        node_loss_weight=config.train.node_loss_weight,
        iou_loss_type=config.train.iou_loss_type,
        iou_loss_weight=config.train.iou_loss_weight,
        flag_node_only=node_only,
        node_encoding=config.train.node_encoding,
        edge_encoding=config.train.edge_encoding,
        num_node_type=info["num_node_type"],
        num_edge_type=info["num_adj_type"])


def draw_plan(cfg: TrainStepConfig, adjs_shape, nodes_shape) -> tuple:
    """The draws one step of ``make_loss_fn`` makes before its
    self-conditioning coin, in its order, as (method, kind, shape): the
    sigmas (``uniform`` for the vp and ve distributions), the adjacency
    noise and the node noise, at the shapes the one-hot encoding gives the
    batch (diffusion/edm.py ``NodeAdjEDMObjective.get_input_output``).  The
    coin (``bernoulli``, kind ``self_cond``) follows when
    ``cfg.self_condition``.  The compiled step (train/compiled.py) makes
    them ahead of its replay from the caller's noise source."""
    a, x = tuple(adjs_shape), tuple(nodes_shape)
    if cfg.node_encoding == "one_hot" and not cfg.flag_node_only:
        x = x[:-1] + (cfg.num_node_type + x[-1] - 1,)
    if cfg.edge_encoding == "one_hot":
        a = a + (cfg.num_edge_type,)
    sigma = "uniform" if cfg.sigma_dist in ("vp", "ve") else "normal"
    return ((sigma, "sigma", a[:1]), ("normal", "noise_adj", a), ("normal", "noise_node", x))


def local_metrics(loss, aux, world=None, reduce: str = "mean") -> dict:
    """The step's metrics before the ranks' all-reduce: ``scalars`` (loss,
    mean adjacency loss, mean node loss; with ``reduce`` "sum" each rank's
    part of the global batch's means) and the per-sample vectors."""
    loss_adj, loss_node = aux["loss_adj"].detach(), aux["loss_node"].detach()
    if world is not None and reduce == "sum":
        rows = world.size * loss_adj.shape[0]
        scalars = [loss.detach(), loss_adj.sum() / rows, loss_node.sum() / rows]
    else:
        scalars = [loss.detach(), loss_adj.mean(), loss_node.mean()]
    return {"scalars": torch.stack(scalars),
            "loss_adj_per_sample": loss_adj,
            "loss_node_per_sample": loss_node,
            "sigmas": aux["sigmas"].detach()}


def finish_metrics(local: dict, world=None, reduce: str = "mean") -> dict:
    """The step's metrics from ``local_metrics``: the scalars averaged over
    the ranks of ``world`` (``reduce`` "mean"), or summed there when each
    rank's are already its part of the global mean ("sum", the ``gspmd``
    mode); the per-sample vectors stay local."""
    scalars = local["scalars"]
    if world is not None:
        scalars = all_reduce_sum(scalars, world, mean=reduce == "mean")
    loss, loss_adj, loss_node = scalars.unbind()
    return {"loss": loss, "loss_adj": loss_adj, "loss_node": loss_node,
            **{k: v for k, v in local.items() if k != "scalars"}}


class _Step:
    """What the training and the test step share: ``world`` (None on one
    device), ``global_batch`` (the ``gspmd`` mode: this rank's part of the
    global batch, the scalar metrics summed over the ranks, the draws the
    global batch's rows, the loss given the global count of valid nodes;
    otherwise the metrics averaged), ``cfg`` (the ``TrainStepConfig``, which
    gives a compiled step its draws)."""

    def __init__(self, loss_fn, world=None, global_batch: bool = False,
                 cfg: TrainStepConfig | None = None):
        self.loss_fn, self.world, self.cfg = loss_fn, world, cfg
        self.global_batch = global_batch and world is not None
        self.reduce = "sum" if self.global_batch else "mean"

    def source(self, noise):
        """The draws this rank takes from the caller's ``noise``."""
        return GlobalRows(noise, self.world) if self.global_batch else noise

    def count(self, node_flags):
        """What the loss divides the IoU loss by, made before the step: the
        global count of valid nodes under ``global_batch`` (COLLECTIVE),
        otherwise None (the loss counts its own batch)."""
        if self.global_batch and uses_valid_count(self.cfg):
            return global_valid_count(node_flags, self.world)
        return None


class TrainStep(_Step):
    """(state, noise, adjs, nodes, flags) -> (state, metrics): backward
    (the gradients zeroed in place: buffers made once, which a captured
    step writes), the all-reduce of the gradients over ``world``, clip (or
    ``finish_grads(state)``, which clips: the tensor-parallel step's), Adam
    with the epoch's learning rate, the EMAs, and under ZeRO-1 the
    all-gather of the parameters.  The state is updated in place and
    returned.

    Its stages (``stages``) are what train/compiled.py captures or runs
    between its graphs; ``prepare`` writes the update's learning rate and
    EMA weights from the host before them."""

    def __init__(self, loss_fn, world=None, global_batch: bool = False, finish_grads=None,
                 cfg: TrainStepConfig | None = None):
        super().__init__(loss_fn, world, global_batch, cfg)
        self.finish_grads = finish_grads

    def __call__(self, state: TrainState, noise, adjs_gt, nodes_gt, node_flags):
        noise, total_valid = self.source(noise), self.count(node_flags)
        batch = (adjs_gt, nodes_gt, node_flags)
        self.prepare(state)
        local = {}
        for stage in self.stages(state):
            local = self.run(stage, state, noise, batch, total_valid) or local
        state.step += 1
        return state, finish_metrics(local, self.world, self.reduce)

    def stages(self, state: TrainState) -> tuple[str, ...]:
        """The step's stages in order: ``step`` (backward and update, no
        data-group collective between them) on one device or a data group
        of one process; otherwise ``backward``, ``reduce`` (the data group's
        all-reduce of the gradients), ``update`` and under ZeRO-1
        ``gather`` (its all-gather of the parameters).  ``reduce`` and
        ``gather`` are the COLLECTIVE stages (``COLLECTIVE``); the others
        run on the device alone, or with the model group's collectives
        (tensor parallel)."""
        if self.world is None:
            return ("step",)
        return ("backward", "reduce", "update") + (("gather",) if state.zero is not None else ())

    def run(self, stage: str, state: TrainState, noise, batch, total_valid=None) -> dict | None:
        """Stage ``stage``; the stages that hold the backward return the
        local metrics."""
        if stage in ("step", "backward"):
            local = self.backward(state, noise, state.step, *batch, total_valid=total_valid)
            if stage == "step":
                self.update(state)
            return local
        if stage == "reduce":
            self.reduce_grads(state)
        elif stage == "update":
            self.update(state)
        elif stage == "gather":
            state.zero.gather_params()
        else:
            raise ValueError(f"unknown stage {stage!r}")
        return None

    def backward(self, state: TrainState, noise, step: int, adjs_gt, nodes_gt, node_flags,
                 total_valid=None) -> dict:
        """Zero the gradients, forward, backward: the local metrics."""
        state.zero_grad()
        loss, aux = self.loss_fn(None, noise, step, adjs_gt, nodes_gt, node_flags, total_valid)
        loss.backward()
        return local_metrics(loss, aux, self.world, self.reduce)

    def reduce_grads(self, state: TrainState) -> None:
        """The gradients summed (``global_batch``) or averaged over
        ``world``: ZeRO-1's flat buffers, or every parameter's in buckets.
        COLLECTIVE."""
        mean = self.reduce == "mean"
        if state.zero is not None:
            state.zero.all_reduce_grads(mean)
        else:
            all_reduce_grads(state.params(), self.world, mean)

    @staticmethod
    def prepare(state: TrainState) -> None:
        """The learning rate and EMA weights of the update after
        ``state.step`` completed ones, written from the host."""
        set_lr(state.opt, state.spec.lr(state.step))
        set_ema_weights(state)

    def update(self, state: TrainState) -> None:
        """Clip, Adam, the EMAs."""
        if self.finish_grads is not None:
            self.finish_grads(state)
        else:
            torch.nn.utils.clip_grad_norm_(state.params(), state.spec.max_grad_norm)
        state.opt.step()
        apply_emas(state)


# the stages that run the data group's collectives, between a compiled step's graphs
COLLECTIVE = ("reduce", "gather")


def make_train_step(model, cfg: TrainStepConfig, world=None) -> TrainStep:
    """(state, noise, batch) -> (state, metrics).  The state is updated in
    place (parameters, Adam moments, EMAs, step) and returned.  With
    ``world`` the step runs on this rank's slice of the batch and averages
    the gradients (every parameter's, zeros where this rank's graph left
    none) and the scalar metrics over the ranks before the clip."""
    return TrainStep(make_loss_fn(model, cfg), world, cfg=cfg)


class EvalStep(_Step):
    """(params, noise, step, adjs, nodes, flags) -> metrics: the losses
    without an update (the reference's 'test' mode); with ``world`` the
    scalar metrics are reduced over the ranks.  ``local`` is the part on
    the device alone, which train/compiled.py captures."""

    def __call__(self, params, noise, step: int, adjs_gt, nodes_gt, node_flags):
        noise, total_valid = self.source(noise), self.count(node_flags)
        local = self.local(params, noise, step, adjs_gt, nodes_gt, node_flags, total_valid)
        return finish_metrics(local, self.world, self.reduce)

    @torch.no_grad()
    def local(self, params, noise, step: int, adjs_gt, nodes_gt, node_flags,
              total_valid=None) -> dict:
        loss, aux = self.loss_fn(params, noise, step, adjs_gt, nodes_gt, node_flags, total_valid)
        return local_metrics(loss, aux, self.world, self.reduce)


def make_eval_step(model, cfg: TrainStepConfig, world=None) -> EvalStep:
    """The same losses without an update (the reference's 'test' mode); with
    ``world`` the scalar metrics are averaged over the ranks."""
    return EvalStep(make_loss_fn(model, cfg), world, cfg=cfg)
