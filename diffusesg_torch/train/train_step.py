"""The training and evaluation step.

Counterpart of diffusesg_tpu/train/train_step.py: sigma draw, noising,
preconditioned forward with stochastic self-conditioning, rainbow + IoU
losses, backward, clip, Adam and the K EMA updates, on one device (the
multi-device ``axis_name`` waits for the multi-device slice).  Metrics stay
on the device: nothing in a step reads a value back to the host.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.func import functional_call

from ..diffusion.edm import NodeAdjEDMObjective
from ..models.channels import get_node_adj_num_type
from ..models.precond import precond_forward_train
from ..ops.attribute_code import attribute_int_to_one_hot
from .loss import NodeAdjRainbowLoss, bbox_iou_aux_loss
from .train_state import TrainState, update_emas


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


def make_loss_fn(model, cfg: TrainStepConfig):
    """loss(params, noise, step, batch) -> (scalar, aux dict).  ``params`` is
    None for the model's own parameters or a name -> tensor dict (an EMA
    copy) applied with ``torch.func.functional_call``; ``noise`` is the
    source of the step's random draws."""
    objective = NodeAdjEDMObjective(precond=cfg.precond, sigma_dist=cfg.sigma_dist,
                                    symmetric_noise=cfg.symmetric_noise)
    rainbow = NodeAdjRainbowLoss(cfg.edge_loss_weight, cfg.node_loss_weight)

    def loss_fn(params, noise, step: int, adjs_gt, nodes_gt, node_flags):
        adjs_gt, nodes_gt = encode_one_hot_batch(adjs_gt, nodes_gt, node_flags, cfg)
        ob = objective.get_input_output(noise, step, adjs_gt, nodes_gt, node_flags)

        def denoiser_fn(*args):
            return model(*args) if params is None else functional_call(model, params, args)

        D_a, D_x = precond_forward_train(denoiser_fn, cfg.precond, cfg.self_condition, noise,
                                         step, ob.net_input_a, ob.net_input_x, node_flags,
                                         ob.sigmas)
        loss_adj, loss_node = rainbow(D_a, D_x, ob.net_target_a, ob.net_target_x, node_flags,
                                      loss_weight=ob.weights)
        if cfg.iou_loss_weight > 0.0 and not cfg.flag_node_only:
            iou = bbox_iou_aux_loss(D_x, ob.net_target_x, node_flags, ob.weights,
                                    cfg.iou_loss_type)
            loss_node = loss_node + cfg.iou_loss_weight * iou
        if cfg.flag_node_only:
            loss_node = loss_node * 0.0
        loss = loss_adj.mean() + loss_node.mean()
        return loss, {"loss_adj": loss_adj, "loss_node": loss_node, "sigmas": ob.sigmas}

    return loss_fn


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


def _metrics(loss, aux):
    return {"loss": loss.detach(),
            "loss_adj": aux["loss_adj"].detach().mean(),
            "loss_node": aux["loss_node"].detach().mean(),
            "loss_adj_per_sample": aux["loss_adj"].detach(),
            "loss_node_per_sample": aux["loss_node"].detach(),
            "sigmas": aux["sigmas"].detach()}


def make_train_step(model, cfg: TrainStepConfig):
    """(state, noise, batch) -> (state, metrics).  The state is updated in
    place (parameters, Adam moments, EMAs, step) and returned."""
    loss_fn = make_loss_fn(model, cfg)

    def train_step(state: TrainState, noise, adjs_gt, nodes_gt, node_flags):
        state.opt.zero_grad(set_to_none=True)
        loss, aux = loss_fn(None, noise, state.step, adjs_gt, nodes_gt, node_flags)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(state.params(), state.spec.max_grad_norm)
        lr = state.spec.lr(state.step)
        for group in state.opt.param_groups:
            group["lr"] = lr
        state.opt.step()
        update_emas(state)
        state.step += 1
        return state, _metrics(loss, aux)

    return train_step


def make_eval_step(model, cfg: TrainStepConfig):
    """The same losses without an update (the reference's 'test' mode)."""
    loss_fn = make_loss_fn(model, cfg)

    @torch.no_grad()
    def eval_step(params, noise, step: int, adjs_gt, nodes_gt, node_flags):
        return _metrics(*loss_fn(params, noise, step, adjs_gt, nodes_gt, node_flags))

    return eval_step
