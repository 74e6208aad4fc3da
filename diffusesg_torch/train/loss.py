"""Training losses: masked per-sample regression ("rainbow") loss and the
auxiliary bbox IoU loss.

Counterpart of diffusesg_tpu/train/loss.py.  Shapes are channels-last; the
per-sample normalization reproduces the reference:
  adj:  sum / (num_valid_nodes^2) [/ C if multichannel]
  node: sum / num_valid_nodes     [/ C if multichannel]
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.box_ops import (box_cxcywh_to_xyxy, box_iou_aligned, complete_box_iou_loss,
                           distance_box_iou_loss, generalized_box_iou_loss)
from ..ops.masking import mask_adjs, mask_nodes


def _over(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.reshape((x.shape[0],) + (1,) * (like.ndim - 1))


@dataclasses.dataclass(frozen=True)
class NodeAdjRainbowLoss:
    """Masked, EDM-weighted MSE on (D - clean) for both modalities
    (reference: rainbow_loss.py:36-99, reduction='none' path)."""
    edge_loss_weight: float = 1.0
    node_loss_weight: float = 1.0
    objective: str = "edm"

    def __call__(self, pred_adj, pred_node, target_adj, target_node, node_flags,
                 loss_weight=None):
        """-> (loss_adj [B], loss_node [B])."""
        b = pred_adj.shape[0]
        if loss_weight is None:
            loss_weight = torch.ones((b,), dtype=torch.float32, device=pred_adj.device)
        sq_adj = (pred_adj - target_adj) ** 2
        sq_node = (pred_node - target_node) ** 2
        sq_adj = mask_adjs(sq_adj * _over(loss_weight, sq_adj), node_flags)
        sq_node = mask_nodes(sq_node * _over(loss_weight, sq_node), node_flags)

        if node_flags.ndim == 2:
            counts = node_flags.float().sum(-1)
            num_adj_entries, num_node_entries = counts ** 2, counts
        else:
            counts = node_flags.float().sum((-1, -2))
            num_adj_entries = num_node_entries = counts

        if sq_adj.ndim == 3:
            loss_adj = sq_adj.sum((-1, -2)) / num_adj_entries
        else:
            loss_adj = sq_adj.sum((-1, -2, -3)) / num_adj_entries / sq_adj.shape[-1]
        if sq_node.ndim == 2:
            loss_node = sq_node.sum(-1) / num_node_entries
        else:
            loss_node = sq_node.sum((-1, -2)) / num_node_entries / sq_node.shape[-1]
        return loss_adj * self.edge_loss_weight, loss_node * self.node_loss_weight


def bbox_iou_aux_loss(pred_node, target_node, node_flags, weights, iou_loss_type: str = "iou",
                      total_valid=None):
    """Auxiliary IoU loss on the trailing bbox slice [..., -4:] (reference:
    trainer_node_adj.py:130-159) -> [B], already multiplied by the EDM
    weights.  As in the reference, each sample's loss is divided by the TOTAL
    number of valid nodes in the batch, not by its own: this batch's count,
    or ``total_valid`` when given (the global batch's count under the
    ``gspmd`` mode; the ``shard_map`` mode divides by the local shard's, as
    the reference's DDP ranks do)."""
    pred_xyxy = box_cxcywh_to_xyxy((pred_node[..., -4:] + 1.0) / 2.0).clamp(0.0, 1.0)
    tgt_xyxy = box_cxcywh_to_xyxy((target_node[..., -4:] + 1.0) / 2.0).clamp(0.0, 1.0)

    if iou_loss_type == "iou":
        per_node = -(box_iou_aligned(pred_xyxy, tgt_xyxy) ** 2.0)
    elif iou_loss_type == "ciou":
        per_node = complete_box_iou_loss(pred_xyxy, tgt_xyxy)
    elif iou_loss_type == "diou":
        per_node = distance_box_iou_loss(pred_xyxy, tgt_xyxy)
    elif iou_loss_type in ("giou", "giou_squared"):
        per_node = generalized_box_iou_loss(pred_xyxy, tgt_xyxy)
        if iou_loss_type == "giou_squared":
            per_node = per_node ** 2.0
    else:
        raise NotImplementedError(f"unknown iou_loss_type {iou_loss_type}")

    flags_f = node_flags.float()
    total = flags_f.sum() if total_valid is None else total_valid
    per_sample = (per_node * flags_f).sum(-1) / total
    return per_sample * weights
