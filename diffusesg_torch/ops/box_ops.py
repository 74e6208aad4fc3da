"""Bounding-box math on tensors, differentiable.

Counterpart of diffusesg_tpu/ops/box_ops.py (torchvision's box ops as the
reference trainer uses them).  All functions take aligned pairs [..., 4].
"""
from __future__ import annotations

import math

import torch


def box_cxcywh_to_xyxy(boxes):
    """[..., 4] (cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def _box_area(boxes):
    # the raw signed area: an inverted box (x2 < x1) counts negative, as in
    # torchvision's box_area
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _inter_union(boxes1, boxes2):
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter, _box_area(boxes1) + _box_area(boxes2) - inter


def box_iou_aligned(boxes1, boxes2, eps: float = 1e-7):
    """Element-wise IoU of aligned xyxy boxes; ``eps`` guards a zero union."""
    inter, union = _inter_union(boxes1, boxes2)
    return inter / (union + eps)


def _hull(boxes1, boxes2):
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    return lt, rb


def generalized_box_iou_loss(boxes1, boxes2, eps: float = 1e-7):
    """1 - GIoU; the hull area is the raw product (torchvision semantics)."""
    inter, union = _inter_union(boxes1, boxes2)
    lt, rb = _hull(boxes1, boxes2)
    hull = (rb[..., 0] - lt[..., 0]) * (rb[..., 1] - lt[..., 1])
    return 1.0 - (inter / (union + eps) - (hull - union) / (hull + eps))


def distance_box_iou_loss(boxes1, boxes2, eps: float = 1e-7):
    """DIoU loss of aligned xyxy boxes."""
    lt, rb = _hull(boxes1, boxes2)
    diag_sq = ((rb - lt) ** 2).sum(-1) + eps
    c1 = 0.5 * (boxes1[..., :2] + boxes1[..., 2:])
    c2 = 0.5 * (boxes2[..., :2] + boxes2[..., 2:])
    return 1.0 - box_iou_aligned(boxes1, boxes2, eps) + ((c1 - c2) ** 2).sum(-1) / diag_sq


def complete_box_iou_loss(boxes1, boxes2, eps: float = 1e-7):
    """CIoU loss: raw w/h, and alpha held constant under differentiation, as
    torchvision.ops.complete_box_iou_loss computes it under ``no_grad``."""
    w1, h1 = boxes1[..., 2] - boxes1[..., 0], boxes1[..., 3] - boxes1[..., 1]
    w2, h2 = boxes2[..., 2] - boxes2[..., 0], boxes2[..., 3] - boxes2[..., 1]
    v = (4.0 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (1.0 - box_iou_aligned(boxes1, boxes2, eps) + v + eps)).detach()
    return distance_box_iou_loss(boxes1, boxes2, eps) + alpha * v
