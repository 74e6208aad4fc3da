"""Plain reference of DiffuseSG's training step.

The EDM objective (Karras et al. 2022): sigma = exp(1.2 n - 1.2), loss
weight (sigma^2 + 0.5^2) / (0.5 sigma)^2; both modalities noised with the
step's draws; with p = 0.5 (the step's coin) a self-conditioning pass under
no gradient feeds its output back.  The loss is DiffuseSG's
(ubc-vision/DiffuseSG, runner/trainer/trainer_node_adj.py and
utils/rainbow_loss.py): the weighted masked square error of each modality,
divided per graph by its valid entries (n^2 edges, n nodes times their 5
channels), plus the box IoU loss, -IoU^2 of each valid node's box divided by
the batch's count of valid nodes and weighted.  The batch mean of both, the
gradient clipped to a global norm of 10, Adam (0.9, 0.999, eps 1e-8), and
the EMAs of ema_pytorch (a copy at updates 1 and 2, then decay
min(beta, 1 - 1/k)).

``grads`` runs the batch in blocks of rows so that float32 activations fit;
a data-parallel step is the mean over the ranks of each rank's gradient of
its own rows, draws and coin (the reference's DDP).
"""
from __future__ import annotations

import torch

from .model import Shape, denoise, mask_adjs, mask_nodes

P_MEAN, P_STD, SIGMA_DATA = -1.2, 1.2, 0.5
MAX_GRAD_NORM = 10.0
BETAS, EPS = (0.9, 0.999), 1e-8


def _xyxy(box):
    cx, cy, w, h = box.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def _iou(b1, b2, eps=1e-7):
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda b: (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])  # noqa: E731
    return inter / (area(b1) + area(b2) - inter + eps)


def loss_rows(P, shape: Shape, adjs, nodes, flags, draws, coin: bool, total_valid, quant=None):
    """Each graph's loss (adjacency + nodes + IoU) over the rows given;
    ``draws`` holds these rows' sigma, noise_adj and noise_node."""
    sig = torch.exp(draws["sigma"] * P_STD + P_MEAN)
    weight = (sig ** 2 + SIGMA_DATA ** 2) / (sig * SIGMA_DATA) ** 2
    noisy_a = mask_adjs(adjs + draws["noise_adj"] * sig[:, None, None], flags)
    noisy_x = nodes + mask_nodes(draws["noise_node"] * sig[:, None, None], flags)
    sc_a = sc_x = None
    if shape.self_cond and coin:
        with torch.no_grad():
            sc_a, sc_x = denoise(P, shape, noisy_a, noisy_x, flags, sig, quant=quant)
    d_a, d_x = denoise(P, shape, noisy_a, noisy_x, flags, sig, sc_a, sc_x, quant)
    count = flags.float().sum(-1)
    sq_a = mask_adjs((d_a - adjs) ** 2 * weight[:, None, None], flags)
    sq_x = mask_nodes((d_x - nodes) ** 2 * weight[:, None, None], flags)
    loss_a = sq_a.sum((-1, -2)) / count ** 2
    loss_x = sq_x.sum((-1, -2)) / count / sq_x.shape[-1]
    pred = _xyxy((d_x[..., -4:] + 1.0) / 2.0).clamp(0.0, 1.0)
    tgt = _xyxy((nodes[..., -4:] + 1.0) / 2.0).clamp(0.0, 1.0)
    iou = (-(_iou(pred, tgt) ** 2) * flags.float()).sum(-1) / total_valid * weight
    return loss_a + loss_x + iou


def grads(P, shape: Shape, shards, block: int, quant=None):
    """(loss, gradients, each graph's loss) of one step: ``shards`` is a
    list, one per rank, of (adjs, nodes, flags, draws, coin); the loss and
    the gradients are the mean over the ranks of each rank's batch mean."""
    params = {k: v.detach().requires_grad_(True) for k, v in P.items()}
    total = {k: torch.zeros_like(v) for k, v in P.items()}
    loss, per_row = 0.0, []
    for adjs, nodes, flags, draws, coin in shards:
        rows = adjs.shape[0]
        valid = flags.float().sum()
        for lo in range(0, rows, block):
            sl = slice(lo, lo + block)
            each = loss_rows(params, shape, adjs[sl], nodes[sl], flags[sl],
                             {k: v[sl] for k, v in draws.items()}, coin, valid, quant)
            per_row.append(each.detach())
            part = each.sum() / rows / len(shards)
            names = [k for k, v in params.items()]
            gs = torch.autograd.grad(part, [params[k] for k in names], allow_unused=True)
            for k, g in zip(names, gs):
                if g is not None:
                    total[k] += g
            loss += float(part.detach())
    return loss, total, torch.cat(per_row)


def clip(gs: dict) -> dict:
    """The gradients scaled to a global norm of at most ``MAX_GRAD_NORM``."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in gs.values())).float()
    coef = torch.clamp(MAX_GRAD_NORM / (norm + 1e-6), max=1.0)
    return {k: g * coef for k, g in gs.items()}


class Adam:
    """Adam with the bias corrections of ``torch.optim.Adam``."""

    def __init__(self, params: dict, lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, gs: dict) -> dict:
        self.t += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        out = {}
        for k, p in params.items():
            self.m[k] = b1 * self.m[k] + (1 - b1) * gs[k]
            self.v[k] = b2 * self.v[k] + (1 - b2) * gs[k] ** 2
            denom = self.v[k].sqrt() / c2 ** 0.5 + EPS
            out[k] = p - (self.lr / c1) * self.m[k] / denom
        return out


def ema_weight(beta: float, done: int) -> float:
    """The lerp weight of update ``done + 1`` (ema_pytorch's warm-up)."""
    k = done + 1
    return 1.0 if k <= 2 else 1.0 - min(beta, 1.0 - 1.0 / k)
