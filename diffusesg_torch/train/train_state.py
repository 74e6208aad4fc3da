"""Training state: the model, Adam, and K EMA copies of the parameters.

Counterpart of diffusesg_tpu/train/train_state.py (the reference's Adam +
ExponentialLR + ema_pytorch.EMA list).  The state is updated in place: the
model's parameters and the optimizer's moments are PyTorch's own, and the K
EMAs are lists of tensors aligned with ``model.parameters()``, each updated
with one ``torch._foreach_lerp_``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """clip-by-global-norm -> Adam(0.9, 0.999, eps 1e-8) with COUPLED weight
    decay (``torch.optim.Adam(weight_decay=...)`` adds wd * p to the clipped
    gradient, as the reference does; AdamW would decouple it) and a learning
    rate that decays by ``lr_decay`` once per epoch."""
    lr_init: float
    lr_decay: float
    steps_per_epoch: int
    weight_decay: float = 0.0
    max_grad_norm: float = 10.0

    def lr(self, count: int) -> float:
        """Learning rate of the update after ``count`` completed updates."""
        return self.lr_init * self.lr_decay ** (count // max(1, self.steps_per_epoch))

    def build(self, params) -> torch.optim.Adam:
        return torch.optim.Adam(params, lr=self.lr_init, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=self.weight_decay)


def make_optimizer(lr_init: float, lr_decay: float, steps_per_epoch: int,
                   weight_decay: float = 0.0, max_grad_norm: float = 10.0) -> OptimizerSpec:
    return OptimizerSpec(lr_init, lr_decay, steps_per_epoch, weight_decay, max_grad_norm)


@dataclasses.dataclass
class TrainState:
    step: int                              # completed updates (host int)
    model: nn.Module                       # owns the parameters
    spec: OptimizerSpec
    opt: torch.optim.Adam
    ema_params: list[list[torch.Tensor | None]]  # [K][P], aligned with model.parameters()
    ema_betas: list[float]                 # sorted ascending, like the reference
    # ZeRO-1 (parallel/sharded_step.py): the rank that holds each parameter's
    # Adam moments and EMAs, the other ranks' EMA entries None; None when
    # this process holds the whole state
    owners: list[int] | None = None
    # tensor parallel (parallel/tp.py): how each parameter is split over the
    # model group; None when no parameter is
    tp: object | None = None

    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())

    def param_names(self) -> list[str]:
        return [n for n, _ in self.model.named_parameters()]


def create_train_state(model: nn.Module, ema_betas: Sequence[float],
                       optimizer: OptimizerSpec) -> TrainState:
    params = list(model.parameters())
    betas = sorted(float(b) for b in ema_betas)
    emas = [[p.detach().clone() for p in params] for _ in betas]
    return TrainState(step=0, model=model, spec=optimizer, opt=optimizer.build(params),
                      ema_params=emas, ema_betas=betas)


def ema_effective_decay(beta: float, step: int) -> float:
    """ema_pytorch's step-dependent decay for EMA(beta, update_every=1,
    update_after_step=0, inv_gamma=1, power=1).  With ``step`` completed
    updates before this call, update k = step + 1 applies: a copy for k = 1
    and k = 2, then decay = min(beta, 1 - 1/k)."""
    k = step + 1
    return 0.0 if k <= 2 else min(beta, 1.0 - 1.0 / k)


@torch.no_grad()
def update_emas(state: TrainState) -> None:
    """ema <- ema * d + p * (1 - d) for each of the K copies, d from the
    warm-up ramp at ``state.step`` completed updates (under ZeRO-1 the
    copies of the parameters this rank owns)."""
    params = [p.detach() for p in state.model.parameters()]
    held = range(len(params))
    if state.owners is not None and state.ema_params:  # ZeRO-1: the copies this rank holds
        held = [i for i, e in enumerate(state.ema_params[0]) if e is not None]
    params = [params[i] for i in held]
    for beta, full in zip(state.ema_betas, state.ema_params):
        ema = [full[i] for i in held]
        decay = ema_effective_decay(beta, state.step)
        if decay == 0.0:
            torch._foreach_copy_(ema, params)
        else:
            torch._foreach_lerp_(ema, params, 1.0 - decay)


def ema_slice(state: TrainState, idx: int) -> dict[str, torch.Tensor]:
    """EMA copy #idx as a name -> tensor dict (``torch.func.functional_call``
    and ``load_state_dict`` both take it).  Under ZeRO-1 the copy is gathered
    from the ranks that own its parts: a COLLECTIVE, every rank calls it."""
    if state.owners is None:
        return dict(zip(state.param_names(), state.ema_params[idx]))
    from ..parallel.sharded_step import gather_emas
    return dict(zip(state.param_names(), gather_emas(state, [idx])[0]))
