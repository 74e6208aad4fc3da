"""Training state: the model, Adam, and K EMA copies of the parameters.

Counterpart of diffusesg_tpu/train/train_state.py (the reference's Adam +
ExponentialLR + ema_pytorch.EMA list).  The state is updated in place: the
model's parameters and the optimizer's moments are PyTorch's own, and the K
EMAs are lists of tensors aligned with ``model.parameters()``, each updated
with one ``torch._foreach_lerp_``.

What a step changes from the host lives on the device, so that a captured
CUDA graph of the step (train/compiled.py) takes each replay's values: on
a card Adam is ``capturable`` (its step counts and bias corrections device
tensors, its learning rate a device tensor that ``set_lr`` writes), and the
EMAs' lerp weights are read from device memory (``EmaWeights``, written by
``set_ema_weights``).  Checkpoints keep the learning rate as a number
(``opt_state_dict``), and ``load_opt_state`` restores into either Adam.
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

    def adam_kwargs(self, device) -> dict:
        """Adam's settings for parameters on ``device``: on a card
        ``capturable``, its learning rate a device tensor; elsewhere the
        plain Adam (``capturable`` refuses the CPU)."""
        kw = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=self.weight_decay)
        if torch.device(device).type == "cuda":
            lr = torch.tensor(self.lr_init, dtype=torch.float32, device=device)
            return dict(kw, lr=lr, capturable=True)
        return dict(kw, lr=self.lr_init)

    def build(self, params) -> torch.optim.Adam:
        """Adam over ``params`` (``adam_kwargs``)."""
        params = list(params)
        return torch.optim.Adam(params, **self.adam_kwargs(params[0].device))


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """Every group's learning rate: written into a capturable Adam's device
    tensor (which a captured step reads), assigned to a plain one's."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def opt_state_dict(opt: torch.optim.Optimizer) -> dict:
    """``opt.state_dict()`` with each group's learning rate a number."""
    saved = opt.state_dict()
    for group in saved["param_groups"]:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"] = float(group["lr"])
    return saved


def load_opt_state(opt: torch.optim.Optimizer, saved: dict) -> None:
    """Load Adam's ``saved`` state into ``opt`` in ``opt``'s own form: its
    ``capturable`` flag (a card's state restores on the CPU's plain Adam and
    the other way round; ``load_state_dict`` puts a capturable Adam's step
    counts on the parameters' device) and its learning-rate tensor, which
    keeps its identity (a graph captured over ``opt`` reads it) and takes
    the saved rate."""
    kept = [(g["lr"], g.get("capturable", False)) for g in opt.param_groups]
    groups = [dict(g, lr=float(g["lr"]), capturable=cap)
              for g, (_, cap) in zip(saved["param_groups"], kept)]
    opt.load_state_dict(dict(saved, param_groups=groups))
    for group, (lr, _) in zip(opt.param_groups, kept):
        if isinstance(lr, torch.Tensor):
            lr.fill_(group["lr"])
            group["lr"] = lr


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
    # ZeRO-1 (parallel/zero.py ``FlatZero``): the flat layout, the parameters
    # views of its buffers, Adam over its owned ranges and ``ema_params`` [K][D]
    # those ranges' EMAs (one a dtype); None when this process holds the whole
    # state
    zero: object | None = None
    # tensor parallel (parallel/tp.py): how each parameter is split over the
    # model group; None when no parameter is
    tp: object | None = None
    # the EMAs' lerp weights on the device, made at the first update
    ema_weights: "EmaWeights | None" = None

    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())

    def param_names(self) -> list[str]:
        return [n for n, _ in self.model.named_parameters()]

    def ema_targets(self) -> list[torch.Tensor]:
        """What the EMAs track, aligned with ``ema_params[k]``: the
        parameters, or under ZeRO-1 the owned ranges."""
        if self.zero is not None:
            return self.zero.shards()
        return [p.detach() for p in self.model.parameters()]

    def zero_grad(self) -> None:
        """Zero every gradient in place (a captured step writes them where
        they lie)."""
        if self.zero is not None:
            self.zero.zero_grad()
        else:
            self.opt.zero_grad(set_to_none=False)


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


class EmaWeights:
    """The K EMAs' lerp weights (1 - decay) of the next update on the
    parameters' device: per dtype a [K, n] buffer (n the largest
    parameter's size) whose row k holds EMA k's weight in every element,
    and each parameter's view of each row.  ``torch._foreach_lerp_`` over
    those views reads the weights from device memory, so a captured graph
    of the update takes each replay's weights (a weight given as a tensor
    scalar would be read on the host); it is bit-equal to the lerp with a
    number weight, and at weight 1 to the copy of the warm-up updates 1
    and 2 (chip_smoke.py phase 13 and tests/test_torch_compiled_train.py
    hold both)."""

    def __init__(self, params: list[torch.Tensor], k: int):
        sizes: dict[torch.dtype, int] = {}
        for p in params:
            sizes[p.dtype] = max(sizes.get(p.dtype, 0), p.numel())
        self.bufs = {dt: torch.zeros((k, n), dtype=dt, device=params[0].device)
                     for dt, n in sizes.items()}
        self.views = [[self.bufs[p.dtype][j, :p.numel()].view(p.shape) for p in params]
                      for j in range(k)]

    def fill(self, weights: list[float]) -> None:
        for buf in self.bufs.values():
            for j, w in enumerate(weights):
                buf[j].fill_(w)


def set_ema_weights(state: TrainState) -> None:
    """Write the lerp weights of the update after ``state.step`` completed
    ones into ``state.ema_weights`` (made here at the first call)."""
    if state.ema_weights is None:
        state.ema_weights = EmaWeights(state.ema_targets(), len(state.ema_betas))
    state.ema_weights.fill([1.0 - ema_effective_decay(b, state.step)
                            for b in state.ema_betas])


@torch.no_grad()
def apply_emas(state: TrainState) -> None:
    """ema <- lerp(ema, p, w) for each of the K copies with the weights
    ``set_ema_weights`` wrote (under ZeRO-1 the copies of the owned
    ranges)."""
    targets = state.ema_targets()
    for ema, views in zip(state.ema_params, state.ema_weights.views):
        torch._foreach_lerp_(ema, targets, views)


def update_emas(state: TrainState) -> None:
    """ema <- ema * d + p * (1 - d) for each of the K copies, d from the
    warm-up ramp at ``state.step`` completed updates (a copy for updates 1
    and 2)."""
    set_ema_weights(state)
    apply_emas(state)


def ema_slice(state: TrainState, idx: int) -> dict[str, torch.Tensor]:
    """EMA copy #idx as a name -> tensor dict (``torch.func.functional_call``
    and ``load_state_dict`` both take it), over the live EMA.  Under ZeRO-1
    the copy is gathered from the ranks' ranges into one set of buffers
    that keeps its addresses and that the next ``ema_slice`` of any copy
    overwrites: a COLLECTIVE, every rank calls it."""
    emas = state.ema_params[idx]
    if state.zero is not None:
        emas = state.zero.whole(emas, keep=True)
    return dict(zip(state.param_names(), emas))


def whole_emas_and_opt(state: TrainState) -> tuple[list[list[torch.Tensor]], dict]:
    """The K EMAs aligned with the parameters and Adam's state in the
    single-device form (``opt_state_dict``): the state's own, or under
    ZeRO-1 gathered from the ranks (COLLECTIVE).  Their tensors may be the
    state's."""
    if state.zero is None:
        return state.ema_params, opt_state_dict(state.opt)
    return ([state.zero.whole(ema) for ema in state.ema_params],
            state.zero.opt_state(state.opt))
