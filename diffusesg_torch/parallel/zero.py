"""ZeRO-1 over flat buffers: Adam and the K EMAs sharded over a data group.

Counterpart of the JAX package's ZeRO-1 state shardings
(diffusesg_tpu/parallel/sharded_step.py:21-50, mesh.py:85-120), which
shard every optimizer and EMA leaf along its largest divisible axis.  Here,
for each dtype, the parameters become views of one flat buffer, and their
gradients views of a matching flat gradient buffer.  Each parameter starts
at a multiple of ``ALIGN_BYTES``, as a tensor of its own would (the
kernels load weights with vector and TMA loads, which fault on an address
that is not: a layout packed tight stops the backward with "misaligned
address" on the H100), and the buffer ends padded to a
multiple of the world size; the gaps are zeros, which Adam and the EMAs
keep at zero.  Rank r owns the contiguous range
[r n / W, (r + 1) n / W) of each buffer (n padded, W ranks): its Adam steps
one tensor per dtype that aliases that range of the parameters (its
gradient the same range of the gradient buffer), and it holds the K EMAs of
the range.  The layouts differ from the JAX package's, the numbers do not.

A step over this layout (parallel/sharded_step.py): the backward writes the
gradient buffers; one all-reduce of each over the group; every rank clips
the whole gradient as the single-device step does (over the per-parameter
views); Adam and the EMA lerps on the owned range, elementwise as the
single-device foreach Adam and lerp, so a world of one is the single-device
step bit for bit; then one all-gather of each parameter buffer in place.
Checkpoints keep the single-device format: ``opt_state`` and ``whole``
gather the ranges back into per-parameter tensors, ``owned`` and
``load_opt_state`` take them apart again.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .mesh import World, all_gather_flat

# where each parameter starts in its flat buffer: the CUDA caching
# allocator's alignment of a tensor of its own
ALIGN_BYTES = 512


@dataclasses.dataclass
class Bucket:
    """One dtype's flat buffers: ``data`` (the parameters), ``grad`` (their
    gradients), and ``shard``, the owned range [lo, hi) of ``data`` as a
    leaf whose gradient is the same range of ``grad``."""
    data: torch.Tensor
    grad: torch.Tensor
    lo: int
    hi: int
    shard: torch.Tensor


class FlatZero:
    """The ZeRO-1 layout of ``params`` over ``world`` (module docstring).
    Building it makes every parameter a view of its dtype's buffer (the
    values kept) and sets its gradient to a view of the gradient buffer;
    nothing may rebind a parameter's data after.  ``where[i]`` is
    parameter i's (dtype, offset); ``buckets`` are in the order of the
    dtypes' first parameters."""

    def __init__(self, params: list[torch.Tensor], world: World):
        self.world = world
        self.shapes = [p.shape for p in params]
        sizes: dict[torch.dtype, int] = {}
        self.where = []
        for p in params:
            align = max(1, ALIGN_BYTES // p.element_size())
            off = -(-sizes.get(p.dtype, 0) // align) * align
            self.where.append((p.dtype, off))
            sizes[p.dtype] = off + p.numel()
        self.buckets: dict[torch.dtype, Bucket] = {}
        with torch.no_grad():
            for dt, n in sizes.items():
                per = -(-n // world.size)
                data = torch.zeros(per * world.size, dtype=dt, device=params[0].device)
                grad = torch.zeros_like(data)
                lo = world.rank * per
                shard = data[lo:lo + per]
                shard.grad = grad[lo:lo + per]
                self.buckets[dt] = Bucket(data, grad, lo, lo + per, shard)
            for p, (dt, off) in zip(params, self.where):
                b = self.buckets[dt]
                view = b.data[off:off + p.numel()].view(p.shape)
                view.copy_(p.detach())
                p.data = view
                p.grad = b.grad[off:off + p.numel()].view(p.shape)
        self._kept: list[torch.Tensor] | None = None

    def shards(self) -> list[torch.Tensor]:
        """The owned ranges Adam steps and the EMAs track, one per dtype."""
        return [b.shard for b in self.buckets.values()]

    def padding(self) -> list[int]:
        """Per dtype, how many of the owned range's elements belong to no
        parameter (the gaps and the end's padding)."""
        held = dict.fromkeys(self.buckets, 0)
        for (dt, off), shape in zip(self.where, self.shapes):
            b = self.buckets[dt]
            held[dt] += max(0, min(b.hi, off + shape.numel()) - max(b.lo, off))
        return [b.hi - b.lo - held[dt] for dt, b in self.buckets.items()]

    def zero_grad(self) -> None:
        for b in self.buckets.values():
            b.grad.zero_()

    def all_reduce_grads(self, mean: bool = False) -> None:
        """Sum (``mean``: average) the gradient buffers over the group, in
        place: one all-reduce a dtype.  COLLECTIVE."""
        for b in self.buckets.values():
            dist.all_reduce(b.grad, group=self.world.group)
            if mean:
                b.grad.div_(self.world.size)

    @torch.no_grad()
    def gather_params(self) -> None:
        """Every rank's owned range into every rank's parameter buffers: one
        all-gather a dtype, in place.  COLLECTIVE."""
        for b in self.buckets.values():
            all_gather_flat(b.data, b.shard, self.world)

    @torch.no_grad()
    def whole(self, ranges: list[torch.Tensor], keep: bool = False) -> list[torch.Tensor]:
        """Per-parameter tensors from every rank's ``ranges`` (one owned
        range a dtype, e.g. an EMA or an Adam moment): an all-gather a
        dtype into new buffers, or with ``keep`` into the one set of
        buffers that every call with ``keep`` shares, so that the tensors
        keep their addresses (a compiled eval step's program is keyed by
        them) and a rank holds one whole copy beside its ranges, whichever
        EMA it gathers; the next such call overwrites them.  COLLECTIVE."""
        bufs = self._kept if keep else None
        if bufs is None:
            bufs = [torch.empty_like(b.data) for b in self.buckets.values()]
            if keep:
                self._kept = bufs
        for buf, part in zip(bufs, ranges):
            all_gather_flat(buf, part, self.world)
        by_dtype = dict(zip(self.buckets, bufs))
        return [by_dtype[dt][off:off + s.numel()].view(s)
                for (dt, off), s in zip(self.where, self.shapes)]

    @torch.no_grad()
    def owned(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """This rank's ranges of whole per-parameter ``tensors`` (a
        checkpoint's EMA or moment; on any device), one a dtype, on the
        buffers' device."""
        flats = {dt: torch.zeros_like(b.data) for dt, b in self.buckets.items()}
        for t, (dt, off) in zip(tensors, self.where):
            flats[dt][off:off + t.numel()].copy_(t.reshape(-1))
        return [flats[dt][b.lo:b.hi].clone() for dt, b in self.buckets.items()]

    def opt_state(self, opt: torch.optim.Optimizer) -> dict:
        """``opt``'s state (Adam over ``shards``) in the single-device form
        of ``train_state.opt_state_dict``: the moments gathered per
        parameter, each parameter with its dtype's step count.
        COLLECTIVE."""
        from ..train.train_state import opt_state_dict
        saved = opt_state_dict(opt)
        per_param: dict[int, dict] = {}
        if saved["state"]:  # the shards step together: all hold a state or none
            states = [saved["state"][j] for j in range(len(self.buckets))]
            steps = dict(zip(self.buckets, (st["step"] for st in states)))
            per_param = {i: {"step": steps[dt].clone()} for i, (dt, _) in enumerate(self.where)}
            for key in states[0]:
                if key != "step":
                    for i, t in enumerate(self.whole([st[key] for st in states])):
                        per_param[i][key] = t
        groups = [dict(g, params=list(range(len(self.where)))) for g in saved["param_groups"]]
        return {"state": per_param, "param_groups": groups}

    def load_opt_state(self, opt: torch.optim.Optimizer, saved: dict) -> None:
        """Load a single-device Adam state (``opt_state``'s form) into
        ``opt``, Adam over ``shards``: this rank's ranges of the moments and
        the step count of each dtype, which every parameter of that dtype
        must share."""
        from ..train.train_state import load_opt_state
        state, ranges = saved["state"], {}
        if state:
            if len(state) != len(self.where):
                raise ValueError(f"Adam's state holds {len(state)} parameters, the model "
                                 f"{len(self.where)}")
            for j, dt in enumerate(self.buckets):
                mine = [i for i, (d, _) in enumerate(self.where) if d == dt]
                steps = {float(state[i]["step"]) for i in mine}
                if len(steps) != 1:
                    raise ValueError(f"ZeRO-1 steps one Adam over every {dt} parameter, the "
                                     f"checkpoint's step counts differ: {sorted(steps)}")
                ranges[j] = {"step": state[mine[0]]["step"]}
            for key in state[0]:
                if key != "step":
                    whole = [state[i][key] for i in range(len(self.where))]
                    for j, t in enumerate(self.owned(whole)):
                        ranges[j][key] = t
        groups = [dict(g, params=list(range(len(self.buckets)))) for g in saved["param_groups"]]
        load_opt_state(opt, {"state": ranges, "param_groups": groups})
