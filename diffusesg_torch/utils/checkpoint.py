"""Checkpoints of the full training state, in a torch-native format.

Counterpart of diffusesg_tpu/utils/checkpoint.py (orbax there).  One file per
checkpoint, ``torch.save`` of

    {"step", "params" (state_dict), "ema_params" (K lists aligned with the
     parameters), "ema_betas", "opt_state" (Adam's state_dict), "extra"}

written to a temporary file in the same directory and renamed into place, so
a reader never sees a partial checkpoint.  Saves are synchronous;
asynchronous saves wait.  A ZeRO-1 state (parallel/sharded_step.py) is
gathered to rank 0 first, which alone writes, so a data-parallel checkpoint
has the single-device format and resumes on one device and the other way
round.

Layout on disk:
  <run_dir>/models_ckpt/<epoch>.pt   rolling per-interval checkpoints
  <run_dir>/models_ckpt/preempt.pt   written on SIGTERM/SIGINT
  <run_dir>/models/best.pt           best-by-test-loss checkpoint
  <run_dir>/config.yaml              resolved config
"""
from __future__ import annotations

import os
import tempfile
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:  # utils <-> train would import each other at run time
    from ..train.train_state import TrainState

SUFFIX = ".pt"


def save_checkpoint(path: str, state: "TrainState", extra: dict | None = None) -> str:
    """Write ``state`` (+ metadata) to ``path`` (``.pt`` appended if missing).
    With a process group up, rank 0 writes and every rank returns after the
    write: a COLLECTIVE (the ZeRO-1 state's Adam moments and EMAs are
    gathered to rank 0 with ``consolidate_state_dict(to=0)`` and one
    broadcast per rank)."""
    import torch.distributed as dist
    if not path.endswith(SUFFIX):
        path += SUFFIX
    path = os.path.abspath(path)
    distributed = dist.is_initialized()
    if state.owners is not None:
        from ..parallel.sharded_step import gather_emas
        state.opt.consolidate_state_dict(to=0)
        emas = gather_emas(state, range(len(state.ema_params)), to=0)
    else:
        emas = state.ema_params
    if not distributed or dist.get_rank() == 0:
        _write(path, {
            "step": int(state.step),
            "params": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
            "ema_params": [[t.detach().cpu() for t in ema] for ema in emas],
            "ema_betas": list(state.ema_betas),
            "opt_state": state.opt.state_dict(),
            "extra": dict(extra or {}),
        })
    if distributed:
        from ..parallel.distributed import barrier
        barrier()
    return path


def _write(path: str, payload: dict) -> None:
    """``torch.save`` to a temporary file beside ``path``, renamed into place."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tmp-", suffix=SUFFIX)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def read_checkpoint(path: str) -> dict:
    """The payload of the checkpoint at ``path`` (tensors on the CPU), with
    no training state to restore into; ``load_weights`` applies it."""
    return torch.load(path, map_location="cpu", weights_only=False)


@torch.no_grad()
def load_weights(model: torch.nn.Module, payload: dict, ema_index: int = -1) -> None:
    """Load a checkpoint payload's weights into ``model`` in place: the online
    parameters (``ema_index`` -1, the reference's 'model' key) or the EMA copy
    ``ema_index`` (the K EMAs are aligned with ``model.parameters()``)."""
    model.load_state_dict(payload["params"], strict=True)
    if ema_index == -1:
        return
    ema = payload["ema_params"][ema_index]
    params = list(model.parameters())
    if len(ema) != len(params):
        raise ValueError(f"checkpoint EMA holds {len(ema)} tensors, the model {len(params)}")
    for dst, src in zip(params, ema):
        dst.copy_(src)


def restore_checkpoint(path: str, state: "TrainState") -> dict:
    """Load the checkpoint at ``path`` into ``state`` in place (parameters,
    EMAs, Adam state, step); returns its ``extra`` metadata.  Raises when the
    checkpoint does not match the model.  A ZeRO-1 state takes its own
    partition of the Adam moments and the EMAs of the parameters it owns."""
    payload = read_checkpoint(path)
    if len(payload["ema_params"]) != len(state.ema_params):
        raise ValueError(f"checkpoint holds {len(payload['ema_params'])} EMAs, the state "
                         f"{len(state.ema_params)}")
    state.model.load_state_dict(payload["params"], strict=True)
    with torch.no_grad():
        for ema, saved in zip(state.ema_params, payload["ema_params"]):
            if len(ema) != len(saved):
                raise ValueError("checkpoint EMA does not match the model's parameters")
            for dst, src in zip(ema, saved):
                if dst is not None:  # None: another rank's ZeRO-1 part
                    dst.copy_(src)
    state.opt.load_state_dict(payload["opt_state"])
    state.ema_betas = [float(b) for b in payload["ema_betas"]]
    state.step = int(payload["step"])
    return payload.get("extra", {})


def list_checkpoints(ckpt_dir: str) -> list[str]:
    """Checkpoint files under ``ckpt_dir``: numeric names first, in order."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = [os.path.join(ckpt_dir, n) for n in os.listdir(ckpt_dir)
           if n.endswith(SUFFIX) and not n.startswith(".tmp-")]

    def key(p):
        base = os.path.basename(p)[:-len(SUFFIX)]
        return (0, int(base), "") if base.isdigit() else (1, 0, base)
    return sorted(out, key=key)


def _is_numeric(path: str) -> bool:
    return os.path.basename(path)[:-len(SUFFIX)].isdigit()


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The checkpoint a resume should load, or None: the highest numeric
    epoch, unless a non-numeric one (the ``preempt`` save) is strictly newer
    by modification time."""
    ckpts = list_checkpoints(ckpt_dir)
    numeric = [c for c in ckpts if _is_numeric(c)]
    other = [c for c in ckpts if not _is_numeric(c)]
    best_num = numeric[-1] if numeric else None
    best_other = max(other, key=os.path.getmtime) if other else None
    if best_num is None or (best_other is not None
                            and os.path.getmtime(best_other) > os.path.getmtime(best_num)):
        return best_other
    return best_num


def select_checkpoints(ckpt_dir: str, min_epoch: int | None = None,
                       max_epoch: int | None = None,
                       specify_epoch: int | list[int] | None = None,
                       num_ckpts: int | None = None) -> list[str]:
    """Epoch-range / explicit-epoch / count-limited checkpoint selection
    (diffusesg_tpu/utils/checkpoint.py:202-223; reference: arg_parser.py:144-184);
    a non-numeric checkpoint counts as epoch -1."""
    ckpts = list_checkpoints(ckpt_dir)

    def epoch_of(p):
        return int(os.path.basename(p)[:-len(SUFFIX)]) if _is_numeric(p) else -1
    if specify_epoch is not None:
        wanted = [specify_epoch] if isinstance(specify_epoch, int) else list(specify_epoch)
        return [p for p in ckpts if epoch_of(p) in wanted]
    if min_epoch is not None:
        ckpts = [p for p in ckpts if epoch_of(p) >= min_epoch]
    if max_epoch is not None:
        ckpts = [p for p in ckpts if epoch_of(p) <= max_epoch]
    if num_ckpts is not None and len(ckpts) > num_ckpts:
        sel = np.linspace(0, len(ckpts) - 1, num_ckpts).astype(int)
        ckpts = [ckpts[i] for i in sel]
    return ckpts
