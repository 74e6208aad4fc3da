"""Checkpoints of the full training state, in a torch-native format.

Counterpart of diffusesg_tpu/utils/checkpoint.py (orbax there).  One file per
checkpoint, ``torch.save`` of

    {"step", "params" (state_dict), "ema_params" (K lists aligned with the
     parameters), "ema_betas", "opt_state" (Adam's state_dict), "extra"}

written to a temporary file in the same directory and renamed into place, so
a reader never sees a partial checkpoint.  Saves are synchronous;
asynchronous saves wait.

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

import torch

if TYPE_CHECKING:  # utils <-> train would import each other at run time
    from ..train.train_state import TrainState

SUFFIX = ".pt"


def save_checkpoint(path: str, state: "TrainState", extra: dict | None = None) -> str:
    """Write ``state`` (+ metadata) to ``path`` (``.pt`` appended if missing)."""
    if not path.endswith(SUFFIX):
        path += SUFFIX
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "step": int(state.step),
        "params": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "ema_params": [[t.detach().cpu() for t in ema] for ema in state.ema_params],
        "ema_betas": list(state.ema_betas),
        "opt_state": state.opt.state_dict(),
        "extra": dict(extra or {}),
    }
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tmp-", suffix=SUFFIX)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return path


def restore_checkpoint(path: str, state: "TrainState") -> dict:
    """Load the checkpoint at ``path`` into ``state`` in place (parameters,
    EMAs, Adam state, step); returns its ``extra`` metadata.  Raises when the
    checkpoint does not match the model."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    if len(payload["ema_params"]) != len(state.ema_params):
        raise ValueError(f"checkpoint holds {len(payload['ema_params'])} EMAs, the state "
                         f"{len(state.ema_params)}")
    state.model.load_state_dict(payload["params"], strict=True)
    with torch.no_grad():
        for ema, saved in zip(state.ema_params, payload["ema_params"]):
            if len(ema) != len(saved):
                raise ValueError("checkpoint EMA does not match the model's parameters")
            for dst, src in zip(ema, saved):
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
