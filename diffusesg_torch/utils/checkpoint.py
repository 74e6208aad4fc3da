"""Checkpoints of the full training state, in a torch-native format.

Counterpart of diffusesg_tpu/utils/checkpoint.py (orbax there).  One file per
checkpoint, ``torch.save`` of

    {"step", "params" (state_dict), "ema_params" (K lists aligned with the
     parameters), "ema_betas", "opt_state" (Adam's state_dict, its learning
     rate a number), "extra"}

written to a temporary file in the same directory and renamed into place, so
a reader never sees a partial checkpoint.  A ZeRO-1 state
(parallel/zero.py) is gathered first and rank 0 alone writes, so a
data-parallel checkpoint has the single-device format (a step count per
parameter included) and resumes on one device and the other way round.  Adam's state restores into the
optimizer's own form (train/train_state.py ``load_opt_state``): a card's
capturable Adam resumes on the CPU's plain one and the other way round.

An asynchronous save (``tpu.async_checkpointing``, the JAX package's orbax
async saves) copies the state to host memory, blocking, and returns (so
the next replay of a compiled step, which writes the state in place, comes
after the copy); one background
writer thread does the write and the rename, in the order the saves were
made.  ``wait_for_async_saves`` drains it and raises the first failed
write; ``restore_checkpoint`` and ``read_checkpoint`` wait first, and
``list_checkpoints`` / ``latest_checkpoint`` see only finalized files
(``is_finalized_checkpoint``), never a write in flight.

Layout on disk:
  <run_dir>/models_ckpt/<epoch>.pt   rolling per-interval checkpoints
  <run_dir>/models_ckpt/preempt.pt   written on SIGTERM/SIGINT
  <run_dir>/models/best.pt           best-by-test-loss checkpoint
  <run_dir>/config.yaml              resolved config
"""
from __future__ import annotations

import os
import tempfile
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:  # utils <-> train would import each other at run time
    from ..train.train_state import TrainState

SUFFIX = ".pt"
TMP_PREFIX = ".tmp-"

# the background writer of asynchronous saves, and the writes not yet drained
_writer: ThreadPoolExecutor | None = None
_pending: list[Future] = []
_pending_lock = threading.Lock()


def _to_host(t):
    """A host copy of ``t`` (a tensor, or lists and dicts of them) that no
    later step can change."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=True)
    if isinstance(t, dict):
        return {k: _to_host(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_to_host(v) for v in t)
    return t


def save_checkpoint(path: str, state: "TrainState", extra: dict | None = None,
                    asynchronous: bool = False) -> str:
    """Write ``state`` (+ metadata) to ``path`` (``.pt`` appended if missing).
    With a process group up, rank 0 writes and every rank returns after the
    write (or, asynchronously, once it is queued): a COLLECTIVE (the ZeRO-1
    state's Adam moments and EMAs are gathered from the ranks' ranges, an
    all-gather each; a tensor-parallel state's shards over its model group,
    parallel/tp.py).

    ``asynchronous``: return once the state is copied to host memory; the
    background writer writes it (``wait_for_async_saves`` drains it)."""
    import torch.distributed as dist
    if not path.endswith(SUFFIX):
        path += SUFFIX
    path = os.path.abspath(path)
    distributed = dist.is_initialized()
    payload = _gathered_payload(state, extra)
    if payload is not None:
        payload = _to_host(payload)  # the one copy, for either kind of save
        if asynchronous:
            _submit(path, payload)
        else:
            wait_for_async_saves()  # the files land in the order of the saves
            _write(path, payload)
    if distributed and not asynchronous:
        from ..parallel.distributed import barrier
        barrier()
    return path


def _gathered_payload(state: "TrainState", extra: dict | None) -> dict | None:
    """The checkpoint's payload in the single-device format on the rank
    that writes (None on the others), its tensors where the state holds
    them.  COLLECTIVE with a process group."""
    import torch.distributed as dist

    from ..train.train_state import whole_emas_and_opt
    if state.tp is not None:
        from ..parallel.tp import gather_tp_state
        return gather_tp_state(state, extra)
    emas, opt = whole_emas_and_opt(state)
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    return {
        "step": int(state.step),
        "params": {k: v.detach() for k, v in state.model.state_dict().items()},
        "ema_params": [[t.detach() for t in ema] for ema in emas],
        "ema_betas": list(state.ema_betas),
        "opt_state": opt,
        "extra": dict(extra or {}),
    }


def _submit(path: str, payload: dict) -> None:
    global _writer
    with _pending_lock:
        if _writer is None:
            _writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        _pending.append(_writer.submit(_write, path, payload))


def wait_for_async_saves() -> None:
    """Block until every asynchronous save has been written and renamed
    into place; raises the first failed write's error (each failure is
    raised once)."""
    with _pending_lock:
        pending = list(_pending)
        _pending.clear()
    errors = []
    for fut in pending:
        try:
            fut.result()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
    if errors:
        raise errors[0]


def is_finalized_checkpoint(path: str) -> bool:
    """True when ``path`` is a checkpoint file renamed into place (not a
    write in flight, whose temporary file starts with ``.tmp-``)."""
    base = os.path.basename(path)
    return base.endswith(SUFFIX) and not base.startswith(TMP_PREFIX) and os.path.isfile(path)


def _write(path: str, payload: dict) -> None:
    """``torch.save`` to a temporary file beside ``path``, renamed into place."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=TMP_PREFIX, suffix=SUFFIX)
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
    no training state to restore into; ``load_weights`` applies it.  Waits
    for the asynchronous saves first: ``path`` may still be in flight."""
    wait_for_async_saves()
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
    ranges of the Adam moments and the EMAs.  Waits for the asynchronous
    saves first (``read_checkpoint``)."""
    from ..train.train_state import load_opt_state
    payload = read_checkpoint(path)
    if len(payload["ema_params"]) != len(state.ema_params):
        raise ValueError(f"checkpoint holds {len(payload['ema_params'])} EMAs, the state "
                         f"{len(state.ema_params)}")
    state.model.load_state_dict(payload["params"], strict=True)
    n_params = len(state.params())
    with torch.no_grad():
        for ema, saved in zip(state.ema_params, payload["ema_params"]):
            if len(saved) != n_params:
                raise ValueError("checkpoint EMA does not match the model's parameters")
            if state.zero is not None:
                saved = state.zero.owned(saved)
            for dst, src in zip(ema, saved):
                dst.copy_(src)
    if state.zero is not None:
        state.zero.load_opt_state(state.opt, payload["opt_state"])
    else:
        load_opt_state(state.opt, payload["opt_state"])
    state.ema_betas = [float(b) for b in payload["ema_betas"]]
    state.step = int(payload["step"])
    return payload.get("extra", {})


def list_checkpoints(ckpt_dir: str) -> list[str]:
    """Finalized checkpoint files under ``ckpt_dir``: numeric names first,
    in order."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = [p for p in (os.path.join(ckpt_dir, n) for n in os.listdir(ckpt_dir))
           if is_finalized_checkpoint(p)]

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
