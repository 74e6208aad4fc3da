"""Training orchestrator: the epoch loop, on one device or data parallel.

Counterpart of diffusesg_tpu/train/trainer.py: epoch loop over prefetched
batches, epoch-end metric fetch, per-interval test pass on the smallest-beta
EMA, rolling and best checkpoints, loss logging, in-training sampling with
the largest-beta EMA every ``train.sample_interval`` epochs, and a preempt
checkpoint on SIGTERM/SIGINT.  With a process group up it runs the JAX
trainer's multi-process branches: per-rank batches of the rank's shard, the
``shard_map`` or ``gspmd`` step, metrics gathered in rank order, rank 0
alone writing logs and checkpoints, the preempt flag OR-ed over the ranks.
"""
from __future__ import annotations

import logging
import os
import signal
import sys
import time

import numpy as np
import torch

from ..data.loader import Batches, pad_batch, prefetch_to_device
from ..parallel.mesh import (any_rank, current_world, fetch_to_host, is_main_process,
                             per_host_batch_size, resolve_spmd_mode, sync_hosts)
from ..sampling.edm_sampler import TorchNoise
from ..sampling.orchestrator import sg_go_sampling
from ..utils.checkpoint import list_checkpoints, save_checkpoint, wait_for_async_saves
from ..utils.logging_utils import LossTxtLogger, ScalarWriter
from .compiled import CompiledEvalStep, CompiledTrainStep
from .train_state import TrainState, ema_slice
from .train_step import TrainStepConfig, make_eval_step, make_train_step


def _steps(model, state, config, step_cfg, world, noise, compiled: bool = True):
    """(state, train_step, eval_step, noise) of this run, each step compiled
    on a card (train/compiled.py).  One process, or a world of one (a mean
    over one rank is the identity and ZeRO-1 over one rank shards nothing):
    the single-device steps.  Several: those of ``tpu.spmd_mode``;
    ``shard_map`` keeps the state replicated and draws from the rank's
    stream, ``gspmd`` shards Adam and the EMAs and draws the global
    batch's."""
    if world is None or world.size == 1:
        return (state, CompiledTrainStep(make_train_step(model, step_cfg), compiled),
                CompiledEvalStep(make_eval_step(model, step_cfg), compiled), noise)
    from ..parallel.shardmap_dp import make_shardmap_eval_step, make_shardmap_train_step
    from ..parallel.sharded_step import (make_sharded_eval_step, make_sharded_train_step,
                                         shard_train_state)
    mode = resolve_spmd_mode(config, world.size)
    logging.info("data parallel over %d processes, spmd_mode %s", world.size, mode)
    if mode == "shard_map":
        return (state, make_shardmap_train_step(model, step_cfg, world, compiled),
                make_shardmap_eval_step(model, step_cfg, world, compiled),
                noise.fold_in(world.rank))
    return (shard_train_state(state, world),
            make_sharded_train_step(model, step_cfg, world, compiled=compiled),
            make_sharded_eval_step(model, step_cfg, world, compiled=compiled), noise)


def go_training(model, state: TrainState, step_cfg: TrainStepConfig, config, bundle,
                mc_sampler=None, writer: ScalarWriter | None = None, start_epoch: int = 0,
                noise=None, compiled: bool = True):
    """Run the training loop; returns the final TrainState.

    The steps are built from ``step_cfg`` (``train_step_config_from``); on
    a card the training and test steps run as replays of captured CUDA
    graphs (train/compiled.py, the JAX trainer's jitted steps), in every
    mode.  ``compiled=False`` runs them eagerly: the comparison the checks
    make, as the compiled sampler's.
    ``start_epoch`` continues an interrupted run (cli/train.py --resume).
    ``noise`` is the source of the steps' random draws (default: a
    ``TorchNoise`` seeded from ``config.seed`` and ``start_epoch``, so a
    resumed run draws a stream of its own; the same on every rank).

    With a process group up (parallel/distributed.py) the loop is data
    parallel: ``config.train.batch_size`` is the global batch, each rank
    feeds ``per_host_batch_size`` rows of its strided shard, and
    ``tpu.spmd_mode`` picks the step (parallel/mesh.py ``resolve_spmd_mode``;
    a world of one runs the single-device step).  Every rank must call it;
    rank 0 alone writes the loss log and the checkpoints.

    With ``mc_sampler`` set, every ``train.sample_interval`` epochs the
    largest-beta EMA samples the eval set through ``sg_go_sampling`` (epoch
    0 is its ground-truth sanity check); the EMA is applied with
    ``functional_call``, so the model's parameters, Adam's state and the
    training noise stream are left as they were.

    On SIGTERM/SIGINT the loop finishes the current step (one process) or
    the current epoch (several, so that every rank leaves its collectives
    together; any rank's signal stops them all), writes
    ``models_ckpt/preempt.pt`` with the epoch to re-run, and returns.

    ``tpu.async_checkpointing`` (default on, as in the JAX package) writes
    the rolling and best checkpoints in the background while the next epoch
    runs; the preempt checkpoint is written before the return.  On the way
    out the writes in flight are drained: a failed one fails the run, unless
    the loop is already unwinding from another error, which then propagates
    (the failed write is logged).
    """
    device = next(model.parameters()).device
    world = current_world()
    rank, nproc = (0, 1) if world is None else (world.rank, world.size)
    logging.info("training on %s, process %d of %d", device, rank, nproc)
    batch_size = per_host_batch_size(int(config.train.batch_size), nproc)
    if noise is None:
        noise = TorchNoise(int(config.seed) + 1000 + 7919 * start_epoch, device)
    state, train_step, eval_step, noise = _steps(model, state, config, step_cfg, world, noise,
                                                 compiled)
    train_batches = Batches(bundle.train, batch_size, shuffle=True, seed=config.seed,
                            process_index=rank, process_count=nproc)
    test_batches = Batches(bundle.test, batch_size, shuffle=False, process_index=rank,
                           process_count=nproc)

    loss_txt = LossTxtLogger(config.logdir, enabled=is_main_process())
    lowest = {"epoch": -1, "loss": float("inf")}
    save_interval = config.train.save_interval
    sample_interval = config.train.sample_interval
    async_ckpt = bool(config.tpu.get("async_checkpointing", True)) if "tpu" in config else True

    def to_full_batch(item):
        return pad_batch(item[:3], batch_size)[0]

    # flipped by SIGTERM/SIGINT, acted on after the step in flight
    preempt = {"flag": False}

    def on_signal(signum, frame):
        preempt["flag"] = True
        logging.warning("signal %d: will checkpoint and exit after this %s", signum,
                        "step" if nproc == 1 else "epoch")

    old_handlers = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            old_handlers[sig] = signal.signal(sig, on_signal)
    except ValueError:  # not the main thread: no handlers
        old_handlers = {}

    try:
        for epoch in range(start_epoch, config.train.max_epoch):
            train_batches.set_epoch(epoch)
            t0 = time.time()
            # metrics stay on the device and are fetched once at epoch end
            ep_metrics = []
            broke_mid_epoch = False
            for batch in prefetch_to_device(train_batches, device, transform=to_full_batch):
                state, metrics = train_step(state, noise, *batch)
                ep_metrics.append(metrics)
                if preempt["flag"] and nproc == 1:
                    broke_mid_epoch = True
                    break

            fetched = fetch_to_host(ep_metrics, world)
            dt = time.time() - t0
            ep_loss_a = float(np.mean([m["loss_adj"] for m in fetched])) if fetched else 0.0
            ep_loss_x = float(np.mean([m["loss_node"] for m in fetched])) if fetched else 0.0
            for m in fetched:
                loss_txt.write("train", epoch, m["sigmas"], m["loss_adj_per_sample"],
                               m["loss_node_per_sample"])
            logging.info("epoch %05d | train loss adj %.6f node %.6f | %.1fs",
                         epoch, ep_loss_a, ep_loss_x, dt)
            if writer is not None:
                writer.add_scalar("train_epoch/regression_loss_adj", ep_loss_a, epoch)
                writer.add_scalar("train_epoch/regression_loss_node", ep_loss_x, epoch)
                writer.add_scalar("train_epoch/time_s", dt, epoch)

            if any_rank(preempt["flag"], world):
                resume_epoch = epoch - 1 if broke_mid_epoch else epoch
                save_checkpoint(os.path.join(config.model_ckpt_dir, "preempt"), state,
                                extra={"epoch": resume_epoch, "preempted": True})
                logging.warning("preempted: saved models_ckpt/preempt.pt "
                                "(resume re-runs from epoch %d)", resume_epoch + 1)
                return state

            # test pass + checkpointing (reference: trainer_node_adj.py:238-254)
            if epoch % save_interval == save_interval - 1 or epoch == 0:
                test_params = ema_slice(state, 0)  # smallest beta
                test_metrics, real_rows = [], []
                for item in test_batches:
                    arrays, n_real = pad_batch(item[:3], batch_size)
                    batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                                  for a in arrays)
                    test_metrics.append(eval_step(test_params, noise, state.step, *batch))
                    real_rows.append(n_real)

                def trim(v, n_real):
                    """Drop the repeat-pad rows: every rank padded its own
                    tail from n_real rows (the same on every rank, the shards
                    being of one length), and the gather joined the ranks'
                    rows, so the mean covers the dataset once."""
                    return v.reshape((nproc, -1) + v.shape[1:])[:, :n_real].reshape(
                        (-1,) + v.shape[1:])

                sums_a, sums_x, count = 0.0, 0.0, 0
                for t, n_real in zip(fetch_to_host(test_metrics, world), real_rows):
                    la = trim(t["loss_adj_per_sample"], n_real)
                    lx = trim(t["loss_node_per_sample"], n_real)
                    sums_a += float(np.sum(la))
                    sums_x += float(np.sum(lx))
                    count += len(la)
                    loss_txt.write("test", epoch, trim(t["sigmas"], n_real), la, lx)
                te_loss_a, te_loss_x = sums_a / max(count, 1), sums_x / max(count, 1)
                te_loss = te_loss_a + te_loss_x
                logging.info("epoch %05d | test loss %.6f", epoch, te_loss)
                if writer is not None:
                    writer.add_scalar("test_epoch/regression_loss_adj", te_loss_a, epoch)
                    writer.add_scalar("test_epoch/regression_loss_node", te_loss_x, epoch)

                extra = {"epoch": epoch, "test_loss": te_loss}
                save_checkpoint(os.path.join(config.model_ckpt_dir, f"{epoch:05d}"), state, extra,
                                asynchronous=async_ckpt)
                if te_loss < lowest["loss"] and epoch >= min(save_interval,
                                                             config.train.max_epoch - 1):
                    lowest.update(epoch=epoch, loss=te_loss)
                    save_checkpoint(os.path.join(config.model_save_dir, "best"), state, extra,
                                    asynchronous=async_ckpt)
                # a numeric checkpoint of this run supersedes a stale preempt
                # one, once it is finalized: where a preempt file lies, the
                # save just made is waited for, so that it counts
                pre = os.path.join(config.model_ckpt_dir, "preempt.pt")
                if is_main_process() and os.path.exists(pre):
                    wait_for_async_saves()
                if is_main_process() and os.path.exists(pre) and any(
                        os.path.basename(c)[:-3].isdigit()
                        and int(os.path.basename(c)[:-3]) >= start_epoch
                        for c in list_checkpoints(config.model_ckpt_dir)):
                    os.remove(pre)
                    logging.info("dropped superseded preempt checkpoint")
            if world is not None:
                sync_hosts()

            # in-training sampling with the largest-beta EMA
            # (reference: trainer_node_adj.py:262-284)
            if mc_sampler is not None and epoch % sample_interval == 0:
                sampling_params = {
                    "model_nm": f"training_e{epoch:05d}",
                    "weight_kw": f"{state.ema_betas[-1]:.3f}",
                    "model_path": os.path.join(config.model_ckpt_dir, f"{epoch:05d}")}
                sg_go_sampling(model, ema_slice(state, -1), mc_sampler, config, bundle,
                               epoch=epoch, eval_mode=False, sanity_check=epoch == 0,
                               sampling_params=sampling_params, writer=writer)
    finally:
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)
        # read before the try below, whose except clause would see its own error
        unwinding = sys.exc_info()[0] is not None
        try:
            wait_for_async_saves()
        except Exception:
            # on the normal path a failed write fails the run (the checkpoint
            # on disk is not there); during an unwind the original error wins
            if not unwinding:
                loss_txt.close()
                raise
            logging.exception("asynchronous checkpoint write failed during unwind")
        loss_txt.close()
    return state
