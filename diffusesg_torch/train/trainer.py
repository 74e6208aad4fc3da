"""Training orchestrator: the epoch loop, on one device.

Counterpart of diffusesg_tpu/train/trainer.py: epoch loop over prefetched
batches, epoch-end metric fetch, per-interval test pass on the smallest-beta
EMA, rolling and best checkpoints, loss logging, in-training sampling with
the largest-beta EMA every ``train.sample_interval`` epochs, and a preempt
checkpoint on SIGTERM/SIGINT.
"""
from __future__ import annotations

import logging
import os
import signal
import time

import numpy as np
import torch

from ..data.loader import Batches, pad_batch, prefetch_to_device
from ..sampling.edm_sampler import TorchNoise
from ..sampling.orchestrator import sg_go_sampling
from ..utils.checkpoint import list_checkpoints, save_checkpoint
from ..utils.logging_utils import LossTxtLogger, ScalarWriter
from .train_state import TrainState, ema_slice


def _fetch(metrics: list[dict]) -> list[dict]:
    """Device metrics of many steps -> numpy, in one blocking pass."""
    return [{k: v.float().cpu().numpy() for k, v in m.items()} for m in metrics]


def go_training(model, state: TrainState, train_step, eval_step, config, bundle,
                mc_sampler=None, writer: ScalarWriter | None = None, start_epoch: int = 0,
                noise=None):
    """Run the training loop; returns the final TrainState.

    ``start_epoch`` continues an interrupted run (cli/train.py --resume).
    ``noise`` is the source of the steps' random draws (default: a
    ``TorchNoise`` seeded from ``config.seed`` and ``start_epoch``, so a
    resumed run draws a stream of its own).

    With ``mc_sampler`` set, every ``train.sample_interval`` epochs the
    largest-beta EMA samples the eval set through ``sg_go_sampling`` (epoch
    0 is its ground-truth sanity check); the EMA is applied with
    ``functional_call``, so the model's parameters, Adam's state and the
    training noise stream are left as they were.

    On SIGTERM/SIGINT the loop finishes the current step, writes
    ``models_ckpt/preempt.pt`` with the epoch to re-run, and returns.
    """
    device = next(model.parameters()).device
    logging.info("training on %s", device)
    batch_size = int(config.train.batch_size)
    train_batches = Batches(bundle.train, batch_size, shuffle=True, seed=config.seed)
    test_batches = Batches(bundle.test, batch_size, shuffle=False)
    if noise is None:
        noise = TorchNoise(int(config.seed) + 1000 + 7919 * start_epoch, device)

    loss_txt = LossTxtLogger(config.logdir)
    lowest = {"epoch": -1, "loss": float("inf")}
    save_interval = config.train.save_interval
    sample_interval = config.train.sample_interval

    def to_full_batch(item):
        return pad_batch(item[:3], batch_size)[0]

    # flipped by SIGTERM/SIGINT, acted on after the step in flight
    preempt = {"flag": False}

    def on_signal(signum, frame):
        preempt["flag"] = True
        logging.warning("signal %d: will checkpoint and exit after this step", signum)

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
                if preempt["flag"]:
                    broke_mid_epoch = True
                    break

            fetched = _fetch(ep_metrics)
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

            if preempt["flag"]:
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
                sums_a, sums_x, count = 0.0, 0.0, 0
                for t, n_real in zip(_fetch(test_metrics), real_rows):
                    # the repeat-pad rows are dropped: the mean covers the dataset once
                    la = t["loss_adj_per_sample"][:n_real]
                    lx = t["loss_node_per_sample"][:n_real]
                    sums_a += float(np.sum(la))
                    sums_x += float(np.sum(lx))
                    count += len(la)
                    loss_txt.write("test", epoch, t["sigmas"][:n_real], la, lx)
                te_loss_a, te_loss_x = sums_a / max(count, 1), sums_x / max(count, 1)
                te_loss = te_loss_a + te_loss_x
                logging.info("epoch %05d | test loss %.6f", epoch, te_loss)
                if writer is not None:
                    writer.add_scalar("test_epoch/regression_loss_adj", te_loss_a, epoch)
                    writer.add_scalar("test_epoch/regression_loss_node", te_loss_x, epoch)

                extra = {"epoch": epoch, "test_loss": te_loss}
                save_checkpoint(os.path.join(config.model_ckpt_dir, f"{epoch:05d}"), state, extra)
                if te_loss < lowest["loss"] and epoch >= min(save_interval,
                                                             config.train.max_epoch - 1):
                    lowest.update(epoch=epoch, loss=te_loss)
                    save_checkpoint(os.path.join(config.model_save_dir, "best"), state, extra)
                # a numeric checkpoint of this run supersedes a stale preempt one
                pre = os.path.join(config.model_ckpt_dir, "preempt.pt")
                if os.path.exists(pre) and any(
                        os.path.basename(c)[:-3].isdigit()
                        and int(os.path.basename(c)[:-3]) >= start_epoch
                        for c in list_checkpoints(config.model_ckpt_dir)):
                    os.remove(pre)
                    logging.info("dropped superseded preempt checkpoint")

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
        loss_txt.close()
    return state
