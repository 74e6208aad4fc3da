"""Run-directory setup, seeding, logging and metric writers.

Counterpart of diffusesg_tpu/utils/logging_utils.py for one process: a
timestamped logdir with the resolved config, a log file plus stdout, txt
loss logs, and a JSONL scalar writer (TensorBoard attached when importable).
"""
from __future__ import annotations

import json
import logging
import os
import random
import sys
import time

import numpy as np
import torch

from ..config import save_config


def set_seed_and_logger(config, mode: str = "train", comment: str = "",
                        log_level: str = "INFO") -> str:
    """Seed the host RNGs, create the logdir, attach log handlers; returns
    the logdir and records it (and the checkpoint dirs) in ``config``."""
    seed = int(config.seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    stamp = time.strftime("%b-%d-%H-%M-%S")
    run_name = f"{config.dataset.name}_{mode}_{stamp}" + (f"_{comment}" if comment else "")
    logdir = os.path.join(config.exp_dir, config.exp_name, run_name)
    os.makedirs(logdir, exist_ok=True)
    with config.unlocked():
        config.logdir = logdir
        config.model_ckpt_dir = os.path.join(logdir, "models_ckpt")
        config.model_save_dir = os.path.join(logdir, "models")
    os.makedirs(config.model_ckpt_dir, exist_ok=True)
    os.makedirs(config.model_save_dir, exist_ok=True)

    handlers = [logging.FileHandler(os.path.join(logdir, "process_0.log")),
                logging.StreamHandler(sys.stdout)]
    level = getattr(logging, str(log_level).upper(), logging.INFO)
    logging.basicConfig(level=level, handlers=handlers, force=True,
                        format="%(asctime)s %(levelname)s %(message)s")
    save_config(config, os.path.join(logdir, "config.yaml"))
    return logdir


class ScalarWriter:
    """Epoch/step scalar sink: JSONL always; TensorBoard when importable."""

    def __init__(self, logdir: str, enabled: bool = True):
        self.enabled = enabled
        self.jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a") if enabled else None
        self.tb = None
        if enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(log_dir=os.path.join(logdir, "tensorboard"))
            except Exception:  # tensorboard is optional
                self.tb = None

    def add_scalar(self, tag: str, value: float, step: int):
        if not self.enabled:
            return
        self.jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                     "step": int(step)}) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            self.tb.add_scalar(tag, float(value), int(step))

    def close(self):
        if self.jsonl:
            self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


class LossTxtLogger:
    """Raw per-sample loss text files train_loss.log / test_loss.log."""

    def __init__(self, logdir: str, enabled: bool = True):
        self.enabled = enabled
        if enabled:
            self.f_train = open(os.path.join(logdir, "train_loss.log"), "a")
            self.f_test = open(os.path.join(logdir, "test_loss.log"), "a")

    def write(self, mode: str, epoch: int, sigmas, loss_adj, loss_node):
        if not self.enabled:
            return
        f = self.f_train if mode == "train" else self.f_test
        for s, la, ln in zip(np.asarray(sigmas).ravel(), np.asarray(loss_adj).ravel(),
                             np.asarray(loss_node).ravel()):
            f.write(f"{epoch:05d}\t{s:.6f}\t{la:.6f}\t{ln:.6f}\n")
        f.flush()

    def close(self):
        if self.enabled:
            self.f_train.close()
            self.f_test.close()
