"""Shared CLI argument parsing.

Counterpart of diffusesg_tpu/cli/common.py (the training half): the
reference's flag names, YAML + keyword-wise overrides, plus ``--device``.
"""
from __future__ import annotations

import argparse
import logging

from ..config import ConfigDict, load_config


def build_train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="diffusesg_torch training")
    p.add_argument("-c", "--config_file", required=True)
    p.add_argument("-m", "--comment", default="")
    p.add_argument("-l", "--log_level", default="INFO")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu (plain versions)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--dataset_name", default=None)
    p.add_argument("--max_node_num", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--eval_size", type=int, default=None)
    p.add_argument("--lr_init", type=float, default=None)
    p.add_argument("--max_epoch", type=int, default=None)
    p.add_argument("--sample_interval", type=int, default=None)
    p.add_argument("--save_interval", type=int, default=None)
    p.add_argument("--subset", type=int, default=None)
    p.add_argument("--num_steps", type=int, default=None)
    p.add_argument("--node_encoding", default=None)
    p.add_argument("--edge_encoding", default=None)
    p.add_argument("--node_only", action="store_true")
    p.add_argument("--binary_edge", action="store_true")
    p.add_argument("--self_cond", default=None)
    p.add_argument("--iou_loss_type", default=None)
    p.add_argument("--iou_loss_weight", type=float, default=None)
    p.add_argument("--resume", default=None)
    # backbone overrides (a scalar replaces an int key or a one-element list)
    p.add_argument("--feature_dims", type=int, default=None)
    p.add_argument("--window_size", type=int, default=None)
    p.add_argument("--patch_size", type=int, default=None)
    p.add_argument("--data_root", default=".")
    p.add_argument("-o", "--override", action="append", default=[],
                   metavar="KEY=VALUE", help="arbitrary config override")
    return p


_OVERRIDE_KEYS = ["seed", "max_node_num", "eval_size", "lr_init",
                  "max_epoch", "sample_interval", "save_interval", "subset",
                  "num_steps", "node_encoding", "edge_encoding", "self_cond",
                  "iou_loss_type", "iou_loss_weight", "resume"]

_MODEL_OVERRIDE_KEYS = ["feature_dims", "window_size", "patch_size"]


def config_from_args(args, mode: str = "train") -> ConfigDict:
    overrides = {}
    for key in _OVERRIDE_KEYS:
        val = getattr(args, key, None)
        if val is not None:
            overrides[key] = val
    # batch_size lives under both train: and test:; a train-mode flag sets both
    if getattr(args, "batch_size", None) is not None:
        overrides["test.batch_size"] = args.batch_size
        if mode == "train":
            overrides["train.batch_size"] = args.batch_size
    if getattr(args, "dataset_name", None):
        overrides["dataset.name"] = args.dataset_name
    for item in getattr(args, "override", []):
        k, v = item.split("=", 1)
        overrides[k] = v
    cfg = load_config(args.config_file, overrides=overrides)
    for key in _MODEL_OVERRIDE_KEYS:
        val = getattr(args, key, None)
        if val is None:
            continue
        old = cfg.model[key]
        if isinstance(old, list):
            if len(old) != 1:
                raise ValueError(f"--{key} can only replace a single-element list, got {old}")
            val = [val]
        cfg.model[key] = val
        logging.info("config override: model.%s: %r -> %r", key, old, val)
    if getattr(args, "node_only", False):
        cfg.train.node_only = True
    if getattr(args, "binary_edge", False):
        cfg.train.binary_edge = True
    return cfg
