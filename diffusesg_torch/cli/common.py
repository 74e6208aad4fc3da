"""Shared CLI argument parsing.

Counterpart of diffusesg_tpu/cli/common.py: the reference's flag names,
YAML + keyword-wise overrides and eval-side config discovery, plus
``--device``.
"""
from __future__ import annotations

import argparse
import logging
import os

from ..config import ConfigDict, load_config


def build_train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="diffusesg_torch training")
    p.add_argument("-c", "--config_file", required=True)
    p.add_argument("-m", "--comment", default="")
    p.add_argument("-l", "--log_level", default="INFO")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: card 0, or cuda:LOCAL_RANK and NCCL under a torchrun "
                        "rendezvous; fails without a card) or cpu (plain versions; gloo)")
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


def build_eval_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="diffusesg_torch evaluation")
    p.add_argument("-p", "--model_path", required=True,
                   help="checkpoint file or run dir containing models_ckpt/")
    p.add_argument("-c", "--config_file", default=None,
                   help="defaults to config.yaml next to the checkpoints")
    p.add_argument("-m", "--comment", default="", help="run-dir name suffix")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: card 0, or cuda:LOCAL_RANK and NCCL under a torchrun "
                        "rendezvous; fails without a card) or cpu (plain versions; gloo)")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--eval_size", type=int, default=None)
    p.add_argument("--num_steps", type=int, default=None)
    p.add_argument("-l", "--log_level", default="INFO")
    p.add_argument("--min_epoch", type=int, default=None)
    p.add_argument("--max_epoch", type=int, default=None)
    p.add_argument("--specify_epoch", type=int, nargs="+", default=None,
                   help="evaluate exactly these epochs")
    p.add_argument("--num_ckpts", type=int, default=None)
    p.add_argument("--ema_weights", nargs="*", default=None,
                   help="EMA beta values to evaluate (default: all)")
    p.add_argument("--use_ema", nargs="*", default="all",
                   help="'all', 'none', or beta values; 1.0 means the raw online weights")
    p.add_argument("--sanity_check", action="store_true")
    p.add_argument("--random_node_num", action="store_true")
    p.add_argument("--inpaint_frac", type=float, default=None,
                   help="conditional completion: pin the first ceil(n_valid * FRAC) nodes "
                        "of every test graph (labels, boxes and the edges among them) to "
                        "ground truth and sample only the remainder")
    p.add_argument("--test_pkl", default=None,
                   help="custom test pickle path (overrides test.test_pkl)")
    p.add_argument("--skip_eval", action="store_true")
    p.add_argument("--data_root", default=".")
    p.add_argument("-o", "--override", action="append", default=[], metavar="KEY=VALUE")
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


def find_eval_config(model_path: str) -> str:
    """config.yaml beside a checkpoint, or one or two directories up
    (reference: arg_parser.py:146-153 reads ../config.yaml)."""
    base = model_path if os.path.isdir(model_path) else os.path.dirname(model_path)
    for c in (os.path.join(base, "config.yaml"), os.path.join(base, "..", "config.yaml"),
              os.path.join(base, "..", "..", "config.yaml")):
        if os.path.isfile(c):
            return os.path.abspath(c)
    raise FileNotFoundError(f"no config.yaml found near {model_path}")
