"""Evaluation entry point: python -m diffusesg_torch.cli.eval -p <ckpt-or-run-dir>

Counterpart of diffusesg_tpu/cli/eval.py (reference: DiffuseSG/eval.py:80-101):
find the checkpoints, and for each (checkpoint x EMA weight) sample, decode
and score the test set, appending rows to eval_results.csv.  Runs on
``cuda`` unless ``--device cpu`` (the plain versions on the CPU).  Under
``torchrun`` each process samples its shard of the eval set and rank 0
alone scores and writes.
"""
from __future__ import annotations

import logging
import os

import numpy as np


def select_ema_indices(betas, use_ema, ema_weights=None) -> list[int]:
    """Map --use_ema / --ema_weights to EMA-stack indices; -1 is the raw
    online weights (the reference's 'model' key, beta "1.0").  'all'
    evaluates raw + every EMA, 'none' raw only, a list of values exactly
    those betas (reference: eval.py:15-40)."""
    betas = np.asarray(betas)
    if isinstance(use_ema, str):
        use_ema = [use_ema]

    def beta_idx(w: float) -> int:
        i = int(np.argmin(np.abs(betas - w)))
        if not np.isclose(float(betas[i]), w):
            raise ValueError(f"EMA beta {w} not found in checkpoint betas {betas}")
        return i

    if ema_weights:
        return [beta_idx(float(w)) for w in ema_weights]
    if not use_ema or use_ema == ["none"]:
        return [-1]
    if use_ema == ["all"]:
        return [-1] + list(range(len(betas)))
    wanted = [float(w) for w in use_ema]
    return ([-1] if 1.0 in wanted else []) + [beta_idx(w) for w in wanted if w != 1.0]


def main(argv=None) -> list[dict]:
    import torch.distributed as dist

    from ..parallel.distributed import maybe_initialize_distributed, shutdown
    from ..utils.device import resolve_device
    from .common import build_eval_parser

    args = build_eval_parser().parse_args(argv)
    device = resolve_device(args.device)  # fails here when the card is absent
    # the rendezvous first; a group this call starts, it also ends
    own_group = not dist.is_initialized() and maybe_initialize_distributed(device)
    try:
        return _evaluate(args, device)
    finally:
        if own_group:
            shutdown()


def _evaluate(args, device) -> list[dict]:
    from ..config import load_config
    from ..data import load_data
    from ..models import build_model
    from ..parallel.distributed import load_kernels
    from ..parallel.mesh import current_world, is_main_process, sync_hosts
    from ..sampling import get_mc_sampler
    from ..sampling.orchestrator import sg_go_sampling
    from ..utils.checkpoint import load_weights, read_checkpoint, select_checkpoints
    from ..utils.logging_utils import ScalarWriter, backup_code, set_seed_and_logger
    from .common import find_eval_config

    config_file = args.config_file or find_eval_config(args.model_path)
    overrides = {}
    if args.batch_size is not None:
        overrides["test.batch_size"] = args.batch_size
    if args.eval_size is not None:
        overrides["eval_size"] = args.eval_size
    if args.num_steps is not None:
        overrides["num_steps"] = args.num_steps
    for item in args.override:
        k, v = item.split("=", 1)
        overrides[k] = v
    config = load_config(config_file, overrides=overrides)
    if args.test_pkl:
        with config.unlocked():
            config.test.test_pkl = args.test_pkl
    set_seed_and_logger(config, mode="eval", comment=args.comment, log_level=args.log_level)
    backup_code(config.logdir)  # the reference backs up the code on eval too (eval.py:86)

    bundle = load_data(config, eval_mode=True, data_root=args.data_root)
    model = build_model(config, device=device, seed=config.seed).eval()
    if current_world() is not None and model.use_kernels and device.type == "cuda":
        load_kernels()
    mc_sampler = get_mc_sampler(config)
    writer = ScalarWriter(config.logdir, enabled=is_main_process())

    # checkpoint discovery (reference: arg_parser.py:144-184)
    if os.path.isdir(os.path.join(args.model_path, "models_ckpt")):
        ckpts = select_checkpoints(os.path.join(args.model_path, "models_ckpt"),
                                   args.min_epoch, args.max_epoch, args.specify_epoch,
                                   args.num_ckpts)
    else:
        ckpts = [args.model_path]
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints found under {args.model_path}")
    logging.info("evaluating %d checkpoint(s) on %s", len(ckpts), device)

    results = []
    try:
        for ckpt_path in ckpts:
            payload = read_checkpoint(ckpt_path)
            betas = np.asarray(payload["ema_betas"])
            for idx in select_ema_indices(betas, args.use_ema, args.ema_weights):
                load_weights(model, payload, idx)
                kw = "1.000" if idx == -1 else f"{float(betas[idx]):.4f}"
                model_nm = os.path.basename(ckpt_path.rstrip("/"))
                if args.inpaint_frac is not None:
                    # conditional-completion rows, without changing the csv's columns
                    model_nm += f"_inpaint{args.inpaint_frac:g}"
                sampling_params = {"model_nm": model_nm, "weight_kw": kw,
                                   "model_path": ckpt_path}
                logging.info("eval ckpt=%s ema=%s", ckpt_path, kw)
                metrics = sg_go_sampling(
                    model, None, mc_sampler, config, bundle,
                    epoch=int(payload.get("extra", {}).get("epoch", 0) or 0), eval_mode=True,
                    sanity_check=args.sanity_check, sampling_params=sampling_params,
                    writer=writer, skip_eval=args.skip_eval,
                    random_node_num=args.random_node_num, inpaint_frac=args.inpaint_frac)
                if is_main_process():
                    results.append(metrics)
                sync_hosts()
    finally:
        writer.close()
    logging.info("evaluation complete")
    return results


if __name__ == "__main__":
    main()
