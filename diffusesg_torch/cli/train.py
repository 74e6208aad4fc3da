"""Training entry point: python -m diffusesg_torch.cli.train -c cfg.yaml [...]

Counterpart of diffusesg_tpu/cli/train.py: init basics -> load data -> build
model/optimizer/EMAs -> train, on one CUDA device (``--device cpu`` runs the
plain versions on the CPU).  The config's ``tpu.use_pallas_attention`` picks
the hand-written kernels or the plain versions on the card, as it picks the
Pallas kernels or XLA in the JAX package.  With ``--data_root`` pointing nowhere the
synthetic scene graphs of ``data/synthetic.py`` are used.

Data parallel, one process per card:
``torchrun --nproc_per_node N -m diffusesg_torch.cli.train -c cfg.yaml ...``
(NCCL, each process on ``cuda:LOCAL_RANK``); the same with ``--device cpu``
runs N processes on the CPU over gloo.  ``train.batch_size`` is then the
global batch.
"""
from __future__ import annotations

import logging
import os


def main(argv=None):
    import torch.distributed as dist

    from ..parallel.distributed import maybe_initialize_distributed, shutdown
    from ..utils.device import resolve_device
    from .common import build_train_parser

    args = build_train_parser().parse_args(argv)
    device = resolve_device(args.device)  # fails here when the card is absent
    # the rendezvous first: every later step may be collective; a group this
    # call starts, it also ends
    own_group = not dist.is_initialized() and maybe_initialize_distributed(device)
    try:
        return _train(args, device)
    finally:
        if own_group:
            shutdown()


def _train(args, device):
    from ..data import Batches, load_data
    from ..models import build_model, count_params
    from ..parallel.distributed import load_kernels
    from ..parallel.mesh import current_world, is_main_process, per_host_batch_size
    from ..sampling import get_mc_sampler
    from ..train import (create_train_state, go_training, make_optimizer,
                         train_step_config_from)
    from ..utils.checkpoint import latest_checkpoint, restore_checkpoint
    from ..utils.logging_utils import ScalarWriter, backup_code, set_seed_and_logger
    from .common import config_from_args

    config = config_from_args(args, "train")
    set_seed_and_logger(config, mode="train", comment=args.comment, log_level=args.log_level)
    backup_code(config.logdir)

    bundle = load_data(config, eval_mode=False, data_root=args.data_root)
    model = build_model(config, device=device, seed=config.seed).train()
    logging.info("model parameters: %s; %s in %s (tpu.use_pallas_attention, "
                 "tpu.compute_dtype)", f"{count_params(model):,}",
                 "hand-written kernels" if model.use_kernels else "plain versions", model.dtype)
    world = current_world()
    if world is not None and model.use_kernels and device.type == "cuda":
        load_kernels()

    # the schedule's steps per epoch are the steps the loop runs per epoch on
    # each rank: its shard in per-rank batches (the reference steps its
    # scheduler once per epoch)
    rank, nproc = (0, 1) if world is None else (world.rank, world.size)
    steps_per_epoch = max(1, len(Batches(
        bundle.train, per_host_batch_size(int(config.train.batch_size), nproc),
        process_index=rank, process_count=nproc)))
    optimizer = make_optimizer(config.train.lr_init, config.train.lr_dacey, steps_per_epoch,
                               config.train.weight_decay)
    state = create_train_state(model, list(config.train.ema_coef), optimizer)

    start_epoch = 0
    if config.train.get("resume"):
        resume = config.train.resume
        # a run dir (or its models_ckpt/) resolves to its newest checkpoint,
        # preempt included, and continues that run's epoch numbering
        continue_epochs = False
        for cand in (os.path.join(resume, "models_ckpt"), resume):
            if os.path.isdir(cand):
                newest = latest_checkpoint(cand)
                if newest is not None:
                    resume, continue_epochs = newest, True
                    break
        logging.info("resuming from %s", resume)
        extra = restore_checkpoint(resume, state)
        # an explicit checkpoint path trains max_epoch fresh epochs from the
        # restored state, as the reference does, unless it was a preemption
        if continue_epochs or extra.get("preempted"):
            start_epoch = int(extra.get("epoch", -1)) + 1
            logging.info("continuing at epoch %d", start_epoch)

    writer = ScalarWriter(config.logdir, enabled=is_main_process())
    try:
        state = go_training(model, state, train_step_config_from(config), config, bundle,
                            mc_sampler=get_mc_sampler(config), writer=writer,
                            start_epoch=start_epoch)
    finally:
        writer.close()
    logging.info("training complete")
    return state


if __name__ == "__main__":
    main()
