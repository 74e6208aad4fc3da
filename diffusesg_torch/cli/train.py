"""Training entry point: python -m diffusesg_torch.cli.train -c cfg.yaml [...]

Counterpart of diffusesg_tpu/cli/train.py: init basics -> load data -> build
model/optimizer/EMAs -> train, on one CUDA device (``--device cpu`` runs the
plain versions on the CPU).  With ``--data_root`` pointing nowhere the
synthetic scene graphs of ``data/synthetic.py`` are used.
"""
from __future__ import annotations

import logging
import os


def main(argv=None):
    from ..data import Batches, load_data
    from ..models import build_model, count_params
    from ..train import (create_train_state, go_training, make_eval_step, make_optimizer,
                         make_train_step, train_step_config_from)
    from ..utils.checkpoint import latest_checkpoint, restore_checkpoint
    from ..utils.device import resolve_device
    from ..utils.logging_utils import ScalarWriter, set_seed_and_logger
    from .common import build_train_parser, config_from_args

    args = build_train_parser().parse_args(argv)
    device = resolve_device(args.device)  # fails here when the card is absent
    config = config_from_args(args, "train")
    set_seed_and_logger(config, mode="train", comment=args.comment, log_level=args.log_level)

    bundle = load_data(config, eval_mode=False, data_root=args.data_root)
    model = build_model(config, device=device, seed=config.seed).train()
    logging.info("model parameters: %s", f"{count_params(model):,}")

    # the schedule's steps per epoch are the steps the loop runs per epoch
    # (the reference steps its scheduler once per epoch)
    steps_per_epoch = max(1, len(Batches(bundle.train, int(config.train.batch_size))))
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

    step_cfg = train_step_config_from(config)
    train_step = make_train_step(model, step_cfg)
    eval_step = make_eval_step(model, step_cfg)
    logging.info("in-training sampling is off: it needs the sampling orchestrator, "
                 "which the port does not have yet")
    writer = ScalarWriter(config.logdir)
    try:
        state = go_training(model, state, train_step, eval_step, config, bundle,
                            mc_sampler=None, writer=writer, start_epoch=start_epoch)
    finally:
        writer.close()
    logging.info("training complete")
    return state


if __name__ == "__main__":
    main()
