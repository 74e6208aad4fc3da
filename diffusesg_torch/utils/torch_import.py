"""Import a PyTorch reference checkpoint into a port run directory.

The reference saves ``{'model': state_dict, 'config': dict, 'epoch',
'train_loss', 'test_loss', 'model_ema_beta_{beta:.4f}': state_dict x K}``
(reference: DiffuseSG/runner/trainer/trainer_utils.py:168-185), where the
state dicts belong to ``NodeAdjPrecond``: the denoiser's weights under a
``model.`` prefix, and ``module.`` before it under DDP / DP training
(reference: utils/sampling_utils.py:34-60).

Counterpart of diffusesg_tpu/utils/torch_import.py:152-309.  The port's
modules use the reference's parameter names, so no name mapping is needed:
the prefixes are stripped, the buffers the reference saves and the port
rebuilds at construction (``relative_position_index``, ``attn_mask``) are
dropped, and every set loads with ``load_state_dict(strict=True)`` into a
model built from the config.  The run directory is ``config.yaml`` +
``models_ckpt/<epoch>.pt`` in ``utils/checkpoint.py``'s format (the K EMAs
beta-ascending, aligned with ``model.parameters()``; a fresh Adam state),
which ``cli.eval -p``, ``cli.serve -p`` and ``cli.train --resume`` read:

    python -m diffusesg_torch.cli.import_ckpt visual_genome_00999.pth -o runs/imported
"""
from __future__ import annotations

import logging
import os
import re

import torch

# buffers of the reference's state dict that the port keeps non-persistent
_DROPPED = ("relative_position_index", "attn_mask")
_EMA_KEY = re.compile(r"^model_ema_beta_([0-9.]+)$")


def denoiser_state_dict(sd: dict) -> dict:
    """Strip the DDP ``module.`` and precond-wrapper ``model.`` prefixes down
    to raw DiffuseSG keys, and drop the rebuilt buffers.  A state dict
    already at denoiser level (carrying ``patch_embed.proj.weight``) keeps
    its keys."""
    for prefix in ("module.", "model."):
        if "patch_embed.proj.weight" in sd:
            break
        stripped = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        if stripped:
            sd = stripped
    if "patch_embed.proj.weight" not in sd:
        raise ValueError("state dict does not look like a DiffuseSG denoiser (no "
                         f"patch_embed.proj.weight); keys start with {sorted(sd)[:3]}")
    return {k: v for k, v in sd.items() if k.rsplit(".", 1)[-1] not in _DROPPED}


def ema_items(ckpt_data: dict) -> list[tuple[float, dict]]:
    """(beta, state_dict) pairs of the reference checkpoint, beta-ascending
    (the reference builds its EMA list over sorted(ema_coef),
    learning_utils.py:158-161)."""
    out = [(float(m.group(1)), val) for key, val in ckpt_data.items()
           if (m := _EMA_KEY.match(key))]
    return sorted(out, key=lambda kv: kv[0])


def config_from_ckpt(ckpt_data: dict):
    """Locked ConfigDict from the dict the reference embeds in every
    checkpoint (trainer_utils.py:172-175); flag_sg derived where absent
    (arg_parser.py:275-283)."""
    from ..config import ConfigDict

    cfg = ConfigDict(dict(ckpt_data["config"]))
    if "flag_sg" not in cfg:
        cfg.flag_sg = any(n in cfg.dataset.name for n in ("visual_genome", "coco_stuff"))
    return cfg.lock()


def import_reference_checkpoint(ckpt_data: dict, config):
    """Reference ``.pth`` payload -> (TrainState, extra): a CPU model built
    from ``config`` holding the raw weights, the K EMA sets beta-ascending,
    a fresh Adam state, step 0.  A state dict that does not match the model
    raises (``load_state_dict(strict=True)`` names the missing and unexpected
    keys)."""
    from ..models import make_model
    from ..train import create_train_state, make_optimizer

    model = make_model(config)
    emas = ema_items(ckpt_data)
    ema_params = []
    for _beta, sd in emas:
        model.load_state_dict(denoiser_state_dict(sd), strict=True)
        ema_params.append([p.detach().clone() for p in model.parameters()])
    model.load_state_dict(denoiser_state_dict(ckpt_data["model"]), strict=True)
    optimizer = make_optimizer(config.train.lr_init, config.train.lr_dacey, steps_per_epoch=1,
                               weight_decay=config.train.weight_decay)
    state = create_train_state(model, [b for b, _ in emas], optimizer)
    state.ema_params = ema_params
    extra = {"epoch": int(ckpt_data.get("epoch", 0) or 0), "imported_from_torch": 1}
    for k in ("train_loss", "test_loss"):
        if ckpt_data.get(k) is not None:
            extra[k] = float(ckpt_data[k])
    return state, extra


def write_imported_run_dir(ckpt_data: dict, config, out_dir: str) -> str:
    """Write ``<out_dir>/config.yaml`` and ``<out_dir>/models_ckpt/<epoch>.pt``;
    returns the checkpoint's path."""
    from ..config import save_config
    from .checkpoint import save_checkpoint

    state, extra = import_reference_checkpoint(ckpt_data, config)
    os.makedirs(out_dir, exist_ok=True)
    save_config(config, os.path.join(out_dir, "config.yaml"))
    path = save_checkpoint(os.path.join(out_dir, "models_ckpt", f"{extra['epoch']:05d}"),
                           state, extra)
    logging.info("imported reference checkpoint -> %s (epoch %d, %d EMA sets)", path,
                 extra["epoch"], len(state.ema_betas))
    return path


def load_reference_pth(path: str) -> dict:
    """torch.load a reference checkpoint on the CPU, unrestricted as the
    reference's own torch.load is (eval.py:49): the file is trusted user
    input."""
    return torch.load(path, map_location="cpu", weights_only=False)
