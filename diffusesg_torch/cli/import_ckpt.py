"""Import a PyTorch reference checkpoint:
python -m diffusesg_torch.cli.import_ckpt <ckpt.pth> -o <out_run_dir> [-c cfg.yaml]

Counterpart of diffusesg_tpu/cli/import_ckpt.py.  Converts a ``.pth``
written by the reference trainer (DiffuseSG/runner/trainer/trainer_utils.py:
168-185: model + per-beta EMA weights + embedded config + epoch) into a port
run directory that ``cli.eval``, ``cli.serve`` and ``cli.train --resume``
read:

    python -m diffusesg_torch.cli.import_ckpt visual_genome_00999.pth -o runs/imported
    python -m diffusesg_torch.cli.serve -p runs/imported

The model config is the checkpoint's embedded config dict; ``-c`` takes a
YAML instead (e.g. to attach a ``tpu:`` block with ``use_pallas_attention``
/ ``compute_dtype`` for the imported weights).  The conversion runs on the
CPU and needs no card.
"""
from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("pth", help="reference checkpoint (.pth)")
    p.add_argument("-o", "--out_dir", required=True,
                   help="run directory to create (config.yaml + models_ckpt/<epoch>.pt)")
    p.add_argument("-c", "--config_file", default=None,
                   help="config YAML overriding the checkpoint-embedded config")
    p.add_argument("--epoch", type=int, default=None,
                   help="override the checkpoint's epoch label")
    return p


def main(argv=None) -> str:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    from ..config import load_config
    from ..utils.torch_import import config_from_ckpt, load_reference_pth, write_imported_run_dir

    ckpt_data = load_reference_pth(args.pth)
    config = load_config(args.config_file) if args.config_file else config_from_ckpt(ckpt_data)
    if args.epoch is not None:
        ckpt_data["epoch"] = args.epoch
    path = write_imported_run_dir(ckpt_data, config, args.out_dir)
    print(path)
    return path


if __name__ == "__main__":
    main()
