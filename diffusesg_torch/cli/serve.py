"""Serving entry point: python -m diffusesg_torch.cli.serve -p <ckpt-or-run-dir>

Counterpart of diffusesg_tpu/cli/serve.py on one device.  Three modes:

* serve from a checkpoint (default): load the weights (the largest-beta EMA
  unless ``--ema`` says otherwise), warm the sampler up, open the HTTP
  endpoint (``/v1/generate``, ``/v1/complete``, ``/healthz``, ``/v1/stats``);
* ``--export_to DIR``: write the sampler artifact (weights + config, see
  ``serving/export.py``) and exit;
* ``--from_artifact DIR``: serve an artifact; it has no completion
  (``/v1/complete`` answers 501).

Runs on ``cuda`` unless ``--device cpu`` (the plain versions on the CPU).
``--devices`` 0 or 1 serves on one card; more waits for the multi-device
slice of the port.
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("diffusesg-serve")
    p.add_argument("-p", "--model_path", default=None,
                   help="checkpoint file or run dir (with models_ckpt/)")
    p.add_argument("-c", "--config_file", default=None)
    p.add_argument("--from_artifact", default=None,
                   help="serve an artifact dir (serving/export.py) instead of a ckpt")
    p.add_argument("--export_to", default=None,
                   help="export the sampler artifact to this dir and exit")
    p.add_argument("--port", type=int, default=8472)
    p.add_argument("--batch_size", type=int, default=None,
                   help="served batch (default: config test batch)")
    p.add_argument("--devices", type=int, default=0,
                   help="devices to serve on: 0 or 1 = one card; more waits for the "
                        "multi-device slice")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu (plain versions)")
    p.add_argument("--num_steps", type=int, default=None,
                   help="sampling steps (default: config.mcmc.num_steps)")
    p.add_argument("--ema", default=None,
                   help="EMA beta to serve (e.g. 0.9999); 'none' = raw weights;"
                        " default: largest beta (the reference's in-training"
                        " sampling choice, trainer_node_adj.py:262-284)")
    p.add_argument("--data_root", default=None,
                   help="dataset root for label-name lookup (optional)")
    p.add_argument("--linger_ms", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--override", action="append", default=[],
                   help="config override key=value")
    return p


def _check_devices(ndev: int) -> None:
    if ndev > 1:
        raise SystemExit(f"--devices {ndev}: serving on more than one card waits for the "
                         "multi-device slice of the port (torch.distributed); use 0 or 1")


def ema_index(betas, ema: str | None) -> int:
    """``--ema`` -> index into the checkpoint's EMA sets, -1 for the raw
    weights: 'none' the raw weights, a value the nearest beta, by default
    the largest beta (the raw weights when the checkpoint holds no EMA)."""
    betas = np.asarray(betas, dtype=np.float64)
    if ema == "none" or betas.size == 0:
        return -1
    return int(np.argmin(np.abs(betas - float(ema)))) if ema else int(np.argmax(betas))


def _load_from_checkpoint(args, build_fns: bool = True):
    """Load the weights and build the serving functions on ``args.device``.

    Returns (serve_fn, complete_fn, batch, max_node_num, config,
    (num_node_types, num_edge_types), (model, sampler)); the functions are
    the numpy contract of ``serving.export.fixed_batch``, None under
    ``build_fns=False`` (the --export_to path)."""
    from ..config import load_config
    from ..models import make_model
    from ..models.channels import resolve_sampling_channels
    from ..sampling import get_mc_sampler
    from ..serving.export import fixed_batch, make_completion_fn, make_serving_fn
    from ..utils.checkpoint import latest_checkpoint, load_weights, read_checkpoint
    from ..utils.device import resolve_device
    from .common import find_eval_config

    device = resolve_device(args.device)  # fails here when the card is absent
    _check_devices(args.devices)
    config_file = args.config_file or find_eval_config(args.model_path)
    overrides = {}
    if args.num_steps is not None:
        overrides["num_steps"] = args.num_steps
    for item in args.override:
        k, v = item.split("=", 1)
        overrides[k] = v
    config = load_config(config_file, overrides=overrides)

    ckpt_path = args.model_path
    if os.path.isdir(os.path.join(ckpt_path, "models_ckpt")):
        newest = latest_checkpoint(os.path.join(ckpt_path, "models_ckpt"))
        if newest is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_path}")
        ckpt_path = newest
    payload = read_checkpoint(ckpt_path)
    betas = list(payload["ema_betas"])
    idx = ema_index(betas, args.ema)
    model = make_model(config)
    load_weights(model, payload, idx)
    model = model.to(device).eval()
    logging.info("serving %s (ema=%s) on %s", ckpt_path,
                 "raw" if idx == -1 else f"{float(betas[idx]):.4f}", device)

    sampler = get_mc_sampler(config)
    batch = int(args.batch_size or config.test.batch_size or config.train.batch_size)
    n = int(config.dataset.max_node_num)
    serve_fn = complete_fn = None
    if build_fns:
        serve_fn = fixed_batch(make_serving_fn(model, sampler, config), batch, n, device)
        complete_fn = fixed_batch(make_completion_fn(model, sampler, config), batch, n, device)
    info = resolve_sampling_channels(config)
    bounds = (int(info["raw_num_node_type"]),
              int(info["raw_num_adj_type"] if not info["flag_binary_edge"] else 2))
    return serve_fn, complete_fn, batch, n, config, bounds, (model, sampler)


def main(argv=None):
    from ..serving.server import BatchingSampler, serve

    args = build_serve_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")

    idx_to_word = None
    config = None
    complete_fn = None  # artifact mode serves generation only (HTTP 501)
    bounds = (None, None)
    if args.from_artifact:
        from ..serving.export import load_artifact
        _check_devices(args.devices)
        fn, meta = load_artifact(args.from_artifact, device=args.device)
        batch, max_n = int(meta["batch_size"]), int(meta["max_node_num"])
        logging.info("loaded artifact %s (%s)", args.from_artifact, meta)
    else:
        if not args.model_path:
            raise SystemExit("need -p/--model_path or --from_artifact")
        fn, complete_fn, batch, max_n, config, bounds, (model, sampler) = \
            _load_from_checkpoint(args, build_fns=not args.export_to)

    if args.export_to:
        if config is None:
            raise SystemExit("--export_to needs a checkpoint, not an artifact")
        from ..serving.export import export_sampler, save_artifact
        save_artifact(args.export_to, export_sampler(model, sampler, config, batch), config,
                      batch)
        logging.info("exported sampler artifact to %s", args.export_to)
        return

    if args.data_root is not None and config is not None:
        try:
            from ..data import load_data
            bundle = load_data(config, eval_mode=True, data_root=args.data_root)
            idx_to_word = bundle.idx_to_word
        except (OSError, ValueError, KeyError) as e:
            logging.warning("label-name lookup unavailable: %s", e)

    batcher = BatchingSampler(fn, batch, max_n, base_seed=args.seed, linger_ms=args.linger_ms,
                              complete_fn=complete_fn, num_node_types=bounds[0],
                              num_edge_types=bounds[1])
    httpd = None
    try:
        logging.info("warming up (first batch; builds the kernels on first use)...")
        batcher.warmup()
        httpd = serve(batcher, args.port, idx_to_word)
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        batcher.close()


if __name__ == "__main__":
    main()
