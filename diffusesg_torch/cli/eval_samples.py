"""Offline evaluation of saved samples: recompute all metrics from a
final_samples_array*.npz.

Counterpart of diffusesg_tpu/cli/eval_samples.py, the reference's offline
helper (reference: DiffuseSG/helper/eval_sg_samples.py:230-394): loads the npz dump
written by sg_go_sampling and re-runs the metric suite against the dataset
statistics, without touching the model.  Like the reference it writes the
``eval_sg_helper_plots/`` directory next to the npz: BLT perceptual-IoU
histograms (eval_sg_samples.py:50-66), retrieval panels for every F1
weighting incl. node-type-agnostic (:345-360), and an ``eval_metrics.txt``
summary (:366-392).  ``--train_set`` additionally scores the FULL training
set's layouts as a BLT reference point (:45-48).  Like every entry point of the port it asks for
``cuda`` unless ``--device cpu`` is given, though the metrics themselves
run on the host (numpy).  The plots are skipped with a warning where
matplotlib is absent.
"""
from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np


def main(argv=None):
    from ..config import load_config
    from ..data import load_data
    from ..eval import SceneGraphEvaluator
    from ..models.channels import dataset_constants
    from ..sampling.orchestrator import evaluate_samples, xyxy_in_unit
    from ..utils.device import resolve_device

    p = argparse.ArgumentParser(description="diffusesg_torch offline sample evaluation")
    p.add_argument("--npz", required=True)
    p.add_argument("-c", "--config_file", required=True)
    p.add_argument("--train_set", action="store_true",
                   help="also score the full training set's layouts as a BLT "
                        "reference point (reference: eval_sg_samples.py:26)")
    p.add_argument("--data_root", default=".")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--out", default=None, help="optional JSON output path")
    args = p.parse_args(argv)
    resolve_device(args.device)

    logging.basicConfig(level=logging.INFO)
    config = load_config(args.config_file)
    bundle = load_data(config, eval_mode=True, data_root=args.data_root)
    data = np.load(args.npz, allow_pickle=True)
    num_node_type, num_edge_type, _ = dataset_constants(config.dataset.name)

    # adapt the npz schema to the orchestrator's result dict and reuse its
    # metric block verbatim (single source of truth for the metric suite)
    res = {"q_adj": data["samples_a"], "q_adj_gt": data["gt_a"],
           "flags": data["samples_node_flags"],
           "flags_gt": data["gt_node_flags"]}
    if "samples_x" in data:
        res.update(q_node=data["samples_x"], q_node_gt=data["gt_x"])
    flag_bbox = "samples_x_bbox" in data and data["samples_x_bbox"].ndim == 3
    if flag_bbox:
        res.update(bbox=data["samples_x_bbox"], bbox_gt=data["gt_x_bbox"])
    flag_node_only = bool(config.train.get("node_only", False))
    flag_binary_edge = bool(config.train.get("binary_edge", False))
    metrics = evaluate_samples(res, config, bundle, num_node_type,
                               num_edge_type, flag_node_only,
                               flag_binary_edge, flag_bbox, skip_eval=False)

    plot_dir = os.path.join(os.path.dirname(os.path.abspath(args.npz)),
                            "eval_sg_helper_plots")
    os.makedirs(plot_dir, exist_ok=True)

    if flag_bbox:
        ev = SceneGraphEvaluator()
        pred_bbox = xyxy_in_unit(res["bbox"])
        gt_bbox = xyxy_in_unit(res["bbox_gt"])
        percp = {"pred": ev.compute_bbox_ioa(pred_bbox, res["flags"],
                                             canvas_size=32,
                                             flag_perceptual_iou=True),
                 "gt": ev.compute_bbox_ioa(gt_bbox, res["flags_gt"],
                                           canvas_size=32,
                                           flag_perceptual_iou=True)}
        if args.train_set:
            # the FULL training set's layouts as a reference distribution
            # (reference: eval_sg_samples.py:45-48); bundle bboxes are the
            # dataset pipeline's [-1,1] cxcywh slice (data/dataset.py)
            full_bbox = (np.asarray(bundle.train.nodes[..., -4:]) + 1.0) / 2.0
            full_bbox = xyxy_in_unit(full_bbox.astype(np.float32))
            full_flags = np.asarray(bundle.train.node_flags, bool)
            percp["full_gt"] = ev.compute_bbox_ioa(full_bbox, full_flags,
                                                   canvas_size=32,
                                                   flag_perceptual_iou=True)
            metrics["full_gt_iou_percp_blt"] = float(np.mean(percp["full_gt"]))
            logging.info("BLT perceptual IoU full_gt: %.4f",
                         metrics["full_gt_iou_percp_blt"])
        _plot_percp_hist(percp, plot_dir)

        # retrieval panels per F1 weighting (reference: :345-360)
        if metrics.get("_mat_f1") and "q_node" in res:
            try:
                from ..utils.visual import plot_scene_graph_bbox
                for name, mat in metrics["_mat_f1"].items():
                    plot_scene_graph_bbox(
                        res["q_node"], res["bbox"], res["q_adj"],
                        res["q_node_gt"], res["bbox_gt"], res["q_adj_gt"],
                        mat, res["flags"], res["flags_gt"],
                        bundle.idx_to_word, save_dir=plot_dir,
                        title=f"bbox_{name}_{config.dataset.name}.png",
                        num_plots=10)
            except Exception as e:  # plotting must never kill an eval
                logging.warning("retrieval panels failed: %s", e)

    scalars = {k: v for k, v in metrics.items() if not k.startswith("_")}
    _write_metrics_txt(os.path.join(plot_dir, "eval_metrics.txt"),
                       args.npz, scalars)
    for k, v in scalars.items():
        logging.info("%s = %s", k, v)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(scalars, f, indent=2, default=float)
    return scalars


def _plot_percp_hist(percp: dict, plot_dir: str) -> None:
    """Perceptual-IoU distribution histogram
    (reference: eval_sg_samples.py:50-66)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        for label, vals in percp.items():
            ax.hist(vals, bins=100, alpha=0.5, label=label)
        ax.set_xlabel("perceptual iou")
        ax.set_ylabel("frequency")
        means = ", ".join(f"{k}: {np.mean(v):.4f}" for k, v in percp.items())
        ax.set_title(f"Mean: {means}. Canvas size: 32")
        ax.legend()
        fig.savefig(os.path.join(plot_dir, "blt_perceptual_iou_hist.png"),
                    dpi=120)
        plt.close(fig)
    except Exception as e:
        logging.warning("BLT histogram failed: %s", e)


def _write_metrics_txt(path: str, npz_path: str, scalars: dict) -> None:
    """Key-metric text report (reference: eval_sg_samples.py:366-392)."""
    with open(path, "w") as f:
        f.write("Evaluation metrics for the generated samples stored at "
                f"{npz_path}\n")
        for k, v in scalars.items():
            f.write(f"{k}: {v}\n")


if __name__ == "__main__":
    main()
