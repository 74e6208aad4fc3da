"""Sampling + evaluation orchestrator, on one device or data parallel.

Counterpart of diffusesg_tpu/sampling/orchestrator.py (the reference's
sg_go_sampling, DiffuseSG/runner/sampler/sampler_node_adj.py:24-723): draws
samples with the EDM sampler (plain, the ground-truth sanity check, or
inpainting), decodes them to integer scene graphs on the sampling device,
moves each batch's decoded tensors to the host once, computes the metric
suite on numpy, and writes the npz / csv / txt artifacts with the JAX
package's keys and columns.  With several processes each samples its
strided shard of the eval set from a stream of its own, the results are
gathered in rank order and trimmed of the shards' wrap-padding, and rank 0
alone computes the metrics and writes.
"""
from __future__ import annotations

import csv
import logging
import math
import os
import time
from functools import partial

import numpy as np
import torch
from torch.func import functional_call

from ..data.loader import shard_for_process, split_eval_set
from ..eval import SceneGraphEvaluator
from ..models.channels import resolve_sampling_channels
from ..models.precond import precond_forward
from ..ops.box_ops import box_cxcywh_to_xyxy
from ..parallel.mesh import current_world, gather_to_host, is_main_process, sync_hosts
from .compiled import CompiledSampler
from .decode import decode_samples
from .edm_sampler import NodeAdjEDMSampler, TorchNoise


def make_sample_fn(model, params, sampler: NodeAdjEDMSampler, num_node_chan: int,
                   num_edge_chan: int, sanity_check: bool = False, precond: str = "edm",
                   num_interim: int = 0, inpaint: bool = False, compiled: bool = True):
    """(noise, node_flags[, gt_a, gt_x[, mask_a, mask_x]]) -> the sampler's
    outputs (orchestrator.py:105-137).

    ``params`` is None for the model's own parameters, or a name -> tensor
    dict (an EMA copy) applied with ``torch.func.functional_call``, which
    leaves the model's parameters untouched.  ``sanity_check`` takes
    (noise, node_flags, gt_a, gt_x) and denoises to the ground truth
    (reference: edm.py:375-377); ``inpaint`` takes (noise, node_flags, gt_a,
    gt_x, mask_a, mask_x) and carries the masked-true entries of the ground
    truth through the reverse diffusion.

    On a card the sampler runs compiled (``sampling/compiled.py``) unless
    ``compiled=False``, with the same output.  Its graphs read the
    parameters (the model's, or ``params``' tensors) where they lay at
    capture: they must stay in place while this function is used, as they
    do through one ``sg_go_sampling``, which builds its own."""
    def net(*args):
        return model(*args) if params is None else functional_call(model, params, args)

    def denoiser_for(node_flags):
        def denoiser(a, x, sigmas, sc_a, sc_x):
            return precond_forward(net, precond, a, x, node_flags, sigmas, sc_a, sc_x)
        return denoiser

    def gt_denoiser_for(node_flags, gt_a, gt_x):
        def gt_denoiser(a, x, sigmas, sc_a, sc_x):
            return gt_a.float(), gt_x.float()
        return gt_denoiser

    run = partial(CompiledSampler(sampler, compiled).sample, num_node_chan=num_node_chan,
                  num_edge_chan=num_edge_chan, num_interim=num_interim)
    if sanity_check:
        def sample_fn(noise, node_flags, gt_a, gt_x):
            return run(gt_denoiser_for, node_flags, noise=noise, operands=(gt_a, gt_x))
    elif inpaint:
        def sample_fn(noise, node_flags, gt_a, gt_x, mask_a, mask_x):
            return run(denoiser_for, node_flags, noise=noise,
                       inpaint=dict(gt_adjs=gt_a, gt_nodes=gt_x, mask_adjs=mask_a,
                                    mask_nodes=mask_x))
    else:
        def sample_fn(noise, node_flags):
            return run(denoiser_for, node_flags, noise=noise)
    return sample_fn


def resample_node_flags(flags: np.ndarray, num_nodes_pool, seed: int) -> np.ndarray:
    """Resample per-slot node counts from the test set's empirical node-count
    distribution (reference: sampler_node_adj.py:146-154); slots fill front
    to back, so every mask stays non-empty."""
    rs = np.random.RandomState(seed)
    counts = rs.choice(num_nodes_pool, size=len(flags))
    sample_flags = np.zeros_like(flags)
    for i, c in enumerate(counts):
        sample_flags[i, :c] = True
    return sample_flags


def inpaint_masks(flags: np.ndarray, inpaint_frac: float):
    """The known entries of conditional completion: the first
    ceil(n_valid * frac) valid nodes of each graph (data is front-packed)
    and the edges among them; ([B, N, N], [B, N]) bool."""
    known = (np.arange(flags.shape[1])[None, :]
             < np.ceil(flags.sum(1) * inpaint_frac)[:, None])
    known &= flags.astype(bool)
    return known[:, :, None] & known[:, None, :], known


# the outputs with one row per sampled graph (the interim snapshots keep a
# capped slice of each batch instead)
PER_SAMPLE = ("raw_a", "raw_x", "q_adj", "q_adj_gt", "q_node", "q_node_gt", "flags",
              "flags_gt", "bbox", "bbox_gt", "image_ids")


def process_padding_keep(total: int, n_proc: int) -> np.ndarray:
    """Rows of the rank-order gather of ``shard_for_process``'s shards that
    are real, not wrap-padding: rank p contributed ceil(total / n_proc) rows
    of which the first total // n_proc (+1 for the first total % n_proc
    ranks) are real (diffusesg_tpu/sampling/orchestrator.py:399-405)."""
    k_per = -(-total // n_proc)
    return np.concatenate([
        np.arange(p * k_per, p * k_per + total // n_proc + (1 if p < total % n_proc else 0))
        for p in range(n_proc)])


def trim_process_padding(res: dict, total: int, n_proc: int) -> dict:
    """The gathered per-sample outputs without the wrap-padding and in the
    eval set's order (row j of rank p's shard is eval row p + j * n_proc), so
    a data-parallel pass returns, row for row, what one process returns."""
    keep = process_padding_keep(total, n_proc)
    k_per = -(-total // n_proc)
    rows = keep[np.argsort(keep // k_per + (keep % k_per) * n_proc)]
    return {k: (v[rows] if k in PER_SAMPLE else v) for k, v in res.items()}


def sg_go_sampling(model, params, mc_sampler: NodeAdjEDMSampler, config, bundle,
                   epoch: int = 0, eval_mode: bool = False, sanity_check: bool = False,
                   sampling_params: dict | None = None, writer=None,
                   skip_eval: bool = False, random_node_num: bool = False,
                   noise_factory=None, inpaint_frac: float | None = None,
                   compiled: bool = True) -> dict:
    """Sample, decode, evaluate; returns the metric dict and writes the
    artifacts (orchestrator.py:165-427).

    Sampling runs on the model's device.  ``params``: see ``make_sample_fn``;
    with several processes every rank passes the whole weights (the
    trainer's ``ema_slice`` gathers a ZeRO-1 EMA), samples its shard of the
    eval set and joins the gather; rank 0 returns the metrics, the others an
    empty dict.
    ``bundle`` is the SceneGraphBundle of ``data.load_data``.
    ``noise_factory(batch_index)`` gives each batch's noise source (default:
    one ``TorchNoise`` seeded from ``config.seed + epoch`` on the sampling
    device for the whole call, with several processes folded once with the
    rank, each rank's stream its own as under the JAX ``shard_map``
    sampler; a caller's factory gives each rank its own sources).
    ``inpaint_frac`` turns the pass into
    conditional completion: the first ceil(n_valid * frac) valid nodes of
    every test graph, their labels, boxes and the edges among them, are
    pinned to the ground truth (``inpaint_masks``).  On a card the sampler
    runs compiled unless ``compiled=False`` (``make_sample_fn``).

    Besides the metrics, the dict holds ``_seconds``: the wall time of
    sampling + decode and of metrics + artifacts."""
    t_start = time.perf_counter()
    cfg_test = config.test
    flag_bbox = True
    node_encoding = config.train.node_encoding
    edge_encoding = config.train.edge_encoding

    info = resolve_sampling_channels(config)
    flag_node_only = info["flag_node_only"]
    flag_binary_edge = info["flag_binary_edge"]
    raw_num_node_type = info["raw_num_node_type"]
    raw_num_adj_type = info["raw_num_adj_type"]
    num_node_type = info["num_node_chan"]
    num_adj_type = info["num_adj_chan"]

    eval_size = cfg_test.eval_size
    test_data = bundle.test
    if eval_mode:
        total_samples = eval_size if eval_size > 0 else len(test_data)
        batch_size = cfg_test.batch_size or config.train.batch_size
    else:
        total_samples = eval_size if eval_size > 0 else config.train.batch_size
        batch_size = config.train.batch_size
    total_samples = min(len(test_data), total_samples)
    eval_set = split_eval_set(test_data, total_samples, seed=config.seed)
    dev = next(model.parameters()).device
    world = current_world()
    multi = world is not None and world.size > 1
    if multi:
        # each rank samples its strided shard (the reference's DDP eval split)
        eval_set = shard_for_process(eval_set, world.rank, world.size)
    logging.info("sampling %d graphs (batch %d) on %s%s", total_samples, batch_size, dev,
                 f", {len(eval_set)} on rank {world.rank}" if multi else "")

    def _pad(a: np.ndarray) -> np.ndarray:
        """Repeat-pad to the full batch (outputs are trimmed back)."""
        if len(a) == batch_size:
            return a
        return np.concatenate([a] * -(-batch_size // len(a)), 0)[:batch_size]

    def _put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if noise_factory is None:
        shared = TorchNoise(int(config.seed) + epoch, dev)
        if multi:
            shared = shared.fold_in(world.rank)

        def noise_factory(bi):
            return shared
    # interim snapshot cap mirrors the reference (sampler_node_adj.py:85-86)
    num_interim = min(int(config.test.get("num_interim", 10)), mc_sampler.num_steps)
    if inpaint_frac is not None:
        if not (0.0 < inpaint_frac < 1.0):
            raise ValueError(f"inpaint_frac must be in (0, 1), got {inpaint_frac}")
        if flag_node_only:
            raise NotImplementedError("inpaint_frac with node_only mode")
        if sanity_check or random_node_num:
            raise ValueError("inpaint_frac is exclusive with sanity_check / random_node_num "
                             "(conditioning pins GT values onto the GT node layout)")
    sample_fn = make_sample_fn(model, params, mc_sampler, num_node_type, num_adj_type,
                               sanity_check, precond=config.mcmc.get("precond", "edm"),
                               num_interim=num_interim, inpaint=inpaint_frac is not None,
                               compiled=compiled)
    decode_fn = partial(decode_samples, node_encoding=node_encoding,
                        edge_encoding=edge_encoding, num_node_type=raw_num_node_type,
                        num_adj_type=raw_num_adj_type if not flag_binary_edge else 2,
                        flag_bbox=flag_bbox, flag_node_only=flag_node_only)

    out = {"q_adj": [], "q_node": [], "bbox": [], "flags": [], "flags_gt": [],
           "q_adj_gt": [], "q_node_gt": [], "bbox_gt": [], "image_ids": [],
           "raw_a": [], "raw_x": [], "interim_a": [], "interim_x": []}
    num_nodes_pool = (np.asarray([len(g["node_labels"]) for g in test_data.pkl_data])
                      if test_data.pkl_data else None)

    n_batches = -(-len(eval_set) // batch_size)
    for bi in range(n_batches):
        sl = slice(bi * batch_size, (bi + 1) * batch_size)
        n_real = len(eval_set.adjs[sl])
        adjs_gt = _put(_pad(eval_set.adjs[sl]))
        nodes_gt = _put(_pad(eval_set.nodes[sl]))
        flags = _pad(np.asarray(eval_set.node_flags[sl]))
        flags_t = _put(flags)
        image_ids = eval_set.image_ids[sl]

        if "one_hot" in (node_encoding, edge_encoding):
            # deferred one-hot encoding (reference: sampler_node_adj.py:116-139)
            from ..train.train_step import TrainStepConfig, encode_one_hot_batch
            enc_cfg = TrainStepConfig(
                node_encoding=node_encoding, edge_encoding=edge_encoding,
                flag_node_only=flag_node_only, num_node_type=raw_num_node_type,
                num_edge_type=2 if flag_binary_edge else raw_num_adj_type)
            adjs_gt, nodes_gt = encode_one_hot_batch(adjs_gt, nodes_gt, flags_t, enc_cfg)

        if random_node_num and num_nodes_pool is not None and flags.ndim == 2:
            sample_flags = resample_node_flags(flags, num_nodes_pool, config.seed + epoch + bi)
        else:
            sample_flags = flags
        sample_flags_t = _put(sample_flags)

        noise = noise_factory(bi)
        if sanity_check:
            res_t = sample_fn(noise, sample_flags_t, adjs_gt, nodes_gt)
        elif inpaint_frac is not None:
            mask_a, known = inpaint_masks(flags, inpaint_frac)
            res_t = sample_fn(noise, sample_flags_t, adjs_gt, nodes_gt, _put(mask_a),
                              _put(known))
        else:
            res_t = sample_fn(noise, sample_flags_t)
        adjs, nodes = res_t[:2]
        if num_interim > 0:
            # a handful per batch, batch-major [b, T+1, ...] like every other
            # output (the reference keeps all snapshots in memory, saves none)
            keep = min(8, n_real)
            for key, stack in zip(("interim_a", "interim_x"), res_t[2:]):
                out[key].append(np.swapaxes(stack[:, :keep].cpu().numpy(), 0, 1))

        with torch.no_grad():
            dec = decode_fn(adjs, nodes, sample_flags_t)
            dec_gt = decode_fn(adjs_gt, nodes_gt, flags_t)
            if flag_node_only:
                # unpack the node attributes packed on the adj grid back to
                # vectors (reference: sampler_node_adj.py:179-191,287-300)
                from ..ops.attribute_code import reshape_node_attr_mat_to_vec
                n_allowed = info["num_allowed_nodes"]
                q_node, flags_vec = reshape_node_attr_mat_to_vec(
                    dec.adj_types.float(), sample_flags_t, n_allowed)
                q_node_gt, flags_gt_vec = reshape_node_attr_mat_to_vec(
                    dec_gt.adj_types.float(), flags_t, n_allowed)
                host = dict(q_node=q_node, q_node_gt=q_node_gt, flags=flags_vec,
                            flags_gt=flags_gt_vec)
                if flag_bbox:
                    host["bbox"] = reshape_node_attr_mat_to_vec(
                        dec.bboxes, sample_flags_t, n_allowed)[0]
                    host["bbox_gt"] = reshape_node_attr_mat_to_vec(
                        dec_gt.bboxes, flags_t, n_allowed)[0]
            else:
                host = dict(q_adj=dec.adj_types, q_adj_gt=dec_gt.adj_types,
                            q_node=dec.node_types, q_node_gt=dec_gt.node_types)
                if flag_bbox:
                    host.update(bbox=dec.bboxes, bbox_gt=dec_gt.bboxes)
            host.update(raw_a=adjs, raw_x=nodes)
        # one device-to-host copy per decoded tensor of the batch
        host = {k: v.cpu().numpy()[:n_real] for k, v in host.items()}
        if flag_node_only:
            for key in ("q_node", "q_node_gt"):
                host[key] = host[key].astype(np.int64)
            host["q_adj"] = np.zeros((n_real, n_allowed, n_allowed), np.int64)
            host["q_adj_gt"] = np.zeros((n_real, n_allowed, n_allowed), np.int64)
        else:
            host.update(flags=sample_flags[:n_real], flags_gt=flags[:n_real])
        for key, val in host.items():
            out[key].append(val)
        out["image_ids"].append(image_ids)
    t_sampled = time.perf_counter()
    logging.info("sampling + decode done in %.1fs", t_sampled - t_start)

    res = {k: np.concatenate(v, 0) for k, v in out.items() if v}
    if multi:
        # every rank's rows (reference: sampler_node_adj.py:331-345), one
        # shape on each rank thanks to the shards' wrap-padding
        sync_hosts()
        res = trim_process_padding({k: gather_to_host(v, world) for k, v in res.items()},
                                   total_samples, world.size)
    if not is_main_process():
        return {}
    metrics = evaluate_samples(res, config, bundle, raw_num_node_type, raw_num_adj_type,
                               flag_node_only, flag_binary_edge, flag_bbox, skip_eval)
    write_artifacts(res, metrics, config, bundle, epoch, eval_mode, sanity_check,
                    sampling_params, writer, skip_eval)
    metrics["_seconds"] = {"sampling_decode": t_sampled - t_start,
                           "metrics_artifacts": time.perf_counter() - t_sampled}
    return metrics


def evaluate_samples(res: dict, config, bundle, raw_num_node_type, raw_num_adj_type,
                     flag_node_only, flag_binary_edge, flag_bbox, skip_eval) -> dict:
    """The metric block (orchestrator.py:430-506; reference:
    sampler_node_adj.py:445-552)."""
    if skip_eval:
        return {}
    ev = SceneGraphEvaluator()
    kernels = ["gaussian"]
    metrics: dict = {"gen_data_size": len(res["q_adj"]),
                     "test_data_size": len(res["q_adj_gt"])}

    deg = ev.compute_node_degree_mmd(res["q_adj"], res["q_adj_gt"], kernels)
    for kname, sub in deg.items():
        for key, val in sub.items():
            metrics[f"node_{key}_mmd_{kname}"] = val
    ntm = ev.compute_node_type_mmd(res["q_node"], res["q_node_gt"], res["flags"],
                                   res["flags_gt"], raw_num_node_type, kernels)
    for kname, val in ntm.items():
        metrics[f"node_type_mmd_{kname}"] = val
    etm = ev.compute_edge_type_mmd(res["q_adj"], res["q_adj_gt"], res["flags"],
                                   res["flags_gt"],
                                   raw_num_adj_type if not flag_binary_edge else 2, kernels)
    for kname, val in etm.items():
        metrics[f"edge_type_mmd_{kname}"] = val
    if not flag_node_only:
        for tag, tdict in [("val", bundle.test_triplet_dict),
                           ("train", bundle.train_triplet_dict)]:
            rej, all_, full, novelty = ev.compute_triplet_tv_dist(
                res["q_adj"], res["q_node"], res["flags"], tdict, bundle.test_triplet_dict)
            metrics[f"triplet_tv_dist_rej_{tag}"] = rej
            metrics[f"triplet_tv_dist_all_{tag}"] = all_
            metrics[f"triplet_tv_dist_full_{tag}"] = full
            metrics[f"triplet_novelty_{tag}"] = novelty

    if flag_bbox and "bbox" in res:
        pred_bbox = xyxy_in_unit(res["bbox"])
        gt_bbox = xyxy_in_unit(res["bbox_gt"])
        for prefix, bbox, flags in [("pred", pred_bbox, res["flags"]),
                                    ("gt", gt_bbox, res["flags_gt"])]:
            metrics[f"{prefix}_iou_blt"] = ev.compute_bbox_ioa(
                bbox, flags, flag_vanilla_iou=True, return_mean=True)
            metrics[f"{prefix}_iou_percp_blt"] = ev.compute_bbox_ioa(
                bbox, flags, canvas_size=32, flag_perceptual_iou=True, return_mean=True)
            metrics[f"{prefix}_overlap_blt"] = ev.compute_bbox_ioa(
                bbox, flags, flag_overlap=True, return_mean=True)
            metrics[f"{prefix}_alignment_blt"] = ev.compute_bbox_ioa(
                bbox, flags, flag_alignment=True, return_mean=True)

        # F1 with vanilla / area / freq weights (sampler_node_adj.py:507-552)
        area_stat = bundle.bbox_area_stat
        freq_stat = bundle.bbox_freq_stat
        w_area = np.asarray([area_stat[k] for k in sorted(area_stat)], np.float64)
        w_area = w_area / w_area.sum()
        w_freq = np.asarray([freq_stat[k] for k in sorted(freq_stat)], np.float64)
        w_freq = w_freq / w_freq.sum()
        weights = [np.ones_like(w_area), w_area, w_freq]
        mat_f1 = ev.compute_bbox_f1(pred_bbox, res["q_node"], res["flags"],
                                    gt_bbox, res["q_node_gt"], res["flags_gt"],
                                    class_weight_ls=weights)
        # node-type-agnostic F1: every valid node of one class
        dummy_gen = np.asarray(res["flags"]).astype(bool).astype(np.float32)
        dummy_gt = np.asarray(res["flags_gt"]).astype(bool).astype(np.float32)
        mat_f1_nt = ev.compute_bbox_f1(pred_bbox, dummy_gen, res["flags"],
                                       gt_bbox, dummy_gt, res["flags_gt"])
        mats = {"vanilla": mat_f1[..., 0], "area": mat_f1[..., 1],
                "freq": mat_f1[..., 2], "no_node_type": mat_f1_nt[..., 0]}
        for name, mat in mats.items():
            metrics[f"{name}_f1_avg_max"] = float(mat.max(-1).mean())
            metrics[f"{name}_f1_avg_mean"] = float(mat.mean(-1).mean())
            metrics[f"{name}_f1_avg_median"] = float(np.median(mat, -1).mean())
        metrics["_mat_f1"] = mats
    for k, v in metrics.items():
        if not k.startswith("_"):
            logging.info("metric %s = %s", k, v)
    return metrics


def xyxy_in_unit(bbox_cxcywh: np.ndarray) -> np.ndarray:
    """Decoded (cx, cy, w, h) boxes -> (x1, y1, x2, y2), clipped to [0, 1]."""
    return np.clip(box_cxcywh_to_xyxy(torch.from_numpy(np.asarray(bbox_cxcywh))).numpy(), 0, 1)


def _csv_cell(value):
    """A value as pandas' ``to_csv`` writes it: empty for None and NaN."""
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return ""
    return str(value)


def append_results_csv(csv_path: str, row: dict) -> None:
    """Append one row to the append-only results table; the header only when
    the file is new (the JAX package writes the same file with pandas)."""
    new = not os.path.exists(csv_path)
    with open(csv_path, "a", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        if new:
            w.writerow(list(row))
        w.writerow([_csv_cell(v) for v in row.values()])


def write_artifacts(res, metrics, config, bundle, epoch, eval_mode, sanity_check,
                    sampling_params, writer, skip_eval) -> None:
    """npz dumps, eval_results.csv, scene-graph txt, scalars and plots
    (orchestrator.py:509-605; reference: sampler_node_adj.py:353-720)."""
    stamp = "eval_" + (time.strftime("%b-%d-%H-%M-%S") if eval_mode else f"epoch_{epoch:05d}")
    sub = "sampling_during_evaluation" if eval_mode else "sampling_during_training"
    mode_tag = "sanity_check" if sanity_check else "model_inference"
    outdir = os.path.join(config.logdir, sub, f"{stamp}_{mode_tag}")
    os.makedirs(outdir, exist_ok=True)

    npz_payload = dict(
        samples_node_flags=res["flags"].astype(bool),
        samples_a=res["q_adj"], raw_a=res["raw_a"], raw_x=res["raw_x"],
        gt_node_flags=res["flags_gt"].astype(bool), gt_a=res["q_adj_gt"],
        gt_image_ids=res["image_ids"])
    if "q_node" in res:
        npz_payload.update(samples_x=res["q_node"], gt_x=res["q_node_gt"])
    if "bbox" in res:
        npz_payload.update(samples_x_bbox=res["bbox"], gt_x_bbox=res["bbox_gt"])
    if "interim_a" in res:
        # interim denoising snapshots, batch-major [b, T+1, ...]
        npz_payload.update(interim_a=res["interim_a"], interim_x=res["interim_x"])
    np.savez_compressed(os.path.join(outdir, "final_samples_array_before_eval.npz"),
                        **npz_payload)
    if skip_eval:
        return

    # dataset-statistics report (reference: sampler_node_adj.py:417-435); its
    # plots are skipped inside when matplotlib is absent
    from ..eval.sg_statistics import compute_sg_statistics
    compute_sg_statistics(npz_payload, bundle.test.pkl_data, bundle.idx_to_word, outdir)

    if metrics.get("_mat_f1"):
        for name, mat in metrics["_mat_f1"].items():
            npz_payload[f"mat_f1_{name}"] = mat
    np.savez_compressed(os.path.join(outdir, "final_samples_array.npz"), **npz_payload)

    if writer is not None:
        for key, val in metrics.items():
            if not key.startswith("_") and np.isscalar(val):
                writer.add_scalar(f"gen_epoch/{key}", float(val), epoch)

    # append-only CSV (reference: sampler_node_adj.py:621-696)
    row = {"model_nm": (sampling_params or {}).get("model_nm", f"epoch_{epoch:05d}"),
           "weight_kw": (sampling_params or {}).get("weight_kw", ""),
           "model_path": (sampling_params or {}).get("model_path", "")}
    row.update({k: v for k, v in metrics.items() if not k.startswith("_")})
    append_results_csv(os.path.join(config.logdir, "eval_results.csv"), row)

    # human-readable scene graphs (reference: sampler_node_adj.py:698-720)
    if "q_node" in res:
        _write_scene_graph_txt(os.path.join(outdir, "gen_scene_graph.txt"), res["q_adj"],
                               res["q_node"], res["flags"], bundle.idx_to_word)

    # scene-graph visualizations (reference: sampler_node_adj.py:389-390,554-573)
    try:
        from ..utils.visual import plot_graphs_adj, plot_scene_graph, plot_scene_graph_bbox
        if "q_node" in res:
            plot_scene_graph(res["q_node"], res["q_adj"], res["flags"], bundle.idx_to_word,
                             save_dir=outdir, title=f"{stamp}_{mode_tag}.png", num_plots=8)
        if "interim_a" in res:
            # denoising trajectory of the first sample, channel 0
            traj = res["interim_a"][0]
            if traj.ndim == 4:
                traj = traj[..., 0]
            plot_graphs_adj(traj, save_dir=outdir, title=f"interim_{stamp}_{mode_tag}.png",
                            num_plots=len(traj))
        # retrieval panels: generated layouts beside their best-F1 GT match
        if metrics.get("_mat_f1") and "bbox" in res and "q_node" in res:
            n_panels = int(config.test.get("num_retrieval_plots", 2))
            for name, mat in metrics["_mat_f1"].items():
                plot_scene_graph_bbox(
                    res["q_node"], res["bbox"], res["q_adj"], res["q_node_gt"],
                    res["bbox_gt"], res["q_adj_gt"], mat, res["flags"], res["flags_gt"],
                    bundle.idx_to_word, save_dir=outdir,
                    title=f"bbox_{name}_f1_{stamp}_{mode_tag}.png", num_plots=n_panels)
    except Exception as e:  # plotting must never kill an eval run
        logging.warning("scene-graph plotting failed: %s", e)


def _write_scene_graph_txt(path, adjs, nodes, flags, idx_to_word):
    classes = idx_to_word.get("ind_to_classes", [])
    preds = idx_to_word.get("ind_to_predicates", [])
    lines = []
    for gi, (a, x) in enumerate(zip(adjs, nodes)):
        n = int(np.asarray(flags[gi]).astype(bool).sum())
        s = f"{'-' * 40} scene graph no. {gi} / {len(adjs)} {'-' * 40}\n"
        s += "".ljust(20)
        for j in range(n):
            s += str(classes[int(x[j])] if int(x[j]) < len(classes) else x[j]).ljust(20)
        s += "\n"
        for i in range(n):
            s += str(classes[int(x[i])] if int(x[i]) < len(classes) else x[i]).ljust(20)
            for j in range(n):
                if a[i][j] > 0:
                    pred = preds[int(a[i][j])] if int(a[i][j]) < len(preds) else a[i][j]
                    s += str(pred).ljust(20)
                else:
                    s += "".ljust(20)
            s += "\n"
        lines.append(s)
    np.savetxt(path, lines, fmt="%s")
