"""Dataset-vs-generated scene-graph statistics report.

The port's copy of diffusesg_tpu/eval/sg_statistics.py (numpy, no JAX), the
counterpart of the reference's compute_sg_statistics
(reference: DiffuseSG/utils/sg_utils.py:9-345, wired from
runner/sampler/sampler_node_adj.py:417-435).  Covers the reference report's
sections with vectorized numpy instead of per-entry Python loops:

  * sample/node/edge count summaries (max/min/mean/std, gen vs GT)
  * unique node/edge/triplet counts and triplets-per-sample
  * per-type frequency rankings for node and edge labels (gen vs GT + diff)
  * node-count -> image-count/edge-count occupancy table
  * edge-count distribution table
  * edge-occupancy (sparsity) 10-bin histogram
  * plots: node_freq(.diff), edge_freq(.diff), node_num_vs_edge_num
    (line+scatter), edge_sparsity, plus bbox area/aspect panels
    (generated_stats.png)

The text report goes to logging AND <save_dir>/sg_statistics.txt; the
machine-readable summary to generated_stats.json.
"""
from __future__ import annotations

import json
import logging
import os
from collections import Counter

import numpy as np


def _word(table, idx: int) -> str:
    return str(table[idx]) if 0 <= idx < len(table) else str(idx)


def _type_and_triplet_counts(adjs, node_types, flags, classes, predicates):
    """Node/edge/triplet label Counters (reference: sg_utils.py:24-50)."""
    node_words: Counter = Counter()
    edge_words: Counter = Counter()
    triplet_words: Counter = Counter()
    adjs = np.asarray(adjs)
    node_types = np.asarray(node_types)
    flags = np.asarray(flags).astype(bool)
    for nt, t in zip(*np.unique(node_types[flags], return_counts=True)):
        node_words[_word(classes, int(nt))] += int(t)
    for g in range(len(adjs)):
        m = np.outer(flags[g], flags[g])
        si, oj = np.nonzero((adjs[g] > 0) & m)
        for i, j in zip(si, oj):
            e = int(adjs[g][i, j])
            ekey = _word(predicates, e)
            edge_words[ekey] += 1
            triplet_words[_word(classes, int(node_types[g][i])) + "_" + ekey
                          + "_" + _word(classes, int(node_types[g][j]))] += 1
    return node_words, edge_words, triplet_words


def _normalize(counter: Counter) -> dict:
    total = sum(counter.values())
    return {k: v / total for k, v in counter.items()} if total else {}


def _graph_stats(adjs, node_types, flags, bboxes=None):
    """Per-set summary arrays from int tensors."""
    flags = np.asarray(flags).astype(bool)
    adjs = np.asarray(adjs)
    node_types = np.asarray(node_types)
    num_nodes = flags.sum(-1)
    mask = flags[:, :, None] & flags[:, None, :]
    num_edges = ((adjs > 0) & mask).sum((-1, -2))
    und = ((adjs > 0) | (np.swapaxes(adjs, -1, -2) > 0)) & mask
    idx = np.arange(adjs.shape[-1])
    und[:, idx, idx] = False
    deg_all = und.sum(-1)[flags]
    out = {
        "num_nodes": num_nodes, "num_edges": num_edges,
        "degrees": deg_all if deg_all.size else np.zeros(1),
    }
    if bboxes is not None:
        bb = np.asarray(bboxes)
        w = bb[..., 2][flags]
        h = bb[..., 3][flags]
        out["bbox_area"] = w * h
        out["bbox_aspect"] = w / np.maximum(h, 1e-6)
        out["bbox_types"] = node_types[flags]
    return out


def _freq_ranking(gen_norm: dict, gt_norm: dict):
    """Aligned (key, gt_freq, gen_freq, diff) rows over shared keys, in the
    reference's sorted-gen-key order (sg_utils.py:147-152)."""
    rows = []
    for key in sorted(gen_norm):
        if key in gt_norm:
            rows.append((key, gt_norm[key], gen_norm[key],
                         gen_norm[key] - gt_norm[key]))
    return rows


def compute_sg_statistics(result_data: dict, pkl_data: list, idx_to_word: dict,
                          save_dir: str) -> dict:
    """Build the full comparison report.

    @param result_data: dict with samples_a/samples_x/samples_node_flags
        (+ optional samples_x_bbox), and gt_* counterparts — the same keys the
        sampling orchestrator saves to npz.
    @param pkl_data: raw dataset records (node_labels/edge_map/...); the
        reference compares against these directly (sg_utils.py:79-110) — when
        empty, the gathered gt_* tensors stand in.
    @return summary dict (also written to <save_dir>/generated_stats.json)
    """
    os.makedirs(save_dir, exist_ok=True)
    classes = list(idx_to_word.get("ind_to_classes", []))
    predicates = list(idx_to_word.get("ind_to_predicates", []))
    lines: list[str] = []

    def emit(msg: str):
        lines.append(msg)
        logging.info(msg)

    samples_x = result_data.get("samples_x")
    if samples_x is None:
        samples_x = 0 * np.asarray(result_data["samples_a"])[:, :, 0]
    gen = _graph_stats(result_data["samples_a"], samples_x,
                       result_data["samples_node_flags"],
                       result_data.get("samples_x_bbox"))
    gen_words = _type_and_triplet_counts(
        result_data["samples_a"], samples_x, result_data["samples_node_flags"],
        classes, predicates)

    # GT side: raw pickle records when available (reference gt path,
    # sg_utils.py:79-110), else the gathered gt tensors
    if pkl_data:
        gt_nodes = [np.asarray(g["node_labels"]) for g in pkl_data]
        gt_counts = np.asarray([len(x) for x in gt_nodes])
        n_max = max(int(gt_counts.max()), 1)
        b = len(pkl_data)
        gt_a = np.zeros((b, n_max, n_max), np.int64)
        gt_x = np.zeros((b, n_max), np.int64)
        gt_f = np.zeros((b, n_max), bool)
        for i, g in enumerate(pkl_data):
            k = len(gt_nodes[i])
            gt_x[i, :k] = gt_nodes[i]
            gt_f[i, :k] = True
            if "edge_map" in g:
                gt_a[i, :k, :k] = np.asarray(g["edge_map"])
        gt_bb = None
    else:
        gt_a = result_data["gt_a"]
        gt_x = result_data.get("gt_x", 0 * np.asarray(gt_a)[:, :, 0])
        gt_f = result_data["gt_node_flags"]
        gt_bb = result_data.get("gt_x_bbox")
    gt = _graph_stats(gt_a, gt_x, gt_f, gt_bb)
    gt_words = _type_and_triplet_counts(gt_a, gt_x, gt_f, classes, predicates)

    pred_len = max(len(gen["num_nodes"]), 1)
    gt_len = max(len(gt["num_nodes"]), 1)

    # count summaries (reference: sg_utils.py:126-139)
    emit("Total Sample Num - Generated: %.2f \t GT: %.2f" % (pred_len, gt_len))
    for name, key in [("Node", "num_nodes"), ("Edge", "num_edges")]:
        for stat, fn in [("Max.", np.max), ("Min.", np.min),
                         ("Mean", np.mean), ("Std.", np.std)]:
            emit("%s Number %s - Generated: %.2f \t GT: %.2f"
                 % (name, stat, fn(gen[key]), fn(gt[key])))
    emit("#Unique Nodes    - Generated: %.2f \t GT: %.2f"
         % (len(gen_words[0]), len(gt_words[0])))
    emit("#Unique Edges    - Generated: %.2f \t GT: %.2f"
         % (len(gen_words[1]), len(gt_words[1])))
    emit("#Unique Triplet  - Generated: %.2f \t GT: %.2f"
         % (len(gen_words[2]), len(gt_words[2])))
    emit("#Unique Trp/Smp  - Generated: %.2f \t GT: %.2f"
         % (len(gen_words[2]) / pred_len, len(gt_words[2]) / gt_len))

    node_rows = _freq_ranking(_normalize(gen_words[0]), _normalize(gt_words[0]))
    edge_rows = _freq_ranking(_normalize(gen_words[1]), _normalize(gt_words[1]))

    # node-count -> edge-count occupancy table (reference: sg_utils.py:252-270)
    emit("Total number of generated scene graphs: {:d}".format(pred_len))
    emit("#nodes\t #img\t %img\t\t #edges_avg\t #node^2\t %edge_occupancy")
    node_edge_tbl = []
    for k in np.unique(gen["num_nodes"]):
        sel = gen["num_edges"][gen["num_nodes"] == k]
        k = int(k)
        denom = k * (k - 1) if k > 1 else max(k * k, 1)
        node_edge_tbl.append((k, len(sel), len(sel) * 100 / pred_len,
                              float(sel.mean()), k * (k - 1),
                              float(sel.mean()) / denom * 100))
        emit("{:d} \t\t {:d} \t {:.2f} \t {:.2f} \t\t {:d} \t\t {:.3f}".format(
            *node_edge_tbl[-1]))

    # edge-count distribution (reference: sg_utils.py:272-276)
    emit("#edge\t #img \t %img ratio")
    for e, cnt in zip(*np.unique(gen["num_edges"], return_counts=True)):
        emit("{:d} \t {:d} \t {:.2f}".format(int(e), int(cnt), cnt * 100 / pred_len))

    # per-edge-type frequency ranking (reference: sg_utils.py:278-283)
    emit("edge_key \t %edge_gen \t %edge_gt \t %edge_diff")
    for key, f_gt, f_gen, diff in edge_rows:
        emit("%s \t %.2f \t\t %.2f \t\t %.2f"
             % (key.ljust(12), f_gen * 100, f_gt * 100, diff * 100))

    # edge occupancy (sparsity) bins (reference: sg_utils.py:306-327)
    nn = gen["num_nodes"].astype(np.float64)
    denom = np.where(nn > 1, nn * (nn - 1), np.maximum(nn * nn, 1.0))
    occupancy = gen["num_edges"] / denom
    occ_bin = np.histogram(np.clip(occupancy, 0.0, 1.0),
                           bins=np.linspace(0, 1, 11))[0]
    # reference bins are (lo, hi]-closed; fold exact zeros into bin 0 as it does
    occ_ratio = occ_bin * 100.0 / max(len(occupancy), 1)
    bin_list = ["0-10", "10-20", "20-30", "30-40", "40-50", "50-60", "60-70",
                "70-80", "80-90", "90-100"]
    emit("Edge occupancy rate and image ratio:")
    emit("\t".join(b.ljust(6) for b in bin_list))
    emit("\t".join("{:.2f}".format(r).ljust(6) for r in occ_ratio))

    summary = {
        "node_freq": [{"key": k, "gt": g, "gen": p, "diff": d}
                      for k, g, p, d in node_rows],
        "edge_freq": [{"key": k, "gt": g, "gen": p, "diff": d}
                      for k, g, p, d in edge_rows],
        "edge_occupancy_bins": occ_ratio.tolist(),
        "node_edge_table": node_edge_tbl,
    }
    for tag, s, words in [("gen", gen, gen_words), ("gt", gt, gt_words)]:
        summary[tag] = {
            "num_graphs": int(len(s["num_nodes"])),
            "avg_nodes": float(s["num_nodes"].mean()),
            "std_nodes": float(s["num_nodes"].std()),
            "avg_edges": float(s["num_edges"].mean()),
            "std_edges": float(s["num_edges"].std()),
            "avg_degree": float(s["degrees"].mean()),
            "distinct_node_types": len(words[0]),
            "distinct_edge_types": len(words[1]),
            "distinct_triplets": len(words[2]),
        }
        if "bbox_area" in s:
            summary[tag]["avg_bbox_area"] = float(s["bbox_area"].mean())
            summary[tag]["avg_bbox_aspect"] = float(s["bbox_aspect"].mean())
            # bbox area/aspect grouped by node class (top classes by support)
            by_class = {}
            types = s["bbox_types"]
            for nt, cnt in sorted(Counter(types.tolist()).items(),
                                  key=lambda kv: -kv[1])[:20]:
                sel = types == nt
                by_class[_word(classes, int(nt))] = {
                    "count": int(cnt),
                    "area_mean": float(s["bbox_area"][sel].mean()),
                    "aspect_mean": float(s["bbox_aspect"][sel].mean()),
                }
            summary[tag]["bbox_by_class"] = by_class

    with open(os.path.join(save_dir, "generated_stats.json"), "w") as f:
        json.dump(summary, f, indent=2)
    with open(os.path.join(save_dir, "sg_statistics.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")

    _plot_report(gen, gt, node_rows, edge_rows, node_edge_tbl, bin_list,
                 occ_ratio, save_dir)
    return summary


def _plot_report(gen, gt, node_rows, edge_rows, node_edge_tbl, bin_list,
                 occ_ratio, save_dir):
    """The reference's seven dashboard panels (sg_utils.py:141-345), saved
    both individually and as one generated_stats.png figure."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception as e:  # pragma: no cover
        logging.warning("stats plotting unavailable: %s", e)
        return

    def _bar_pair(rows, label, fname, fname_diff):
        keys = [r[0] for r in rows]
        ind = np.arange(len(keys))
        width = 0.45
        fig, ax = plt.subplots(figsize=(max(8, len(keys) * 0.25), 5))
        ax.bar(ind, [r[2] for r in rows], width=width, label=f"Result {label} frequency")
        ax.bar(ind + width, [r[1] for r in rows], width=width,
               label=f"Training {label} frequency")
        ax.set_xticks(ind + width / 2)
        ax.set_xticklabels(keys, fontsize=6, rotation="vertical")
        ax.set_ylabel(f"{label} Frequency")
        ax.set_title(f"{label} Label Frequency")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(save_dir, fname), dpi=100)
        plt.close(fig)
        fig, ax = plt.subplots(figsize=(max(8, len(keys) * 0.25), 5))
        ax.bar(keys, [r[3] for r in rows])
        ax.set_xticks(ind)
        ax.set_xticklabels(keys, fontsize=6, rotation="vertical")
        ax.set_title(f"{label} Label Frequency Difference: Result - Training")
        fig.tight_layout()
        fig.savefig(os.path.join(save_dir, fname_diff), dpi=100)
        plt.close(fig)

    try:
        if node_rows:
            _bar_pair(node_rows, "Node", "node_freq.png", "node_freq_diff.png")
        if edge_rows:
            _bar_pair(edge_rows, "Edge", "edge_freq.png", "edge_freq_diff.png")

        if node_edge_tbl:
            ks = [r[0] for r in node_edge_tbl]
            avg_e = [r[3] for r in node_edge_tbl]
            max_e = [r[4] for r in node_edge_tbl]
            fig, ax = plt.subplots(figsize=(6, 4))
            ax.plot(ks, avg_e, "-o")
            ax.set_xlabel("Node Number")
            ax.set_ylabel("Actual Averaged Edge Number")
            ax.set_title("Node Number vs. Edge Number")
            fig.savefig(os.path.join(save_dir, "node_num_vs_edge_num_line.png"), dpi=100)
            plt.close(fig)
            fig, ax = plt.subplots(figsize=(6, 4))
            ax.scatter(ks, avg_e, label="Actual averaged edge number")
            ax.scatter(ks, max_e, label="Max edge number")
            ax.legend()
            ax.set_title("Node Number vs. Edge Number")
            fig.savefig(os.path.join(save_dir, "node_num_vs_edge_num_scatter.png"), dpi=100)
            plt.close(fig)

        fig, ax = plt.subplots(figsize=(6, 4))
        ax.bar(bin_list, occ_ratio)
        ax.set_xlabel("Edge Occupancy Rate (in %) Bin")
        ax.set_ylabel("Image Ratio (in %) in Dataset")
        ax.set_title("The Sparsity of the Graph")
        ax.tick_params(axis="x", labelsize=6)
        fig.tight_layout()
        fig.savefig(os.path.join(save_dir, "edge_sparsity.png"), dpi=100)
        plt.close(fig)

        # combined overview incl. bbox panels
        panels = [("num_nodes", "#nodes"), ("num_edges", "#edges"),
                  ("degrees", "node degree")]
        if "bbox_area" in gen:
            panels += [("bbox_area", "bbox area"), ("bbox_aspect", "bbox aspect")]
        fig, axes = plt.subplots(2, len(panels), figsize=(4 * len(panels), 6),
                                 squeeze=False)
        for col, (key, label) in enumerate(panels):
            for row, (tag, s) in enumerate([("generated", gen), ("ground truth", gt)]):
                ax = axes[row][col]
                if key in s:
                    ax.hist(s[key], bins=30, color="#4c8cb8")
                ax.set_title(f"{tag}: {label}", fontsize=9)
        fig.tight_layout()
        fig.savefig(os.path.join(save_dir, "generated_stats.png"), dpi=100)
        plt.close(fig)
    except Exception as e:  # plotting must never kill an eval run
        logging.warning("stats plotting failed: %s", e)
