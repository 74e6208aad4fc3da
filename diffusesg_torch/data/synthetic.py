"""Deterministic synthetic scene-graph data matching the reference pickle schema.

The port's own copy of diffusesg_tpu/data/synthetic.py (numpy only; the same
seed gives the same graphs in both packages).  The reference dataset archive
is absent from the public snapshot; the schema is fully recoverable from
the loader (reference: DiffuseSG/utils/dataloader.py:99-116): each record is
{'node_labels': [n] ints, 'edge_map': [n, n] ints with zero diagonal,
'node_bboxes_xcyc': [n, 4] floats in [0, 1], 'image_id': int}, plus the
statistics pickles (dataloader.py:278-316).  This generator produces
structured (not uniform) graphs — clustered node types, preferential edges,
size-correlated bboxes — so metrics are non-degenerate.
"""
from __future__ import annotations

import numpy as np

from ..models.channels import dataset_constants

# Bump whenever the generator's RNG stream or output schema changes: the
# DSG_SYNTH_CACHE_DIR disk cache (data/dataset.py) folds this into its key so
# stale cached populations are never silently reused across generator edits.
SYNTH_CACHE_VERSION = 1


def synthetic_scene_graphs(num_graphs: int, max_nodes: int, num_node_type: int,
                           num_edge_type: int, seed: int = 0,
                           min_nodes: int = 2,
                           pop_seed: int | None = None,
                           per_graph_alpha: float | None = None,
                           node_alpha: float = 0.3,
                           edge_alpha: float = 0.5) -> list[dict]:
    """``node_alpha``/``edge_alpha`` are the Dirichlet concentrations of the
    global type/predicate popularity.  The defaults reproduce the historical
    stream bit-exactly.  Smaller values concentrate the population on a few
    dominant types — e.g. node_alpha=0.05/edge_alpha=0.1 yields a COCO-like
    regime where a handful of (subject, object, predicate) triplets carry
    most of the mass, so triplet-TV metrics have a low iid floor instead of
    the near-unique-triplet regime of the default VG-like draw (round-4
    VERDICT weak #6)."""
    rs = np.random.RandomState(seed)
    # skewed type popularity, like real VG/COCO long-tail distributions.
    # pop_seed decouples the DISTRIBUTION (the dirichlet popularity vectors)
    # from the graph draws: two calls sharing pop_seed sample iid graphs from
    # the SAME distribution — the property real train/test splits have.
    # Round-2 diagnosis: with per-split seeds the train/test populations
    # differed (node-type MMD 0.042 between the raw splits vs 0.0008 for a
    # same-population split), putting an irreducible floor under the quality
    # run's node-type metric (BASELINE.md round-3 entry).
    # derive the pop stream from a DIFFERENT seed than the graph stream:
    # RandomState(pop_seed) and RandomState(seed) with pop_seed == seed (the
    # train split) would emit identical raw outputs, so the popularity draw
    # would replay the exact randomness the first graph draws then consume —
    # deterministically coupling the distribution to the samples
    pop_rs = (rs if pop_seed is None
              else np.random.RandomState((pop_seed ^ 0x9E3779B9) & 0x7FFFFFFF))
    node_pop = pop_rs.dirichlet(np.full(num_node_type, node_alpha))
    edge_pop = pop_rs.dirichlet(np.full(max(num_edge_type - 1, 1), edge_alpha))
    data = []
    for g in range(num_graphs):
        n = int(rs.randint(min_nodes, max_nodes + 1))
        # per_graph_alpha > 0 turns on WITHIN-GRAPH correlation: each graph
        # draws its own popularity vector ~ Dirichlet(global_pop * alpha) and
        # a graph-level bbox size factor, so the two halves of a graph share
        # information (real scenes cluster types: a street image is full of
        # cars).  With the default (None) the streams are bit-identical to
        # before and halves are conditionally independent given n — in that
        # regime conditional completion can only MATCH unconditional
        # quality, never beat it (used by the inpaint-quality eval to pick
        # the right null hypothesis).  Smaller alpha = stronger clustering.
        if per_graph_alpha is not None:
            node_pop_g = rs.dirichlet(node_pop * per_graph_alpha + 1e-4)
            edge_pop_g = rs.dirichlet(edge_pop * per_graph_alpha + 1e-4)
            size_g = rs.uniform(0.6, 1.4)
        else:
            node_pop_g, edge_pop_g, size_g = node_pop, edge_pop, 1.0
        labels = rs.choice(num_node_type, size=n, p=node_pop_g)
        edge_map = np.zeros((n, n), dtype=np.int64)
        # sparse preferential edges; symmetric-free directed predicates
        p_edge = min(0.9, 2.5 / max(n - 1, 1))
        for i in range(n):
            for j in range(n):
                if i != j and rs.rand() < p_edge:
                    edge_map[i, j] = 1 + rs.choice(max(num_edge_type - 1, 1), p=edge_pop_g)
        # bboxes: centers anywhere, sizes correlated with type popularity
        cx = rs.uniform(0.2, 0.8, size=n)
        cy = rs.uniform(0.2, 0.8, size=n)
        scale = 0.1 + 0.5 * node_pop[labels] / node_pop.max()
        w = np.clip(rs.uniform(0.05, 0.4, size=n) * (0.5 + scale) * size_g, 0.02, 0.95)
        h = np.clip(rs.uniform(0.05, 0.4, size=n) * (0.5 + scale) * size_g, 0.02, 0.95)
        w = np.minimum(w, 2 * np.minimum(cx, 1 - cx))
        h = np.minimum(h, 2 * np.minimum(cy, 1 - cy))
        bboxes = np.stack([cx, cy, w, h], axis=-1)
        data.append({"node_labels": labels, "edge_map": edge_map,
                     "node_bboxes_xcyc": bboxes.astype(np.float32), "image_id": g})
    return data


def compute_stats_dicts(data: list[dict], num_node_type: int | None = None) -> dict:
    """Statistics pickle equivalent (reference: dataloader.py:278-316 keys).

    Triplet keys use the evaluator's layout (type_from, type_to, predicate)
    (reference: bbox_metrics.py:228-231) with values normalized to
    frequencies; node count/area dicts cover EVERY class id in
    [0, num_node_type) (the F1 weight arrays index by class id,
    sampler_node_adj.py:508-512).
    """
    triplet_count: dict = {}
    node_count: dict = {}
    area_sum: dict = {}
    if num_node_type is not None:
        for k in range(num_node_type):
            node_count[k] = 1e-6          # smoothing for absent classes
            area_sum[k] = (1e-6, 1)
    for item in data:
        labels = item["node_labels"]
        edge_map = item["edge_map"]
        bboxes = item["node_bboxes_xcyc"]
        for i, lab in enumerate(labels):
            lab = int(lab)
            node_count[lab] = node_count.get(lab, 0) + 1
            area = float(bboxes[i, 2] * bboxes[i, 3])
            s, c = area_sum.get(lab, (0.0, 0))
            area_sum[lab] = (s + area, c + 1)
        nz = np.argwhere(edge_map > 0)
        for i, j in nz:
            trip = (int(labels[i]), int(labels[j]), int(edge_map[i, j]))
            triplet_count[trip] = triplet_count.get(trip, 0) + 1
    total_triplets = max(sum(triplet_count.values()), 1)
    triplet_sorted = dict(sorted(triplet_count.items(), key=lambda kv: -kv[1]))
    triplet_sorted = {k: v / total_triplets for k, v in triplet_sorted.items()}
    node_sorted = dict(sorted(node_count.items(), key=lambda kv: -kv[1]))
    area_avg = {k: s / c for k, (s, c) in area_sum.items()}
    area_sorted = dict(sorted(area_avg.items(), key=lambda kv: -kv[1]))
    return {"triplet_dict_sorted": triplet_sorted,
            "node_dict_sorted": node_sorted,
            "node_bbox_area_avg_dict_sorted": area_sorted}


def synthetic_bundle_dicts(dataset_name: str, max_node_num: int, seed: int = 0,
                           num_train: int = 256, num_test: int = 128,
                           per_graph_alpha: float | None = None,
                           node_alpha: float = 0.3, edge_alpha: float = 0.5):
    """(train_data, test_data, train_stats, test_stats, idx_to_word)."""
    num_node_type, num_edge_type, num_allowed = dataset_constants(dataset_name)
    max_n = min(max_node_num, num_allowed)
    # shared pop_seed: train and test are iid draws from ONE distribution
    # (like a real dataset split); only the graph-draw seeds differ
    train = synthetic_scene_graphs(num_train, max_n, num_node_type, num_edge_type,
                                   seed=seed, pop_seed=seed,
                                   per_graph_alpha=per_graph_alpha,
                                   node_alpha=node_alpha, edge_alpha=edge_alpha)
    test = synthetic_scene_graphs(num_test, max_n, num_node_type, num_edge_type,
                                  seed=seed + 1, pop_seed=seed,
                                  per_graph_alpha=per_graph_alpha,
                                  node_alpha=node_alpha, edge_alpha=edge_alpha)
    idx_to_word = {
        "ind_to_classes": [f"obj_{i}" for i in range(num_node_type)],
        "ind_to_predicates": [f"rel_{i}" for i in range(num_edge_type)],
    }
    return (train, test, compute_stats_dicts(train, num_node_type),
            compute_stats_dicts(test, num_node_type), idx_to_word)
