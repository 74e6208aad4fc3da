"""SceneGraphEvaluator: node/edge/triplet/bbox metrics over decoded samples.

The port's copy of diffusesg_tpu/eval/sg_evaluator.py (numpy, no JAX), the
counterpart of the reference evaluator (reference:
DiffuseSG/evaluation/bbox_metrics.py:140-483) with the same static-method
API.  Histogramming is vectorized (np.apply_along_axis bincounts / hashing
for triplets) instead of per-graph torch.histogram loops.
"""
from __future__ import annotations

from collections import Counter

import numpy as np

from .blt import compute_bbox_ioa
from .graph_stats import degree_stats
from .mmd import compute_mmd, retrieve_kernels, KERNEL_NAME_TO_FUNC
from .voc_f1 import compute_bbox_f1


class SceneGraphEvaluator:
    """Evaluate generated scene graphs: MMDs, triplet TV/novelty, bbox F1/IOA."""

    # -- histograms ----------------------------------------------------------
    @staticmethod
    def _get_node_type_hist(node_types, node_flags, num_node_types: int) -> list:
        """Per-graph node-type histograms over valid nodes
        (reference: bbox_metrics.py:181-194; type 0 is a real type)."""
        node_types = np.asarray(node_types)
        node_flags = np.asarray(node_flags).astype(bool)
        out = []
        for types, flags in zip(node_types, node_flags):
            vals = types[flags].astype(np.int64)
            out.append(np.bincount(vals, minlength=num_node_types).astype(np.float64))
        return out

    @staticmethod
    def _get_edge_type_hist(edge_types, node_flags, num_edge_types: int) -> list:
        """Per-graph edge-type histograms over valid pairs, dropping type 0
        (padding/null) and graphs with no edges (bbox_metrics.py:197-212)."""
        edge_types = np.asarray(edge_types)
        flags = np.asarray(node_flags).astype(bool)
        out = []
        for adj, f in zip(edge_types, flags):
            if f.ndim == 1:
                mask = f[:, None] & f[None, :]
            else:
                mask = f
            vals = adj[mask].astype(np.int64)
            vals = vals[vals >= 1]  # drop null/padding type 0
            if vals.size:
                hist = np.bincount(vals, minlength=num_edge_types)[1:]
                out.append(hist.astype(np.float64))
        return out

    @staticmethod
    def _get_triplet_type_hist(edge_types, node_types, node_flags,
                               allowed_triplet, reject_novel_triplet: bool) -> list:
        """Per-graph (subject, object, predicate) triplet histograms aligned to
        ``allowed_triplet`` order, optionally appending novel-triplet counts
        (reference: bbox_metrics.py:215-268; triplet tuple layout
        (node_from, node_to, edge) per :228-231)."""
        edge_types = np.asarray(edge_types)
        node_types = np.asarray(node_types)
        allowed = list(allowed_triplet)
        allowed_index = {t: i for i, t in enumerate(allowed)}
        hists = []
        max_novel = 0
        for adj, types in zip(edge_types, node_types):
            src, dst = np.nonzero(adj)
            triplets = [(int(types[i]), int(types[j]), int(adj[i, j]))
                        for i, j in zip(src, dst)]
            counts = Counter(triplets)
            overlap = np.zeros(len(allowed))
            novel = []
            for t, c in counts.items():
                if t in allowed_index:
                    overlap[allowed_index[t]] = c
                else:
                    novel.append(c)
            max_novel = max(max_novel, len(novel))
            if reject_novel_triplet:
                h = overlap
            else:
                h = np.concatenate([overlap, np.asarray(novel, np.float64)])
            if h.sum() > 0:
                hists.append(h)
        if not reject_novel_triplet:
            pad_len = len(allowed) + max_novel
            hists = [np.concatenate([h, np.zeros(pad_len - len(h))]) for h in hists]
        return hists

    # -- MMDs -----------------------------------------------------------------
    @staticmethod
    def compute_node_degree_mmd(edge_types_gen, edge_types_ref, kernel_ls):
        """Degree MMD over thresholded graphs (bbox_metrics.py:270-283)."""
        results = {}
        for kernel in retrieve_kernels(kernel_ls):
            name = _kernel_name(kernel)
            mmd = degree_stats(np.asarray(edge_types_ref), np.asarray(edge_types_gen),
                               kernel=kernel)
            results[name] = {"degree": mmd, "average": mmd}
        return results

    @staticmethod
    def compute_node_type_mmd(node_types_gen, node_types_ref, node_flags_gen,
                              node_flags_ref, num_node_types, kernel_ls):
        """(bbox_metrics.py:285-308)"""
        gt_hist = SceneGraphEvaluator._get_node_type_hist(node_types_ref, node_flags_ref,
                                                          num_node_types)
        pred_hist = SceneGraphEvaluator._get_node_type_hist(node_types_gen, node_flags_gen,
                                                            num_node_types)
        assert np.sum(gt_hist) == np.asarray(node_flags_ref).astype(bool).sum()
        assert np.sum(pred_hist) == np.asarray(node_flags_gen).astype(bool).sum()
        return {_kernel_name(k): compute_mmd(gt_hist, pred_hist, kernel=k)
                for k in retrieve_kernels(kernel_ls)}

    @staticmethod
    def compute_edge_type_mmd(edge_types_gen, edge_types_ref, node_flags_gen,
                              node_flags_ref, num_edge_types, kernel_ls):
        """(bbox_metrics.py:310-334)"""
        gt_hist = SceneGraphEvaluator._get_edge_type_hist(edge_types_ref, node_flags_ref,
                                                          num_edge_types)
        pred_hist = SceneGraphEvaluator._get_edge_type_hist(edge_types_gen, node_flags_gen,
                                                            num_edge_types)
        kernels = retrieve_kernels(kernel_ls)
        if len(gt_hist) and len(pred_hist):
            return {_kernel_name(k): compute_mmd(gt_hist, pred_hist, kernel=k)
                    for k in kernels}
        return {_kernel_name(k): -1.0 for k in kernels}

    # -- triplets --------------------------------------------------------------
    @staticmethod
    def compute_triplet_tv_dist(edge_types_gen, node_types_gen, node_flags_gen,
                                triplet_dict, triplet_to_count):
        """TV distances (reject-novel / accept-novel / full) + novelty mass
        (bbox_metrics.py:336-376).  ``triplet_dict`` values are expected to be
        normalized frequencies, like the reference statistics pickles."""
        hist_rej = SceneGraphEvaluator._get_triplet_type_hist(
            edge_types_gen, node_types_gen, node_flags_gen,
            allowed_triplet=triplet_dict.keys(), reject_novel_triplet=True)
        hist_all = SceneGraphEvaluator._get_triplet_type_hist(
            edge_types_gen, node_types_gen, node_flags_gen,
            allowed_triplet=triplet_dict.keys(), reject_novel_triplet=False)
        n_allowed = len(triplet_dict)
        if len(hist_rej):
            tv_rej = np.stack(hist_rej).sum(0)
            tv_rej = tv_rej / tv_rej.sum()
        else:
            tv_rej = np.zeros(n_allowed)
        if len(hist_all):
            tv_all = np.stack(hist_all).sum(0)
            tv_all = tv_all / tv_all.sum()
        else:
            tv_all = np.zeros(n_allowed)
        tv_gt = np.asarray(list(triplet_dict.values()), np.float64)
        diff_rej = tv_gt - tv_rej
        diff_all = tv_gt - tv_all[:n_allowed]
        diff_full = np.concatenate([diff_all, tv_all[n_allowed:]])
        k = len(triplet_to_count)
        return (float(np.abs(diff_rej[:k]).sum()),
                float(np.abs(diff_all[:k]).sum()),
                float(np.abs(diff_full).sum()),
                float(np.abs(tv_all[n_allowed:]).sum()))

    # -- bbox ---------------------------------------------------------------
    @staticmethod
    def compute_bbox_f1(node_bbox_gen, node_types_gen, node_flags_gen,
                        node_bbox_ref, node_types_ref, node_flags_ref,
                        class_weight_ls=None):
        """All-pairs F1 matrix; native C++ engine when it builds, vectorized
        numpy otherwise (both verified against the reference matcher).  An
        error inside the native call is raised, not hidden."""
        from .native import compute_bbox_f1_native
        out = compute_bbox_f1_native(node_bbox_gen, node_types_gen,
                                     node_flags_gen, node_bbox_ref,
                                     node_types_ref, node_flags_ref,
                                     class_weight_ls)
        if out is not None:
            return out
        return compute_bbox_f1(node_bbox_gen, node_types_gen, node_flags_gen,
                               node_bbox_ref, node_types_ref, node_flags_ref,
                               class_weight_ls)

    compute_bbox_ioa = staticmethod(compute_bbox_ioa)


def _kernel_name(kernel) -> str:
    for name, fn in KERNEL_NAME_TO_FUNC.items():
        if fn is kernel:
            return name
    return getattr(kernel, "__name__", str(kernel))
