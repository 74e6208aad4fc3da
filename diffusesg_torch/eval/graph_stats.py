"""Graph-statistics MMDs: degree (vectorized), clustering, spectral.

The port's copy of diffusesg_tpu/eval/graph_stats.py (numpy, no JAX), the
counterpart of the reference graph statistics (reference:
DiffuseSG/evaluation/stats.py).  The hot path — degree histograms — drops
networkx in favor of direct adjacency reductions (equivalent for the
undirected simple graphs the reference builds via nx.from_numpy_matrix +
selfloop/isolate removal, stats.py:180-194).  Clustering/spectral keep
networkx/scipy host implementations (off the shipped eval path).
"""
from __future__ import annotations

import numpy as np

from .mmd import compute_mmd, retrieve_kernels


def degree_histograms(adjs: np.ndarray) -> list[np.ndarray]:
    """Per-graph degree histograms, replicating nx.degree_histogram on the
    graph nx.from_numpy_matrix builds (undirected edge iff a[i,j] or a[j,i]
    nonzero; self-loops removed; isolated nodes removed; empty graph -> a
    single degree-0 node)."""
    adjs = np.asarray(adjs)
    b, n, _ = adjs.shape
    sym = (adjs != 0) | (np.swapaxes(adjs, -1, -2) != 0)
    sym &= ~np.eye(n, dtype=bool)[None]
    deg = sym.sum(-1)  # [B, N]
    out = []
    for i in range(b):
        d = deg[i][deg[i] > 0]
        if d.size == 0:
            out.append(np.array([1.0]))  # single isolated node
            continue
        hist = np.bincount(d, minlength=int(d.max()) + 1).astype(np.float64)
        out.append(hist)
    return out


def degree_stats(adjs_ref: np.ndarray, adjs_pred: np.ndarray, kernel="gaussian_tv",
                 sigma: float = 1.0) -> float:
    """Degree-distribution MMD (reference: stats.py:30-65)."""
    ref_hist = degree_histograms(adjs_ref)
    pred_hist = degree_histograms(adjs_pred)
    return compute_mmd(ref_hist, pred_hist, kernel=kernel, sigma=sigma)


def clustering_histograms(adjs: np.ndarray, bins: int = 100) -> list[np.ndarray]:
    """Per-graph clustering-coefficient histograms (reference: stats.py:70-78)."""
    import networkx as nx
    out = []
    for g in adjs_to_graphs(adjs):
        coeffs = list(nx.clustering(g).values())
        hist, _ = np.histogram(coeffs, bins=bins, range=(0.0, 1.0), density=False)
        out.append(hist.astype(np.float64))
    return out


def clustering_stats(adjs_ref, adjs_pred, kernel="gaussian_tv", bins: int = 100,
                     sigma: float = 1.0) -> float:
    return compute_mmd(clustering_histograms(adjs_ref, bins),
                       clustering_histograms(adjs_pred, bins),
                       kernel=kernel, sigma=sigma)


def spectral_histograms(adjs: np.ndarray, n_bins: int = 200) -> list[np.ndarray]:
    """Normalized-Laplacian eigenvalue histograms (reference: stats.py:117-147)."""
    import networkx as nx
    from scipy.linalg import eigvalsh
    out = []
    for g in adjs_to_graphs(adjs):
        lap = nx.normalized_laplacian_matrix(g).todense().astype(float)
        eigs = eigvalsh(lap)
        hist, _ = np.histogram(eigs, bins=n_bins, range=(-1e-5, 2), density=False)
        out.append(hist.astype(np.float64))
    return out


def spectral_stats(adjs_ref, adjs_pred, kernel="gaussian_tv", sigma: float = 1.0) -> float:
    return compute_mmd(spectral_histograms(adjs_ref), spectral_histograms(adjs_pred),
                       kernel=kernel, sigma=sigma)


def adjs_to_graphs(adjs: np.ndarray) -> list:
    """Adjacency batch -> networkx graphs, replicating the reference's
    construction (reference: stats.py:180-194): undirected from the matrix,
    self-loops removed, isolated nodes removed, empty graph -> one node."""
    import networkx as nx
    out = []
    for adj in np.asarray(adjs):
        g = nx.from_numpy_array(adj)
        g.remove_edges_from(list(nx.selfloop_edges(g)))
        g.remove_nodes_from(list(nx.isolates(g)))
        if g.number_of_nodes() < 1:
            g.add_node(1)
        out.append(g)
    return out


def is_lobster_graph(nx_graph) -> bool:
    """Lobster check: a tree that becomes a path after removing leaves twice
    (reference: stats.py:212-239).  Operates on a copy (the reference mutates
    its input, which is why eval_acc_lobster_graph deepcopies)."""
    import copy

    import networkx as nx
    g = copy.deepcopy(nx_graph)
    if not nx.is_tree(g):
        return False
    for _ in range(2):
        leaves = [n for n, d in g.degree() if d == 1]
        g.remove_nodes_from(leaves)
    num_nodes = len(g.nodes())
    sum_degree_one = sum(d for _, d in g.degree() if d == 1)
    sum_degree_two = sum(d for _, d in g.degree() if d == 2)
    if sum_degree_one == 2 and sum_degree_two == 2 * (num_nodes - 2):
        return True
    return sum_degree_one == 0 and sum_degree_two == 0


def eval_acc_lobster_graph(graph_list) -> float:
    """Fraction of graphs that are lobsters (reference: stats.py:197-210)."""
    if not graph_list:
        return 0.0
    return sum(1 for g in graph_list if is_lobster_graph(g)) / float(len(graph_list))


def eval_acc_lobster_batch(adjs: np.ndarray) -> float:
    """Lobster accuracy straight from an adjacency batch."""
    return eval_acc_lobster_graph(adjs_to_graphs(adjs))


_METHODS = {"degree": degree_stats, "cluster": clustering_stats, "spectral": spectral_stats}


def eval_graph_batch(adjs_ref: np.ndarray, adjs_pred: np.ndarray, kernel="gaussian_tv",
                     methods=None) -> dict:
    """Batch adjacency MMDs (reference: stats.py:285-296 eval_torch_batch)."""
    methods = methods or ["degree", "cluster", "spectral"]
    results = {m: _METHODS[m](adjs_ref, adjs_pred, kernel=kernel) for m in methods}
    results["average"] = float(np.mean(list(results.values())))
    return results
