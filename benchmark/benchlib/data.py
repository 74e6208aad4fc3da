"""Synthetic scene graphs in the published configs' encoding, from a seed.

The scheme of the program's synthetic generator (``data/synthetic.py``:
Dirichlet popularity of node and edge types, sparse preferential directed
edges, boxes whose size follows the type's popularity), drawn for a whole
pool at once with numpy so that a pool of thousands of graphs takes well
under a second.  Encoded as the program's dataset encodes the VG and
COCO-Stuff pickles (ddpm): a type t of T as 2 t / (T - 1) - 1, a box
(cx, cy, w, h) in [0, 1] as 2 b - 1, padded slots zero.
"""
from __future__ import annotations

import numpy as np

from .noise import key

POOL_STREAM = 2


def node_counts(rng, graphs: int, lo: int, hi: int) -> np.ndarray:
    """Nodes per graph, uniform in lo..hi."""
    return rng.integers(lo, hi + 1, size=graphs)


def flags_of(counts, n: int) -> np.ndarray:
    return np.arange(n)[None, :] < np.asarray(counts)[:, None]


def pool(seed: int, graphs: int, n: int, node_types: int, edge_types: int, mix: dict):
    """(adjs f32 [G, N, N], nodes f32 [G, N, 5], flags bool [G, N])."""
    rng = np.random.default_rng(key(seed, POOL_STREAM))
    counts = node_counts(rng, graphs, mix["nodes_min"], n)
    flags = flags_of(counts, n)
    pairs = flags[:, :, None] & flags[:, None, :]
    node_pop = rng.dirichlet(np.full(node_types, mix["node_alpha"]))
    edge_pop = rng.dirichlet(np.full(edge_types - 1, mix["edge_alpha"]))
    labels = rng.choice(node_types, size=(graphs, n), p=node_pop)
    p_edge = np.minimum(0.9, mix["edges_per_node"] / np.maximum(counts - 1, 1))
    on = (rng.random((graphs, n, n)) < p_edge[:, None, None]) & pairs & ~np.eye(n, dtype=bool)
    types = np.where(on, 1 + rng.choice(edge_types - 1, size=(graphs, n, n), p=edge_pop), 0)
    cx, cy = rng.uniform(0.2, 0.8, size=(2, graphs, n))
    scale = 0.1 + 0.5 * node_pop[labels] / node_pop.max()
    w = np.clip(rng.uniform(0.05, 0.4, size=(graphs, n)) * (0.5 + scale), 0.02, 0.95)
    h = np.clip(rng.uniform(0.05, 0.4, size=(graphs, n)) * (0.5 + scale), 0.02, 0.95)
    w = np.minimum(w, 2 * np.minimum(cx, 1 - cx))
    h = np.minimum(h, 2 * np.minimum(cy, 1 - cy))
    boxes = np.stack([cx, cy, w, h], axis=-1)
    adjs = np.where(pairs, 2.0 * types / (edge_types - 1) - 1.0, 0.0).astype(np.float32)
    node = np.where(flags, 2.0 * labels / (node_types - 1) - 1.0, 0.0)
    nodes = np.concatenate([node[..., None], np.where(flags[..., None], 2 * boxes - 1, 0.0)],
                           axis=-1).astype(np.float32)
    return adjs, nodes, flags


def shard_rows(rows: int, loader_seed: int, epoch: int, rank: int, ranks: int) -> np.ndarray:
    """The rows a rank reads in an epoch, in order: the pool shuffled by a
    ``RandomState`` of the loader's seed plus the epoch, wrapped to a
    multiple of the ranks, every ``ranks``-th row from ``rank`` (the
    reference's ``DistributedSampler`` with the seeded shuffle)."""
    idx = np.arange(rows)
    np.random.RandomState(loader_seed + epoch).shuffle(idx)
    total = -(-rows // ranks) * ranks
    if total > rows:
        idx = np.concatenate([idx, idx[:total - rows]])
    return idx[rank::ranks]


def step_rows(rows_in_pool: int, loader_seed: int, step: int, rank: int, ranks: int,
              batch: int) -> np.ndarray:
    """The rows of a rank's batch at training step ``step`` (epochs of whole
    batches, each reshuffled)."""
    per_epoch = -(-rows_in_pool // ranks) // batch
    if per_epoch * batch * ranks != rows_in_pool:
        raise ValueError("the pool holds a whole number of global batches")
    idx = shard_rows(rows_in_pool, loader_seed, step // per_epoch, rank, ranks)
    j = step % per_epoch
    return idx[j * batch:(j + 1) * batch]
