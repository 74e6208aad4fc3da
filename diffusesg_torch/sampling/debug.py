"""Sampling debug helpers.

The port's copy of diffusesg_tpu/sampling/debug.py, the counterpart of the
reference's ``eval_sample_batch``
(reference: DiffuseSG/utils/sampling_utils.py:63-78): quick numeric
delta-norm logging of a sampled adjacency batch against a test batch plus a
grid plot of the generated graphs — the reference's quick-look tool for
pure-graph (adj-only) runs.
"""
from __future__ import annotations

import logging

import numpy as np


def eval_sample_batch(sample_b, test_adj_b, init_adjs, save_dir: str,
                      title: str = "", threshold: float = 0.5) -> dict:
    """Log ||sample - gt|| / ||init - gt|| / ||round(init) - gt|| batch means
    and plot the sampled graphs (sampling_utils.py:63-78).

    All inputs are [B, N, N] arrays or tensors (on any device).  Returns the three
    delta norms so tests (and notebooks) can assert on them.
    """
    from ..utils.visual import plot_graphs_adj

    sample_b, test_adj_b, init_adjs = (
        x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
        for x in (sample_b, test_adj_b, init_adjs))

    def _norm(x):
        return float(np.sqrt((x ** 2).sum(axis=(1, 2))).mean())

    delta = _norm(sample_b - test_adj_b)
    init_delta = _norm(init_adjs - test_adj_b)
    round_init = np.where(init_adjs < threshold, 0.0, 1.0)
    round_init_delta = _norm(round_init - test_adj_b)
    logging.info(
        "sample delta_norm_mean: %.3e | init delta_norm_mean: %.3e"
        " | round init delta_norm_mean: %.3e",
        delta, init_delta, round_init_delta)

    # per-graph node counts from the GT batch (sampling_utils.py:76-77),
    # rendered via flags so the plot titles carry n=
    node_num = (np.abs(test_adj_b).sum(-1) > 1e-5).sum(-1).astype(int)
    n = test_adj_b.shape[1]
    flags = np.arange(n)[None, :] < node_num[:, None]
    plot_graphs_adj(sample_b, node_flags=flags, save_dir=save_dir, title=title)
    return {"delta": delta, "init_delta": init_delta,
            "round_init_delta": round_init_delta}
