"""The work of one denoiser forward, counted from the model's shapes.

A frozen copy of the analytic count that DiffuseSG's model code states in
its ``flops()`` methods (ubc-vision/DiffuseSG,
model/diffusesg/diffusesg.py): per Swin block the qkv and projection
products, the two window-attention products and the MLP; patch merge and
breakup; patch embedding and read-out; the two read-out MLPs.  A
multiply-add counts as two operations.  It counts what the shapes need,
never the launches or recomputations a program happens to make, so a
later change that fuses or splits kernels reads the same work.
"""
from __future__ import annotations

MLP_RATIO = 4


def forward_flops(model_config: dict) -> int:
    """Operations of one denoiser forward over one graph (batch 1), with the
    self-conditioning input channels that the published configs feed."""
    ds, m, tr = model_config["dataset"], model_config["model"], model_config["train"]
    # ddpm encodings: one edge channel; a node type channel and 4 box channels,
    # tiled to both ends of each pair
    in_chans = 1 + 2 * (1 + 4)
    if tr["self_cond"]:
        in_chans *= 2
    out_adj, out_node = 1, 1 + 4
    n, p = ds["max_node_num"], m["patch_size"]
    dim0, depths, window = m["feature_dims"][-1], list(m["depths"]), m["window_size"]

    res = n // p
    total = res * res * (p * p * in_chans) * dim0 * 2
    total += res * res * dim0 * dim0 * 2 * 3

    def block(L, c, w):
        attn_mm = L * (3 * c * c + c * c) * 2
        nw = L // (w * w)
        attn = nw * 2 * (w * w) * (w * w) * c * 2
        mlp = L * 2 * c * int(MLP_RATIO * c) * 2
        return attn_mm + attn + mlp

    for i, depth in enumerate(depths):
        c, r = dim0 * 2 ** i, res // 2 ** i
        w = min(window, r)
        total += depth * block(r * r, c, w) * 2          # down and mirrored up
        if i < len(depths) - 1:
            total += (r // 2) ** 2 * 4 * c * 2 * c * 2   # merge and breakup
    total += n * n * dim0 * (dim0 + out_adj) * 2
    total += n * dim0 * (dim0 + out_node) * 2
    return int(total)
