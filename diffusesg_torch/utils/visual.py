"""Scene-graph and layout visualization.

The port's copy of diffusesg_tpu/utils/visual.py, the counterpart of the
reference visual layer (reference: DiffuseSG/utils/visual_utils.py:
plot_graphs_adj :35-126, plot_scene_graph :129-224, plot_scene_graph_bbox
:227-398).  matplotlib (Agg backend), networkx and PIL are imported inside
the functions that draw, so the module imports where they are absent; a
drawing function then raises ImportError, which the orchestrator's plotting
``try`` turns into a warning.
"""
from __future__ import annotations

import os

import numpy as np


def _pyplot():
    """matplotlib.pyplot on the headless Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_graphs_adj(adjs, node_flags=None, save_dir=".", title="graphs.png",
                    num_plots: int = 8):
    """Grid of adjacency heatmaps (reference: visual_utils.py:35-126)."""
    plt = _pyplot()
    adjs = np.asarray(adjs)
    k = min(num_plots, len(adjs))
    cols = min(4, k)
    rows = -(-k // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows), squeeze=False)
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        ax.axis("off")
        if i < k:
            ax.imshow(adjs[i], cmap="viridis")
            if node_flags is not None:
                n = int(np.asarray(node_flags[i]).astype(bool).sum())
                ax.set_title(f"n={n}", fontsize=8)
    os.makedirs(save_dir, exist_ok=True)
    fig.savefig(os.path.join(save_dir, title), dpi=100, bbox_inches="tight")
    plt.close(fig)


def draw_curved_edge_labels(pos, edge_labels, ax, rad: float = 0.1,
                            font_size: int = 5):
    """Place edge labels on the arc3 curve the edges are drawn with.

    Straight-midpoint labels (networkx default) collapse onto each other for
    bidirectional pairs (u->v and v->u); evaluating the quadratic Bezier the
    FancyArrowPatch actually draws at t=0.5 separates the two directions,
    the role of the reference's vendored helper
    (reference: utils/nx_multi_edge.py draw_networkx_multi_edge_labels).
    """
    for (u, v), label in edge_labels.items():
        (x1, y1), (x2, y2) = pos[u], pos[v]
        # matplotlib arc3: control point sits rad*|P2-P0| perpendicular to
        # the chord at its midpoint; Bezier(t=0.5) = midpoint + rad/2 * perp
        mx, my = (x1 + x2) / 2.0, (y1 + y2) / 2.0
        dx, dy = x2 - x1, y2 - y1
        lx, ly = mx + rad * 0.5 * dy, my - rad * 0.5 * dx
        ax.text(lx, ly, label, fontsize=font_size, ha="center", va="center",
                bbox=dict(boxstyle="round,pad=0.1", fc="white", ec="none",
                          alpha=0.7), zorder=3)


def plot_scene_graph(node_types, adjs, node_flags, idx_to_word, save_dir=".",
                     title="scene_graphs.png", flag_bin_edge: bool = False,
                     num_plots: int = 8):
    """Grid of directed scene graphs with word labels
    (reference: visual_utils.py:129-224)."""
    plt = _pyplot()
    import networkx as nx
    node_types = np.asarray(node_types)
    adjs = np.asarray(adjs)
    flags = np.asarray(node_flags).astype(bool)
    classes = idx_to_word.get("ind_to_classes", [])
    preds = idx_to_word.get("ind_to_predicates", [])

    k = min(num_plots, len(adjs))
    cols = min(4, k)
    rows = -(-k // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 5 * rows), squeeze=False)
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        ax.axis("off")
        if i >= k:
            continue
        n = int(flags[i].sum())
        g = nx.DiGraph()
        for v in range(n):
            t = int(node_types[i, v])
            name = classes[t] if t < len(classes) else str(t)
            g.add_node(v, label=f"{name}.{v}")
        edge_labels = {}
        for u in range(n):
            for v in range(n):
                e = int(adjs[i, u, v])
                if e > 0 and u != v:
                    g.add_edge(u, v)
                    lab = "edge" if flag_bin_edge else (
                        preds[e] if e < len(preds) else str(e))
                    edge_labels[(u, v)] = lab
        if g.number_of_nodes() == 0:
            continue
        pos = nx.spring_layout(g, seed=0)
        nx.draw_networkx_nodes(g, pos, ax=ax, node_size=300, node_color="#9fc5e8")
        nx.draw_networkx_labels(g, pos, labels=nx.get_node_attributes(g, "label"),
                                ax=ax, font_size=6)
        nx.draw_networkx_edges(g, pos, ax=ax, arrows=True,
                               connectionstyle="arc3,rad=0.1")
        draw_curved_edge_labels(pos, edge_labels, ax, rad=0.1, font_size=5)
    os.makedirs(save_dir, exist_ok=True)
    fig.savefig(os.path.join(save_dir, title), dpi=100, bbox_inches="tight")
    plt.close(fig)


# per-type color table, same palette as the reference renderer
# (reference: visual_utils.py:251-263 colors_per_type) — 55 named CSS colors
# indexed by the type's position among the graph's unique types
COLORS_PER_TYPE = [
    "Black", "Brown", "CadetBlue", "Chocolate", "Coral",
    "Crimson", "DarkBlue", "DarkCyan", "DarkGoldenRod", "DarkGray",
    "DarkGreen", "DarkMagenta", "DarkOliveGreen", "DarkOrange", "DarkOrchid",
    "DarkRed", "DarkSalmon", "DarkSeaGreen", "DarkSlateBlue", "DarkSlateGray",
    "DarkTurquoise", "DarkViolet", "DeepPink", "DeepSkyBlue", "DimGray",
    "DodgerBlue", "FireBrick", "ForestGreen", "GoldenRod", "Green",
    "HotPink", "IndianRed", "Indigo", "Khaki", "LightCoral",
    "LightSlateGray", "LightSteelBlue", "Maroon", "MediumBlue", "MediumSeaGreen",
    "MediumSlateBlue", "MediumVioletRed", "MidnightBlue", "Navy", "Olive",
    "OliveDrab", "OrangeRed", "Purple", "RoyalBlue", "SaddleBrown",
    "SeaGreen", "Sienna", "SlateBlue", "SteelBlue", "Teal"]


def _label_font(size: int = 14):
    """A truetype font for PIL label chips; Helvetica isn't shipped on this
    image, so use matplotlib's bundled DejaVu Sans (reference loads
    utils/Helvetica.ttf, visual_utils.py:313-315)."""
    from PIL import ImageFont
    try:
        from matplotlib import font_manager
        return ImageFont.truetype(font_manager.findfont("DejaVu Sans"), size)
    except Exception:
        return ImageFont.load_default()


def bbox_canvas(types_row, bbox_row, n_valid, classes,
                canvas_width: int = 400, canvas_height: int = 400):
    """Reference-fidelity PIL layout canvas (visual_utils.py:300-320): white
    400x400, per-type colored box outlines, a filled 50x10 label chip at the
    top-left corner of each box with the 'word.idx' node label in white.

    cxcywh boxes in [0, 1]; degenerate (empty after clipping) boxes are
    skipped, like the reference's ``x2 > x1 and y2 > y1`` guard."""
    from PIL import Image, ImageDraw
    canvas = Image.new("RGB", (canvas_width, canvas_height), "white")
    draw = ImageDraw.Draw(canvas)
    font = _label_font(14)
    type_ls = [int(t) for t in np.asarray(types_row)[:n_valid]]
    # deterministic per-graph color index (reference uses list(set(...)),
    # whose order is interpreter-dependent; sorted-unique is stable)
    uniq = sorted(set(type_ls))
    for j in range(n_valid):
        cx, cy, w, h = (float(v) for v in np.asarray(bbox_row)[j][:4])
        x1 = min(max(cx - w / 2, 0.0), 1.0) * canvas_width
        y1 = min(max(cy - h / 2, 0.0), 1.0) * canvas_height
        x2 = min(max(cx + w / 2, 0.0), 1.0) * canvas_width
        y2 = min(max(cy + h / 2, 0.0), 1.0) * canvas_height
        if x2 <= x1 or y2 <= y1:
            continue
        color = COLORS_PER_TYPE[uniq.index(type_ls[j]) % len(COLORS_PER_TYPE)]
        name = classes[type_ls[j]] if type_ls[j] < len(classes) else str(type_ls[j])
        draw.rectangle(((x1, y1), (x2, y2)), outline=color)
        draw.rectangle(((x1, y1), (x1 + 50, y1 + 10)), fill=color)
        draw.text((x1, y1), f"{name}{j}", fill="white", font=font)
    return canvas


def _draw_nx_scene_graph(ax, types_row, adj_row, n_valid, classes, preds):
    """Circular-layout digraph panel (reference: visual_utils.py:330-358):
    pink size-500 nodes, 'word.idx' labels, red edge labels, arc3 curves for
    bidirectional pairs."""
    import networkx as nx
    names = [(classes[int(types_row[v])] if int(types_row[v]) < len(classes)
              else str(int(types_row[v]))) + str(v) for v in range(n_valid)]
    g = nx.DiGraph()
    g.add_nodes_from(names)
    pos = nx.circular_layout(g)
    node_size = 500
    nx.draw_networkx(g, pos, ax=ax, node_size=node_size, font_size=12,
                     font_color="black", node_color="pink",
                     labels={node: node for node in g.nodes()})
    subj_idx, obj_idx = np.where(np.asarray(adj_row)[:n_valid, :n_valid])
    for u, v in zip(subj_idx, obj_idx):
        if u == v:
            continue
        e = int(np.asarray(adj_row)[u, v])
        g.add_edge(names[u], names[v],
                   label=preds[e] if e < len(preds) else str(e))
    curved = [e for e in g.edges() if tuple(reversed(e)) in g.edges()]
    straight = list(set(g.edges()) - set(curved))
    arc_rad = 0.12
    nx.draw_networkx_edges(g, pos, ax=ax, edgelist=straight, edge_color="black",
                           width=1, node_size=node_size)
    nx.draw_networkx_edges(g, pos, ax=ax, edgelist=curved, edge_color="black",
                           width=1, node_size=node_size,
                           connectionstyle=f"arc3, rad = {arc_rad}")
    labels = nx.get_edge_attributes(g, "label")
    draw_curved_edge_labels(pos, {e: labels[e] for e in curved}, ax,
                            rad=arc_rad, font_size=8)
    nx.draw_networkx_edge_labels(
        g, pos, ax=ax, edge_labels={e: labels[e] for e in straight},
        rotate=True, font_color="red", font_size=8)
    if pos:
        xs = [p[0] for p in pos.values()]
        margin = (max(xs) - min(xs)) * 0.3 if len(xs) > 1 else 1.0
        ax.set_xlim(min(xs) - margin, max(xs) + margin)


def plot_scene_graph_bbox(node_types, bboxes, adjs, node_types_gt, bboxes_gt,
                          adjs_gt, mat_f1, node_flags, node_flags_gt, idx_to_word,
                          save_dir=".", title="bbox.png", num_plots: int = 1):
    """Generated layouts beside their best-F1 retrieved GT layouts, at
    reference artifact fidelity (reference: visual_utils.py:227-398): each of
    ``num_plots`` output files is a 2x4 panel composition — two scene graphs
    (descending best-F1 order) x [gen bbox canvas | gen digraph | retrieved
    GT canvas | GT digraph] — plus one ``f1_score_distribution.png``
    histogram of per-sample best-matching F1 (overwritten per call, as the
    reference does)."""
    plt = _pyplot()
    node_types = np.asarray(node_types)
    bboxes = np.asarray(bboxes)
    adjs = np.asarray(adjs)
    node_types_gt = np.asarray(node_types_gt)
    bboxes_gt = np.asarray(bboxes_gt)
    adjs_gt = np.asarray(adjs_gt)
    flags = np.asarray(node_flags).astype(bool)
    flags_gt = np.asarray(node_flags_gt).astype(bool)
    classes = idx_to_word.get("ind_to_classes", [])
    preds = idx_to_word.get("ind_to_predicates", [])
    mat_f1 = np.asarray(mat_f1)
    num_graphs = len(node_types)
    os.makedirs(save_dir, exist_ok=True)

    # best-matches-first ordering (reference: visual_utils.py:265)
    plot_order = np.argsort(mat_f1.max(axis=-1))[::-1]

    num_fig_row = 2
    counter = -1
    for i in range(num_plots):
        idx_start = num_fig_row * i
        if idx_start + 1 >= num_graphs:
            continue
        fig = plt.figure(figsize=(30, 10))
        subfigs = fig.subfigures(num_fig_row, 4)
        for row in range(num_fig_row):
            counter += 1
            gi = int(plot_order[counter])
            n = int(flags[gi].sum())
            best = int(np.argmax(mat_f1[gi])) if mat_f1.size else 0
            n_gt = int(flags_gt[best].sum())

            ax = subfigs[row][0].subplots()
            ax.imshow(bbox_canvas(node_types[gi], bboxes[gi], n, classes))
            ax.set_xticks([]); ax.set_yticks([])
            ax.set_title(f"Generated scene graph {counter:03d}/{num_graphs:03d}",
                         loc="left", fontsize=18)
            _draw_nx_scene_graph(subfigs[row][1].subplots(), node_types[gi],
                                 adjs[gi], n, classes, preds)

            ax = subfigs[row][2].subplots()
            ax.imshow(bbox_canvas(node_types_gt[best], bboxes_gt[best], n_gt,
                                  classes))
            ax.set_xticks([]); ax.set_yticks([])
            ax.set_title(f"Closest GT scene graph: F1: "
                         f"{float(mat_f1[gi].max()):.3f}, ID: {best:d}",
                         loc="left", fontsize=18)
            _draw_nx_scene_graph(subfigs[row][3].subplots(), node_types_gt[best],
                                 adjs_gt[best], n_gt, classes, preds)
        fig.savefig(os.path.join(save_dir, f"{i:02d}_{title}"),
                    bbox_inches="tight", dpi=150)
        plt.close(fig)

    # F1-score distribution histogram (reference: visual_utils.py:391-398)
    fig = plt.figure()
    ax = plt.gca()
    ax.hist(mat_f1.max(axis=-1), bins=100)
    ax.set_xlabel("Best-matching F1 score")
    ax.set_ylabel("Frequency")
    ax.set_title("F1 score distribution")
    fig.savefig(os.path.join(save_dir, "f1_score_distribution.png"),
                bbox_inches="tight", dpi=300)
    plt.close(fig)
