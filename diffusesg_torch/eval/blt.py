"""BLT layout self-consistency metrics, vectorized.

The port's copy of diffusesg_tpu/eval/blt.py (numpy, no JAX), the
counterpart of the vendored layout-blt metrics (reference:
DiffuseSG/evaluation/blt_utils.py): vanilla pairwise IoU, perceptual IoU on a
rasterized canvas, overlap index, and alignment loss.  The reference loops
over box pairs in Python; here everything is pairwise numpy broadcasting.
Boxes are (min_x, min_y, max_x, max_y), normalized to [0, 1].
"""
from __future__ import annotations

import numpy as np


def _pairwise_intersection(layout: np.ndarray) -> np.ndarray:
    """[n, 4] -> [n, n] intersection areas (blt_utils.py:160-182 semantics,
    with max(0, .) applied per side like _get_area)."""
    lt = np.maximum(layout[:, None, :2], layout[None, :, :2])
    rb = np.minimum(layout[:, None, 2:], layout[None, :, 2:])
    wh = np.maximum(rb - lt, 0.0)
    return wh[..., 0] * wh[..., 1]


def _areas(layout: np.ndarray) -> np.ndarray:
    return (np.maximum(layout[:, 2] - layout[:, 0], 0.0)
            * np.maximum(layout[:, 3] - layout[:, 1], 0.0))


def get_average_iou(layout: np.ndarray):
    """Mean positive pairwise IoU (reference: blt_utils.py:61-85); None if no
    overlapping pair."""
    layout = np.asarray(layout, dtype=np.float64).reshape(-1, 4)
    n = len(layout)
    if n < 2:
        return None
    inter = _pairwise_intersection(layout)
    areas = _areas(layout)
    union = areas[:, None] + areas[None, :] - inter
    iou = np.where(np.isclose(union, 0.0), 0.0, inter / np.where(union == 0, 1, union))
    iu = np.triu_indices(n, k=1)
    vals = iou[iu]
    vals = vals[vals > 0.0]
    return float(vals.mean()) if len(vals) else None


def get_overlap_index(layout: np.ndarray):
    """Sum of positive pairwise intersection areas (blt_utils.py:88-111);
    None if no overlaps."""
    layout = np.asarray(layout, dtype=np.float64).reshape(-1, 4)
    n = len(layout)
    if n < 2:
        return None
    inter = _pairwise_intersection(layout)
    iu = np.triu_indices(n, k=1)
    vals = inter[iu]
    vals = vals[vals > 0.0]
    return float(vals.sum()) if len(vals) else None


def get_perceptual_iou(layout: np.ndarray, canvas_size: int = 32):
    """Canvas-rasterized overlap/coverage ratio (blt_utils.py:11-58)."""
    layout = np.asarray(layout, dtype=np.float32).reshape(-1, 4)
    if len(layout) <= 1:
        return None
    assert layout.min() >= 0.0 and layout.max() <= 1.0
    boxes = np.round(layout * canvas_size).astype(int)
    canvas = np.zeros((canvas_size, canvas_size), dtype=np.int32)
    for min_x, min_y, max_x, max_y in boxes:
        canvas[min_x:max_x, min_y:max_y] += 1
    bbox_area = (canvas > 0).sum()
    if bbox_area == 0:
        return None
    return float((canvas > 1).sum() / bbox_area)


def get_alignment_loss(layout: np.ndarray):
    """Min-of-(left/center/right)-similarity alignment loss (blt_utils.py:114-142)."""
    layout = np.asarray(layout, dtype=np.float64).reshape(-1, 4)
    n = len(layout)
    if n <= 1:
        return None
    inf_diag = np.zeros((n, n))
    np.fill_diagonal(inf_diag, np.inf)
    # pairwise |a_i - b_j| means over coordinate groups; reference builds the
    # cartesian product explicitly (blt_utils.py:134-141)
    left = np.abs(layout[None, :, :2] - layout[:, None, :2]).mean(-1) + inf_diag
    right = np.abs(layout[None, :, 2:] - layout[:, None, 2:]).mean(-1) + inf_diag
    centers = np.stack([(layout[:, 0] + layout[:, 2]) / 2,
                        (layout[:, 1] + layout[:, 3]) / 2], axis=-1)
    center = np.abs(centers[None, :, :] - centers[:, None, :]).mean(-1) + inf_diag
    corr = np.stack([left, center, right], axis=2)  # [n, n, 3]
    return float(np.min(corr, axis=(1, 2)).sum())


def compute_bbox_ioa(bbox_ls, node_flags, canvas_size: int = 32,
                     flag_vanilla_iou=False, flag_perceptual_iou=False,
                     flag_overlap=False, flag_alignment=False,
                     return_mean: bool = False):
    """Dispatch over the batch (reference: bbox_metrics.py:443-483)."""
    flags = [flag_vanilla_iou, flag_perceptual_iou, flag_overlap, flag_alignment]
    assert sum(flags) == 1, "exactly one metric flag must be set"
    if flag_vanilla_iou:
        fn = get_average_iou
    elif flag_perceptual_iou:
        fn = lambda l: get_perceptual_iou(l, canvas_size)
    elif flag_overlap:
        fn = get_overlap_index
    else:
        fn = get_alignment_loss

    out = []
    for i, layout in enumerate(np.asarray(bbox_ls)):
        layout = layout[np.asarray(node_flags[i], dtype=bool)]
        val = fn(layout)
        if val is not None:
            out.append(val)
    return float(np.mean(out)) if return_mean else out
