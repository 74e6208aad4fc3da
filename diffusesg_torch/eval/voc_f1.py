"""Pascal-VOC bbox F1 across all generated x reference scene pairs — vectorized.

The port's copy of diffusesg_tpu/eval/voc_f1.py (numpy, no JAX), the
counterpart of the reference F1 pipeline (reference:
DiffuseSG/evaluation/bbox_metrics.py:62-111, 379-440 + the vendored greedy
matcher in evaluation/bbox_utils.py:337-466).  The reference names every box
by its NODE INDEX (bbox_metrics.py:31-43 ``imageName=str(i_bbox)``), which
makes each node its own "image": a detection can only match the ground-truth
box at the SAME node index, with the same class, at IoU >= threshold, and all
confidences are 1.0 (stable sort keeps node order).  That collapses the
greedy matcher into closed-form cumulative sums, vectorized here over
(ref scene, IoU threshold, detection) — replacing the reference's
mp.Pool-over-(i, j)-pairs with pure numpy broadcasting.

F1 semantics reproduced exactly (bbox_metrics.py:80-111):
  * per class: precision = mean of the cumulative precision curve,
    recall = mean of the cumulative recall curve, but forced to 0 when the
    every-point-interpolated AP is 0/NaN
  * F1 = 2PR / max(P+R, 1e-6), zero when both are 0
  * classes = union of classes in the two scenes; weighted mean with
    normalized per-class weights; 0 when the scenes share no class
  * averaged over IoU thresholds linspace(0.05, 0.5, 10)
"""
from __future__ import annotations

import numpy as np

DEFAULT_IOU_RANGE = np.linspace(0.05, 0.5, 10)


def _valid_boxes(bboxes: np.ndarray, flags: np.ndarray) -> np.ndarray:
    """Reference det/GT filter (bbox_metrics.py:33-34): flags and
    x1 >= 0, y1 >= 0, x2 > 0, y2 > 0 (XYX2Y2 args named x,y,w,h)."""
    return (flags.astype(bool) & (bboxes[..., 0] >= 0) & (bboxes[..., 1] >= 0)
            & (bboxes[..., 2] > 0) & (bboxes[..., 3] > 0))


def _aligned_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """IoU between same-index boxes, matching Evaluator.iou exactly
    (bbox_utils.py:703-747) INCLUDING its +1 inclusive-pixel convention —
    a reference quirk: the vendored detector-metrics code assumes integer
    pixel coordinates, but DiffuseSG feeds normalized [0,1] floats, which
    inflates IoU values.  Reproduced as-is for metric parity."""
    x1a, y1a, x2a, y2a = (boxes1[..., k] for k in range(4))
    x1b, y1b, x2b, y2b = (boxes2[..., k] for k in range(4))
    intersects = (x1a <= x2b) & (x1b <= x2a) & (y1a <= y2b) & (y1b <= y2a)
    xA = np.maximum(x1a, x1b)
    yA = np.maximum(y1a, y1b)
    xB = np.minimum(x2a, x2b)
    yB = np.minimum(y2a, y2b)
    inter = (xB - xA + 1.0) * (yB - yA + 1.0)
    area_a = (x2a - x1a + 1.0) * (y2a - y1a + 1.0)
    area_b = (x2b - x1b + 1.0) * (y2b - y1b + 1.0)
    union = area_a + area_b - inter
    return np.where(intersects, inter / np.where(union == 0, 1, union), 0.0)


def compute_bbox_f1(node_bbox_gen, node_types_gen, node_flags_gen,
                    node_bbox_ref, node_types_ref, node_flags_ref,
                    class_weight_ls=None, iou_range=DEFAULT_IOU_RANGE) -> np.ndarray:
    """All-pairs mean-average-F1 matrix.

    @param node_bbox_*: [B, N, 4] xyxy in [0, 1]
    @param node_types_*: [B, N] int class ids
    @param node_flags_*: [B, N] bool
    @param class_weight_ls: None or list of [num_classes] weight arrays
    @return mat_f1: [B_gen, B_ref, num_weights]
    """
    bg = np.asarray(node_bbox_gen, np.float64)
    br = np.asarray(node_bbox_ref, np.float64)
    tg = np.asarray(node_types_gen).astype(np.int64)
    tr = np.asarray(node_types_ref).astype(np.int64)
    fg = _valid_boxes(bg, np.asarray(node_flags_gen))
    fr = _valid_boxes(br, np.asarray(node_flags_ref))

    B_g, N = tg.shape
    B_r = tr.shape[0]
    thrs = np.asarray(iou_range)
    T = len(thrs)
    num_classes = int(max(tg.max(initial=0), tr.max(initial=0))) + 1
    if class_weight_ls is None:
        weight_arrays = [np.ones(num_classes)]
    else:
        weight_arrays = [np.asarray(w, np.float64) for w in class_weight_ls]
        num_classes = max(num_classes, *(len(w) for w in weight_arrays))
        weight_arrays = [np.pad(w, (0, num_classes - len(w))) for w in weight_arrays]
    W = len(weight_arrays)
    weights_mat = np.stack(weight_arrays, axis=0)  # [W, C]

    # per-scene class presence [B, C]
    pres_g = np.zeros((B_g, num_classes), bool)
    pres_r = np.zeros((B_r, num_classes), bool)
    for b in range(B_g):
        pres_g[b, tg[b][fg[b]]] = True
    for b in range(B_r):
        pres_r[b, tr[b][fr[b]]] = True

    # per-(ref scene, class) positive counts [B_r, C]
    npos = np.zeros((B_r, num_classes), np.int64)
    for b in range(B_r):
        cls, cnt = np.unique(tr[b][fr[b]], return_counts=True)
        npos[b, cls] = cnt

    mat_f1 = np.zeros((B_g, B_r, W))
    for g in range(B_g):
        det_mask = fg[g]
        det_idx = np.nonzero(det_mask)[0]
        if det_idx.size == 0:
            continue  # no detections: every class F1 is 0 -> matrix stays 0
        det_cls = tg[g, det_idx]
        # aligned IoU of this gen scene against ALL ref scenes: [B_r, N]
        iou = _aligned_iou(np.broadcast_to(bg[g][None], br.shape), br)  # [B_r, N, ]
        iou_det = iou[:, det_idx]                                        # [B_r, D]
        ref_valid = fr[:, det_idx]                                       # [B_r, D]
        ref_cls = tr[:, det_idx]                                         # [B_r, D]

        # union/intersection class weights for normalization: [B_r, W]
        union_w = (pres_g[g][None] | pres_r) @ weights_mat.T
        has_common = (pres_g[g][None] & pres_r).any(axis=1)              # [B_r]

        f1_num = np.zeros((B_r, T, W))
        for c in np.unique(det_cls):
            sel = det_cls == c                                           # [D]
            D_c = int(sel.sum())
            # TP[b, t, d]: same-index GT exists, same class, IoU >= thr
            base = ref_valid[:, sel] & (ref_cls[:, sel] == c)            # [B_r, Dc]
            tp = base[:, None, :] & (iou_det[:, None, sel] >= thrs[None, :, None])
            tp = tp.astype(np.float64)                                   # [B_r, T, Dc]
            cum_tp = np.cumsum(tp, axis=-1)
            denom = np.arange(1, D_c + 1, dtype=np.float64)
            prec = cum_tp / denom                                        # [B_r, T, Dc]
            npos_c = npos[:, c][:, None, None].astype(np.float64)        # [B_r, 1, 1]
            rec = np.where(npos_c > 0, cum_tp / np.where(npos_c == 0, 1, npos_c), 0.0)
            # every-point interpolation: suffix max of precision
            interp = np.flip(np.maximum.accumulate(np.flip(prec, -1), -1), -1)
            ap = np.where(npos_c[..., 0] > 0,
                          (tp * interp).sum(-1) / np.where(npos_c[..., 0] == 0, 1,
                                                           npos_c[..., 0]), 0.0)  # [B_r, T]
            p_mean = prec.mean(-1)
            r_mean = rec.mean(-1)
            gate = ap > 0.0
            p_mean = np.where(gate, p_mean, 0.0)
            r_mean = np.where(gate, r_mean, 0.0)
            f1 = 2 * p_mean * r_mean / np.maximum(p_mean + r_mean, 1e-6)  # [B_r, T]
            f1_num += f1[:, :, None] * weights_mat[None, None, :, int(c)]

        denom_w = np.where(union_w > 0, union_w, 1.0)                     # [B_r, W]
        per_thr = f1_num / denom_w[:, None, :]                            # [B_r, T, W]
        result = per_thr.mean(axis=1)                                     # [B_r, W]
        result = np.where(has_common[:, None], result, 0.0)
        mat_f1[g] = result
    return mat_f1
