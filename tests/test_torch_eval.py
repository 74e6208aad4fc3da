"""The port's metric suite (diffusesg_torch/eval/) against the JAX
package's (diffusesg_tpu/eval/) on the same random decoded scene graphs:
MMD kernels, graph statistics, the four BLT scores, VOC F1 (numpy and
native), the SceneGraphEvaluator methods and the statistics report.  Both
sides are float64 numpy, so they agree to rtol 1e-9.
"""
import json
import os

import numpy as np
import pytest

RTOL = 1e-9
B, N, NODE_TYPES, EDGE_TYPES = 12, 9, 7, 5


def _graphs(seed: int, b: int = B):
    """Decoded scene graphs: int node and edge types, front-packed flags
    (one empty-edged graph), xyxy boxes in [0, 1]."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, N + 1, b)
    flags = np.arange(N)[None, :] < counts[:, None]
    pair = flags[:, :, None] & flags[:, None, :] & ~np.eye(N, dtype=bool)[None]
    adjs = rng.integers(0, EDGE_TYPES, (b, N, N)) * (rng.random((b, N, N)) < 0.3) * pair
    adjs[0] = 0
    types = rng.integers(0, NODE_TYPES, (b, N)) * flags
    lo = rng.uniform(0, 0.7, (b, N, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.3, (b, N, 2))], -1)
    boxes = np.clip(boxes, 0, 1) * flags[..., None]
    return adjs.astype(np.int64), types.astype(np.int64), flags, boxes


def _triplets(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    keys = {(int(a), int(b), int(c)) for a, b, c in rng.integers(0, 5, (30, 3)) if c > 0}
    vals = rng.random(len(keys))
    return dict(zip(sorted(keys), vals / vals.sum()))


def _case(name: str, pkg: str):
    """The metric ``name`` computed by package ``pkg`` on the shared inputs."""
    import importlib
    ev = importlib.import_module(f"{pkg}.eval")
    gen, ref = _graphs(1), _graphs(2, b=10)
    (a_g, t_g, f_g, bb_g), (a_r, t_r, f_r, bb_r) = gen, ref
    rng = np.random.default_rng(3)
    hists = ([rng.random(rng.integers(2, 9)) for _ in range(7)],
             [rng.random(rng.integers(2, 9)) for _ in range(5)])
    evaluator = ev.SceneGraphEvaluator
    weights = [np.ones(NODE_TYPES), np.arange(1, NODE_TYPES + 1.0)]
    if name.startswith("mmd_"):
        return ev.compute_mmd(*hists, kernel=name[4:])
    if name == "degree_stats":
        return ev.degree_stats(a_r, a_g, kernel="gaussian_tv")
    if name == "clustering_stats":
        return ev.clustering_stats(a_r, a_g)
    if name == "spectral_stats":
        return ev.spectral_stats(a_r, a_g)
    if name == "lobster":
        return ev.eval_acc_lobster_batch(a_g)
    if name.startswith("blt_"):
        flag = {"blt_iou": "flag_vanilla_iou", "blt_percp": "flag_perceptual_iou",
                "blt_overlap": "flag_overlap", "blt_alignment": "flag_alignment"}[name]
        return ev.compute_bbox_ioa(bb_g, f_g, canvas_size=32, return_mean=False, **{flag: True})
    if name == "voc_f1_numpy":
        return ev.compute_bbox_f1(bb_g, t_g, f_g, bb_r, t_r, f_r, class_weight_ls=weights)
    if name == "voc_f1_native":
        native = importlib.import_module(f"{pkg}.eval.native")
        out = native.compute_bbox_f1_native(bb_g, t_g, f_g, bb_r, t_r, f_r,
                                            class_weight_ls=weights)
        assert out is not None, "the native VOC F1 library did not build"
        return out
    if name == "node_degree_mmd":
        return evaluator.compute_node_degree_mmd(a_g, a_r, ["gaussian", "gaussian_tv"])
    if name == "node_type_mmd":
        return evaluator.compute_node_type_mmd(t_g, t_r, f_g, f_r, NODE_TYPES,
                                               ["gaussian", "gaussian_emd"])
    if name == "edge_type_mmd":
        return evaluator.compute_edge_type_mmd(a_g, a_r, f_g, f_r, EDGE_TYPES, ["gaussian"])
    if name == "triplet_tv":
        return evaluator.compute_triplet_tv_dist(a_g, t_g, f_g, _triplets(4), _triplets(5))
    if name == "evaluator_bbox_f1":
        return evaluator.compute_bbox_f1(bb_g, t_g, f_g, bb_r, t_r, f_r, class_weight_ls=weights)
    raise KeyError(name)


def _assert_close(got, want, path="result"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, str):
        assert got == want, path
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=RTOL, atol=0, err_msg=path)


METRICS = ["mmd_gaussian", "mmd_gaussian_tv", "mmd_gaussian_emd", "degree_stats",
           "clustering_stats", "spectral_stats", "lobster", "blt_iou", "blt_percp",
           "blt_overlap", "blt_alignment", "voc_f1_numpy", "voc_f1_native", "node_degree_mmd",
           "node_type_mmd", "edge_type_mmd", "triplet_tv", "evaluator_bbox_f1"]


@pytest.mark.parametrize("name", METRICS)
def test_metric_matches_jax(name):
    want = _case(name, "diffusesg_tpu")
    got = _case(name, "diffusesg_torch")
    _assert_close(got, want)
    if not isinstance(want, (dict, tuple)):
        assert np.size(want) and np.isfinite(np.asarray(want, np.float64)).all()


def test_native_f1_equals_numpy_f1():
    """The port's native library is built (into build/native, not beside its
    source) and equals its numpy F1, at the JAX package's own tolerance
    (tests/test_eval.py::test_native_f1_matches_numpy)."""
    from diffusesg_torch.eval import compute_bbox_f1
    from diffusesg_torch.eval.native import compute_bbox_f1_native, get_lib
    from diffusesg_torch.utils.native_build import BUILD_ROOT
    (a_g, t_g, f_g, bb_g), (a_r, t_r, f_r, bb_r) = _graphs(6), _graphs(7)
    assert get_lib() is not None
    assert os.path.dirname(os.path.dirname(get_lib()._name)) == str(BUILD_ROOT)
    np.testing.assert_allclose(compute_bbox_f1_native(bb_g, t_g, f_g, bb_r, t_r, f_r),
                               compute_bbox_f1(bb_g, t_g, f_g, bb_r, t_r, f_r),
                               rtol=1e-12, atol=1e-12)


def test_sg_statistics_report_matches_jax(tmp_path, monkeypatch):
    """compute_sg_statistics: the same text report and JSON summary, from
    the gt tensors and from pkl records (the plots are not compared)."""
    import diffusesg_tpu.eval.sg_statistics as jstat
    import diffusesg_torch.eval.sg_statistics as tstat
    monkeypatch.setattr(jstat, "_plot_report", lambda *a, **k: None)
    monkeypatch.setattr(tstat, "_plot_report", lambda *a, **k: None)
    (a_g, t_g, f_g, bb_g), (a_r, t_r, f_r, bb_r) = _graphs(8), _graphs(9)
    payload = dict(samples_a=a_g, samples_x=t_g, samples_node_flags=f_g, samples_x_bbox=bb_g,
                   gt_a=a_r, gt_x=t_r, gt_node_flags=f_r, gt_x_bbox=bb_r)
    idx_to_word = {"ind_to_classes": [f"c{i}" for i in range(NODE_TYPES - 1)],
                   "ind_to_predicates": [f"p{i}" for i in range(EDGE_TYPES)]}
    pkl = [{"node_labels": list(t_r[i][f_r[i]]),
            "edge_map": a_r[i][np.ix_(f_r[i], f_r[i])]} for i in range(len(t_r))]
    for records in ([], pkl):
        outs = {}
        for tag, mod in (("jax", jstat), ("port", tstat)):
            d = tmp_path / f"{tag}_{len(records)}"
            summary = mod.compute_sg_statistics(payload, records, idx_to_word, str(d))
            outs[tag] = (summary, (d / "sg_statistics.txt").read_text(),
                         json.loads((d / "generated_stats.json").read_text()))
        assert outs["port"][1] == outs["jax"][1] and len(outs["port"][1].splitlines()) > 20
        _assert_close(outs["port"][2], outs["jax"][2])
        _assert_close(*(json.loads(json.dumps(outs[k][0])) for k in ("port", "jax")))
