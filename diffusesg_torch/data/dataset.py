"""Scene-graph dataset: pickle -> packed, padded, encoded numpy arrays.

Counterpart of diffusesg_tpu/data/dataset.py, with the encodings taken by the
port's torch attribute codec on the CPU.  Host-side counterpart of the
reference data pipeline
(reference: DiffuseSG/utils/dataloader.py:56-335).  The pickle schema is a
list of dicts with keys 'node_labels' [n], 'edge_map' [n, n],
'node_bboxes_xcyc' [n, 4] in [0, 1], 'image_id'
(reference: dataloader.py:99-116).  Tensorization is done once into dense
numpy arrays (the XLA-friendly layout); per-batch encoding beyond one_hot is
precomputed exactly like the reference (one_hot stays deferred to the step
to save memory, dataloader.py:185-200).

Layout: channels-LAST ([B, N, N, C] adjs), vs the reference's [B, C, N, N].
"""
from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import time

import numpy as np
import torch

from ..models.channels import dataset_constants
from ..ops.attribute_code import (
    attribute_converter, reshape_node_attr_vec_to_mat,
)


@dataclasses.dataclass
class SceneGraphData:
    """Packed dataset tensors + evaluation side-information."""
    adjs: np.ndarray          # [B, N, N] or [B, N, N, C]
    nodes: np.ndarray         # [B, N] or [B, N, C]
    node_flags: np.ndarray    # [B, N] bool (or [B, N, N] in node-only mode)
    image_ids: np.ndarray     # [B]
    pkl_data: list            # raw graph dicts
    num_node_type: int
    num_edge_type: int

    def __len__(self):
        return len(self.adjs)


@dataclasses.dataclass
class SceneGraphBundle:
    """What load_data returns: train/test splits + attached statistics
    (reference: dataloader.py:36-53)."""
    train: SceneGraphData
    test: SceneGraphData
    train_triplet_dict: dict
    test_triplet_dict: dict
    bbox_area_stat: dict
    bbox_freq_stat: dict
    idx_to_word: dict


def build_tensors(data: list[dict], max_node_num: int,
                  num_node_attr_type: int, num_edge_attr_type: int,
                  node_encoding: str, edge_encoding: str,
                  flag_node_only: bool = False, flag_binary_edge: bool = False,
                  subset: int | None = None) -> SceneGraphData:
    """Pickle records -> padded/encoded arrays (reference: dataloader.py:63-259)."""
    if subset is not None:
        data = data[:subset]

    node_ls = [np.asarray(item["node_labels"]) for item in data]
    if flag_node_only:
        adj_ls = None
    elif "edge_map" in data[0]:
        adj_ls = [np.asarray(item["edge_map"]) for item in data]
    else:
        adj_ls = [np.zeros((len(n), len(n))) for n in node_ls]
    bbox_ls = ([np.asarray(item["node_bboxes_xcyc"]) for item in data]
               if "node_bboxes_xcyc" in data[0] else None)
    image_ids = np.asarray([item.get("image_id", -1) for item in data], dtype=np.int64)

    true_max = max(len(n) for n in node_ls)
    if not flag_node_only:
        assert true_max <= max_node_num, f"{true_max} > {max_node_num}"
    else:
        assert int(np.ceil(np.sqrt(true_max))) <= max_node_num

    if adj_ls is not None:
        for adj in adj_ls:  # no-self-loop invariant (dataloader.py:130-133)
            diag = np.unique(np.diag(adj))
            assert len(diag) == 1 and diag[0] == 0

    pad_len = max_node_num ** 2 if flag_node_only else max_node_num
    b = len(node_ls)
    node_pad = np.zeros((b, pad_len), dtype=np.float32)
    node_flags = np.zeros((b, pad_len), dtype=np.float32)
    adj_pad = np.zeros((b, pad_len, pad_len), dtype=np.float32)
    bbox_pad = np.zeros((b, pad_len, 4), dtype=np.float32) if bbox_ls is not None else None

    for i, node in enumerate(node_ls):
        k = len(node)
        node_pad[i, :k] = node
        node_flags[i, :k] = 1.0
        if adj_ls is not None:
            adj = adj_ls[i]
            if flag_binary_edge:
                adj = np.where(adj > 0, 1, 0)
            adj_pad[i, :k, :k] = adj
        if bbox_ls is not None:
            bb = bbox_ls[i]
            assert (0 <= bb).all() and (bb <= 1).all()
            assert len(bb) == k
            bbox_pad[i, :k] = (bb - 0.5) * 2  # [0,1] -> [-1,1] (dataloader.py:168)

    flags = torch.from_numpy(node_flags.astype(bool))
    node_t = torch.from_numpy(node_pad)
    adj_t = torch.from_numpy(adj_pad)

    # encode (one_hot deferred to the step, reference dataloader.py:185-200)
    if node_encoding == "one_hot":
        node_out = node_t
    else:
        node_out = attribute_converter(node_t, flags, "int", node_encoding,
                                       num_node_attr_type, flag_nodes=True,
                                       flag_in_ddpm_range=False, flag_out_ddpm_range=True)
    if flag_node_only:
        adj_out = adj_t
    elif edge_encoding == "one_hot":
        adj_out = adj_t
    else:
        adj_out = attribute_converter(
            adj_t, flags, "int", edge_encoding,
            num_edge_attr_type if not flag_binary_edge else 2, flag_adjs=True,
            flag_in_ddpm_range=False, flag_out_ddpm_range=True)

    flags_out = flags
    if flag_node_only:
        # pack node attrs onto the adj grid (dataloader.py:204-218)
        adj_out, adj_flags = reshape_node_attr_vec_to_mat(node_out, flags, max_node_num)
        node_out = torch.zeros((b, max_node_num), dtype=torch.float32)
        flags_out = adj_flags

    if bbox_pad is not None:
        bbox_t = torch.from_numpy(bbox_pad)
        if not flag_node_only:
            # attach bbox to node channels (dataloader.py:221-233)
            if node_encoding in ("one_hot", "ddpm"):
                node_out = torch.cat([node_out[..., None], bbox_t], dim=-1)
            elif node_encoding == "bits":
                node_out = torch.cat([node_out, bbox_t], dim=-1)
            else:
                raise NotImplementedError
        else:
            # attach bbox to adj channels (dataloader.py:234-247), channels-last
            adj_bbox, _ = reshape_node_attr_vec_to_mat(bbox_t, flags, max_node_num)
            if node_encoding == "bits":
                adj_out = torch.cat([adj_out, adj_bbox], dim=-1)
            elif node_encoding == "ddpm":
                adj_out = torch.cat([adj_out[..., None], adj_bbox], dim=-1)
            else:
                raise NotImplementedError

    if flag_binary_edge and adj_out.ndim == 4 and adj_out.shape[-1] == 1:
        adj_out = adj_out[..., 0]  # (dataloader.py:248-254)

    return SceneGraphData(
        adjs=adj_out.numpy(), nodes=node_out.numpy(),
        node_flags=flags_out.numpy(), image_ids=image_ids, pkl_data=data,
        num_node_type=num_node_attr_type, num_edge_type=num_edge_attr_type)


_DATASET_PATHS = {
    "visual_genome": dict(
        train_pkl="data_scenegraph/visual_genome/training_data_bbox_dbox32_np.pkl",
        test_pkl="data_scenegraph/visual_genome/validation_data_bbox_dbox32_np.pkl",
        train_stats="data_scenegraph/visual_genome/training_data_bbox_area_stats.pkl",
        test_stats="data_scenegraph/visual_genome/validation_data_bbox_area_stats.pkl",
        idx_to_word="data_scenegraph/visual_genome/idx_to_word.pkl"),
    "coco_stuff": dict(
        train_pkl="data_scenegraph/coco_stuff/coco_blt_training_data_dbox32_np.pkl",
        test_pkl="data_scenegraph/coco_stuff/coco_blt_validation_data_dbox32_np.pkl",
        train_stats="data_scenegraph/coco_stuff/coco_blt_training_data_area_stats.pkl",
        test_stats="data_scenegraph/coco_stuff/coco_blt_validation_data_area_stats.pkl",
        idx_to_word="data_scenegraph/coco_stuff/idx_to_word.pkl"),
}


def _triplet_dict_from_stats(stats: dict) -> dict:
    if "triplet_dict_sorted" in stats:
        return stats["triplet_dict_sorted"]
    return dict(zip(stats["triplet_key_sorted_list"], stats["triplet_value_sorted_list"]))


def _area_stat_from_stats(stats: dict) -> dict:
    if "node_bbox_area_avg_dict_sorted" in stats:
        return stats["node_bbox_area_avg_dict_sorted"]
    return dict(zip(stats["node_bbox_area_avg_key_sorted_list"],
                    stats["node_bbox_area_avg_value_sorted_list"]))


def _freq_stat_from_stats(stats: dict) -> dict:
    if "node_dict_sorted" in stats:
        return stats["node_dict_sorted"]
    return dict(zip(stats["node_key_sorted_list"], stats["node_value_sorted_list"]))


def load_data(config, eval_mode: bool = False, data_root: str = ".") -> SceneGraphBundle:
    """Full dataset load (reference: dataloader.py:17-53,261-335).

    Looks for the reference pickle layout under ``data_root``; if absent and
    the config carries ``dataset.synthetic: true`` (or the files are missing),
    falls back to the deterministic synthetic generator so the full pipeline
    runs without the (unreleased) dataset archive.
    """
    t0 = time.time()
    name = config.dataset.name
    num_node_type, num_edge_type, _ = dataset_constants(name)
    key = "visual_genome" if "visual_genome" in name else "coco_stuff"
    paths = {k: os.path.join(data_root, v) for k, v in _DATASET_PATHS[key].items()}
    # custom test pickle override (reference: dataloader.py:265-274, incl.
    # the layout2img unknown-type bump for VG)
    custom_test_pkl = config.test.get("test_pkl") if "test" in config else None
    if custom_test_pkl:
        paths["test_pkl"] = custom_test_pkl
        if "visual_genome" in name and "layout2img" in custom_test_pkl:
            num_node_type = 151

    use_synthetic = bool(config.dataset.get("synthetic", False)) or \
        not os.path.exists(paths["train_pkl"])
    if use_synthetic:
        from .synthetic import synthetic_bundle_dicts
        logging.info("dataset pickles not found under %s - using synthetic data", data_root)
        # generator knobs beyond the geometry: population size (the
        # generalization-regime runs train on thousands of graphs with a
        # genuinely held-out test split) and popularity concentration
        # (smaller alphas -> COCO-like triplet reuse; synthetic.py)
        synth_kw = dict(
            num_train=int(config.dataset.get("synthetic_num_train", 256)),
            num_test=int(config.dataset.get("synthetic_num_test", 128)),
            # opt-in within-graph type/size clustering (Dirichlet
            # concentration; see synthetic.synthetic_scene_graphs) — makes
            # graph halves mutually informative so conditional completion
            # is measurably better than unconditional sampling
            per_graph_alpha=config.dataset.get("synthetic_per_graph_alpha", None),
            node_alpha=float(config.dataset.get("synthetic_node_alpha", 0.3)),
            edge_alpha=float(config.dataset.get("synthetic_edge_alpha", 0.5)))
        # the generator is deterministic in (name, max_node_num, seed,
        # synth_kw, generator version) but costs minutes of pure-python pair
        # loops at N=64; an opt-in disk cache (DSG_SYNTH_CACHE_DIR) makes
        # relaunches/resumes of long TPU quality runs near-instant
        _cache_dir = os.environ.get("DSG_SYNTH_CACHE_DIR")
        _cache_path = None
        if _cache_dir:
            from .synthetic import SYNTH_CACHE_VERSION
            _key = (f"{name}_n{config.dataset.max_node_num}_s{config.seed}"
                    f"_a{synth_kw['per_graph_alpha']}")
            # non-default knobs extend the key; the historical default key is
            # unchanged so existing caches stay valid
            if (synth_kw["num_train"], synth_kw["num_test"]) != (256, 128):
                _key += f"_t{synth_kw['num_train']}x{synth_kw['num_test']}"
            if (synth_kw["node_alpha"], synth_kw["edge_alpha"]) != (0.3, 0.5):
                _key += f"_p{synth_kw['node_alpha']}x{synth_kw['edge_alpha']}"
            if SYNTH_CACHE_VERSION != 1:
                _key += f"_v{SYNTH_CACHE_VERSION}"
            _cache_path = os.path.join(_cache_dir, f"synth_{_key}.pkl")
            if os.path.exists(_cache_path):
                with open(_cache_path, "rb") as fh:
                    (train_data, test_data, train_stats, test_stats,
                     idx_to_word) = pickle.load(fh)
                logging.info("synthetic bundle loaded from cache %s", _cache_path)
                _cache_path = None  # already materialized; skip the save below
        if _cache_path is not None or not _cache_dir:
            train_data, test_data, train_stats, test_stats, idx_to_word = synthetic_bundle_dicts(
                name, config.dataset.max_node_num, seed=config.seed, **synth_kw)
        if _cache_path is not None:
            os.makedirs(_cache_dir, exist_ok=True)
            # pid-unique tmp: two processes generating the same key must not
            # interleave writes into one tmp file before os.replace
            _tmp = f"{_cache_path}.{os.getpid()}.tmp"
            with open(_tmp, "wb") as fh:
                pickle.dump((train_data, test_data, train_stats, test_stats,
                             idx_to_word), fh)
            os.replace(_tmp, _cache_path)
            logging.info("synthetic bundle cached to %s", _cache_path)
    else:
        train_data = pickle.load(open(paths["train_pkl"], "rb"))
        test_data = pickle.load(open(paths["test_pkl"], "rb"))
        train_stats = pickle.load(open(paths["train_stats"], "rb"))
        test_stats = pickle.load(open(paths["test_stats"], "rb"))
        idx_to_word = pickle.load(open(paths["idx_to_word"], "rb"))

    kw = dict(max_node_num=config.dataset.max_node_num,
              num_node_attr_type=num_node_type, num_edge_attr_type=num_edge_type,
              node_encoding=config.train.node_encoding,
              edge_encoding=config.train.edge_encoding,
              flag_node_only=config.train.get("node_only", False),
              flag_binary_edge=config.train.get("binary_edge", False),
              subset=config.dataset.subset)

    if config.dataset.subset is not None:
        # subset mode: test aliases train to measure overfit (dataloader.py:320-323)
        train = build_tensors(train_data, **kw)
        test = train
    else:
        test = build_tensors(test_data, **kw)
        train = test if eval_mode else build_tensors(train_data, **kw)

    logging.info("scene graph dataset loaded in %.2fs (train %d / test %d)",
                 time.time() - t0, len(train), len(test))
    return SceneGraphBundle(
        train=train, test=test,
        train_triplet_dict=_triplet_dict_from_stats(train_stats),
        test_triplet_dict=_triplet_dict_from_stats(test_stats),
        bbox_area_stat=_area_stat_from_stats(test_stats),
        bbox_freq_stat=_freq_stat_from_stats(test_stats),
        idx_to_word=idx_to_word)
