"""``sg_go_sampling`` data parallel: two gloo processes against one.

Two passes on an eval set of 5 synthetic graphs of the tiny config at batch
2: rank 0 samples graphs 0, 2 and 4, rank 1 graphs 1 and 3 and,
wrap-padded, 1 again.
With the ground-truth sanity check (every sample denoises to its graph's
ground truth), rank 0's arrays and metrics after the gather in rank order
and the trim must be, row for row, those of one process, and rank 1 writes
nothing; the decoded graphs are equal, the continuous samples and the boxes
decoded from them agree within 1e-6, since each rank draws the churn noise,
which the denoising removes to within an ulp, from a stream of its own.
Without the sanity check each rank samples its graphs from its own stream,
the default stream folded with the rank: one process that samples a
rank's graphs from that folded stream, on one thread as the ranks run,
gives that rank's rows bit for bit.
"""
import dataclasses
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_parity import start_ranks, tiny_port_model, wait_ranks  # noqa: E402
from torch_dp_child import eval_config  # noqa: E402

PASSES = ("sanity_check", "model_inference")


def _samples(logdir, what):
    (path,) = glob.glob(os.path.join(logdir, "sampling_during_evaluation", f"*_{what}",
                                     "final_samples_array_before_eval.npz"))
    return dict(np.load(path))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from diffusesg_torch.data import load_data
    from diffusesg_torch.data.loader import shard_for_process, split_eval_set
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.sampling.orchestrator import sg_go_sampling
    from diffusesg_torch.utils.logging_utils import set_seed_and_logger

    root = tmp_path_factory.mktemp("dp_eval")
    ranks = start_ranks(["eval", str(root / "world2")], str(root / "logs"))
    try:
        cfg = eval_config(str(root / "world1"))
        set_seed_and_logger(cfg, mode="eval", log_level="WARNING")
        model = tiny_port_model(cfg).eval()
        bundle = load_data(cfg, eval_mode=True, data_root="/nonexistent")
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(sys.modules, "matplotlib", None)  # no plots, as in the ranks
            one = {what: sg_go_sampling(model, None, get_mc_sampler(cfg), cfg, bundle,
                                        eval_mode=True, sanity_check=what == "sanity_check")
                   for what in PASSES}
            # each rank's graphs (its wrap-padded shard) from its folded stream
            # on one thread, as the ranks run, so that the sums round as theirs
            logdir, per_rank, threads = cfg.logdir, [], torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                for rank in range(2):
                    with cfg.unlocked():
                        cfg.logdir = str(root / f"rank{rank}_alone")
                    stream = TorchNoise(int(cfg.seed), "cpu").fold_in(rank)
                    graphs = split_eval_set(bundle.test, 5, seed=cfg.seed)  # the eval set
                    shard = dataclasses.replace(bundle, test=shard_for_process(graphs, rank, 2))
                    sg_go_sampling(model, None, get_mc_sampler(cfg), cfg, shard, eval_mode=True,
                                   skip_eval=True, noise_factory=lambda bi, s=stream: s)
                    per_rank.append(_samples(cfg.logdir, "model_inference"))
            finally:
                torch.set_num_threads(threads)
    finally:
        wait_ranks(ranks)
    with open(root / "world2" / "metrics.json") as f:
        two = json.load(f)
    return one, logdir, two, per_rank


def test_world_two_samples_row_for_row_as_one_process(runs):
    _, logdir, two, _ = runs
    want, got = _samples(logdir, "sanity_check"), _samples(two["logdir"], "sanity_check")
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key
        if want[key].dtype.kind == "f":
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert len(want["gt_image_ids"]) == 5


def test_world_two_metrics_equal_one_process(runs):
    one, _, two, _ = runs
    want = {k: v for k, v in one["sanity_check"].items() if not k.startswith("_")}
    got = two["sanity_check"]
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        assert got[key] == pytest.approx(val, rel=1e-6, abs=1e-9), key
    assert want["gen_data_size"] == 5
    assert want["node_degree_mmd_gaussian"] == 0.0  # the sanity check


def test_world_two_samples_each_rank_from_its_own_stream(runs):
    """Without the sanity check: the ground truth row for row as in one
    process, and each rank's samples those of its graphs drawn from the
    default stream folded with its rank (rows 0, 2, 4 from rank 0, rows 1,
    3 from rank 1), not the single-process stream; the metrics of the
    same keys, finite."""
    one, logdir, two, per_rank = runs
    single, got = _samples(logdir, "model_inference"), _samples(two["logdir"], "model_inference")
    assert sorted(got) == sorted(single)
    for key in [k for k in single if k.startswith("gt_")] + ["samples_node_flags"]:
        np.testing.assert_array_equal(got[key], single[key], err_msg=key)
    order = [(0, 0), (1, 0), (0, 1), (1, 1), (0, 2)]  # (rank, row) of graphs 0 .. 4
    for key in single:
        want = np.stack([per_rank[r][key][i] for r, i in order])
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    assert np.all(np.isfinite(got["raw_a"])) and np.all(np.isfinite(got["raw_x"]))
    assert not np.allclose(got["raw_a"], single["raw_a"])
    want = {k for k in one["model_inference"] if not k.startswith("_")}
    assert set(two["model_inference"]) == want
    assert all(np.isfinite(v) for v in two["model_inference"].values()
               if isinstance(v, (int, float)))


def test_only_rank_zero_writes(runs):
    _, _, two, _ = runs
    run = two["logdir"]
    assert os.path.exists(os.path.join(run, "eval_results.csv"))
    with open(os.path.join(run, "eval_results.csv")) as f:
        assert len(f.readlines()) == 3  # header and a row for each pass
    dirs = glob.glob(os.path.join(run, "sampling_during_evaluation", "*"))
    assert len(dirs) == 2 and {w for w in PASSES for d in dirs if d.endswith(w)} == set(PASSES)
    assert os.path.exists(os.path.join(run, "process_1.log"))
