"""``cli.train`` data parallel: two gloo processes, as torchrun starts them.

Two ranks of tests/helpers/torch_dp_child.py run ``cli.train`` on the tiny
config (vg_small_test, depths (1, 1), 8 synthetic graphs, a global batch of
4, so 2 rows a rank and 2 steps an epoch) for 2 epochs, with a checkpoint
and in-training sampling every epoch (epoch 0 the sanity check, epoch 1
the model's samples at 8 steps), under each ``tpu.spmd_mode``: one run dir,
one loss log and the checkpoints, written by rank 0 alone; the checkpoint
restores in one process and resumes there.  tests/test_torch_dp_preempt.py
signals one rank.
"""
import csv
import glob
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_parity import REPO, SMALL_CFG, start_ranks, wait_ranks  # noqa: E402


def _args(exp_dir, max_epoch, *extra):
    return ["train", "-c", os.path.join(REPO, SMALL_CFG), "--data_root", "/nonexistent",
            "--device", "cpu", "--subset", "8", "--batch_size", "4", "--save_interval", "1",
            "--max_epoch", str(max_epoch), "--feature_dims", "48", "-o", "model.depths=[1,1]",
            "-o", f"exp_dir={exp_dir}", *extra]


def _run_dirs(exp_dir):
    return sorted(glob.glob(os.path.join(exp_dir, "vg_small_test", "*")))


@pytest.fixture(scope="module", params=["shard_map", "gspmd"])
def runs(request, tmp_path_factory):
    mode = request.param
    two = str(tmp_path_factory.mktemp(f"dp_train_{mode}") / "two_epochs")
    args = _args(two, 2, "--sample_interval", "1", "--num_steps", "8",
                 "-o", f"tpu.spmd_mode={mode}")
    outs = wait_ranks(start_ranks(args, os.path.join(two, "logs")))
    return two, outs, mode


def test_world_two_writes_once_from_rank_zero(runs):
    """One run dir with both ranks' log files; one config, one loss log of
    the global batch (2 rows a rank, 2 ranks, 2 steps, 2 epochs), the
    checkpoints and the samples of both epochs, written by rank 0; rank 1
    printed nothing of the run; the mode asked for is the one that ran."""
    two, outs, mode = runs
    dirs = _run_dirs(two)
    assert len(dirs) == 1, dirs
    run = dirs[0]
    assert os.path.exists(os.path.join(run, "process_0.log"))
    assert os.path.exists(os.path.join(run, "process_1.log"))
    assert sorted(os.listdir(os.path.join(run, "models_ckpt"))) == ["00000.pt", "00001.pt"]
    assert os.listdir(os.path.join(run, "models")) == ["best.pt"]
    with open(os.path.join(run, "train_loss.log")) as f:
        rows = [line.split("\t") for line in f]
    assert len(rows) == 16 and all(np.isfinite(float(v)) for r in rows for v in r[1:])
    with open(os.path.join(run, "test_loss.log")) as f:
        assert len(f.readlines()) == 2 * 8  # the test set once an epoch, pads trimmed
    samples = sorted(os.path.basename(d) for d in
                     glob.glob(os.path.join(run, "sampling_during_training", "*")))
    assert samples == ["eval_epoch_00000_sanity_check", "eval_epoch_00001_model_inference"]
    with open(os.path.join(run, "eval_results.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["model_nm"] for r in rows] == ["training_e00000", "training_e00001"]
    assert float(rows[0]["node_degree_mmd_gaussian"]) == 0.0  # the sanity check
    assert np.isfinite(float(rows[1]["node_degree_mmd_gaussian"]))
    log0 = open(os.path.join(run, "process_0.log")).read()
    assert f"data parallel over 2 processes, spmd_mode {mode}" in log0
    assert "epoch 00001" in log0
    assert "epoch 00001" in open(os.path.join(run, "process_1.log")).read()
    assert "epoch 00001" not in outs[1]  # only rank 0 prints


def test_data_parallel_checkpoint_resumes_in_one_process(runs, tmp_path):
    """The DP run's checkpoint, in the single-device format, restores into a
    single-process state and ``cli.train --resume`` continues it there."""
    from diffusesg_torch.cli import train as cli
    from diffusesg_torch.config import load_config
    from diffusesg_torch.models import build_model
    from diffusesg_torch.train import create_train_state, make_optimizer
    from diffusesg_torch.utils.checkpoint import read_checkpoint, restore_checkpoint

    run = _run_dirs(runs[0])[0]
    cfg = load_config(os.path.join(run, "config.yaml"))
    state = create_train_state(build_model(cfg, device="cpu", seed=5), list(cfg.train.ema_coef),
                               make_optimizer(1e-3, 1.0, 1))
    path = os.path.join(run, "models_ckpt", "00001.pt")
    assert restore_checkpoint(path, state)["epoch"] == 1 and state.step == 4
    payload = read_checkpoint(path)
    assert len(payload["opt_state"]["state"]) == len(state.params())
    assert all(int(s["step"]) == 4 for s in payload["opt_state"]["state"].values())
    assert all(e is not None for ema in payload["ema_params"] for e in ema)
    with pytest.MonkeyPatch.context() as mp:  # as in the ranks: no TensorBoard, no plots
        mp.setitem(sys.modules, "tensorboard", None)
        mp.setitem(sys.modules, "matplotlib", None)
        resumed = cli.main(_args(str(tmp_path), 3, "--resume", run)[1:])
    assert resumed.step == 6  # 4 restored + the two steps of epoch 2
    assert any(not torch.equal(a, b) for a, b in zip(resumed.params(), state.params()))
