"""Tensor parallelism on the CPU through gloo ranks: two steps of the
tensor-parallel step (``make_sharded_train_step(..., tp=True)``) on (data,
model) grids (1, 2) and (2, 2) of ``tests/helpers/torch_dp_child.py tp``
against the port's single-device step on the same global batch and draws
(the counterpart of tests/test_tensor_parallel.py's
``test_tp_train_step_matches_single_device`` and
``test_tp_multi_step_stays_in_sync``): the losses, and the parameters, Adam
moments and EMAs gathered to rank 0, within the fp32 parity bar.  The tiny
model's stages have 3 and 6 heads, so at tp = 2 the first stage's attention
stays replicated and the second's splits.  The (2, 2) run's checkpoint
restores in one process.
"""
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "helpers"))
from torch_parity import ATOL, RTOL, start_ranks, wait_ranks  # noqa: E402
import torch_dp_child as child  # noqa: E402


def _single_device():
    """Two single-device steps of the tiny model on the whole batch, with
    the draws the ranks make; returns (losses, state, names)."""
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train import make_train_step
    cfg = child.tiny_config()
    model, state, step_cfg = child.tp_start(cfg)
    step = make_train_step(model, step_cfg)
    batch = tuple(torch.from_numpy(a) for a in child.tp_batch(cfg))
    noise = TorchNoise(child.TP_SEED, "cpu")
    losses = []
    for _ in range(child.STEPS):
        state, metrics = step(state, noise, *batch)
        losses.append(float(metrics["loss"]))
    return losses, state, [n for n, _ in model.named_parameters()]


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)])
def test_tp_steps_match_the_single_device_step(tmp_path, grid):
    from diffusesg_torch.utils.checkpoint import restore_checkpoint
    dp, tp = grid
    ranks = start_ranks(["tp", str(tmp_path), str(dp), str(tp)], str(tmp_path / "logs"),
                        world=dp * tp)
    losses, state, names = _single_device()
    outs = wait_ranks(ranks)
    # the first stage's 3 heads do not split over 2: its attention leaves stay replicated
    assert "stay REPLICATED" in outs[0] and "down_layers.0.blocks.0.attn.qkv.weight" in outs[0]
    assert "down_layers.1.blocks.0.attn.qkv.weight" not in outs[0].split("stay REPLICATED")[1]

    # the replicated leaves (bias tables, biases after the row-parallel
    # products, norms, readouts) are equal on every rank after the steps
    reps = [np.load(tmp_path / f"tp_replicated_rank{r}.npz") for r in range(dp * tp)]
    assert "down_layers.1.blocks.0.attn.relative_position_bias_table" in reps[0].files
    for r in reps[1:]:
        for n in reps[0].files:
            np.testing.assert_array_equal(r[n], reps[0][n], err_msg=n)

    got = np.load(tmp_path / "tp.npz")
    np.testing.assert_allclose(got["loss"], losses, rtol=RTOL, atol=ATOL)
    moments = state.opt.state_dict()["state"]
    for i, (n, p) in enumerate(zip(names, state.params())):
        np.testing.assert_allclose(got[f"param/{n}"], p.detach().numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=n)
        for k, ema in enumerate(state.ema_params):
            np.testing.assert_allclose(got[f"ema{k}/{n}"], ema[i].numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=f"ema{k} {n}")
        for m in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(got[f"{m}/{n}"], moments[i][m].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{m} {n}")

    # the checkpoint has the single-device format and restores in one process
    cfg = child.tiny_config()
    model, fresh, _ = child.tp_start(cfg)
    extra = restore_checkpoint(str(tmp_path / "tp_ckpt.pt"), fresh)
    assert extra == {"epoch": 0} and fresh.step == child.STEPS
    for n, p in zip(names, model.parameters()):
        np.testing.assert_array_equal(p.detach().numpy(), got[f"param/{n}"])
    for i, n in enumerate(names):
        np.testing.assert_array_equal(fresh.opt.state_dict()["state"][i]["exp_avg"].numpy(),
                                      got[f"exp_avg/{n}"])
