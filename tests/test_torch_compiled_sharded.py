"""The compiled ``gspmd`` + ZeRO-1 and tensor-parallel steps on the CPU,
across gloo ranks of tests/helpers/torch_dp_child.py, each rank through
the stand-in of tests/helpers/graph_stand_in.py (a "graph" that calls its
captured body at each replay), as tests/test_torch_compiled_train.py's
``test_shard_map_step_on_two_ranks`` runs the ``shard_map`` step.

* ``gspmd`` at world 2 (``compiled_gspmd``): 3 steps of the train step and
  a test-pass step on the smallest-beta EMA after each, eager and compiled
  from one start and the same draws: every metric, and at the end the
  parameters, gradients, the gathered Adam state and EMAs bit-equal; the
  graphs (a) per coin and (b); one test-pass program over the EMA's kept
  gather buffers.  The eager run's flat-ZeRO checkpoint restores in one
  process bit-equal to the ranks' state, and restored into a fresh ZeRO-1
  state at world 2 it steps on bit-equal to the state that was never
  saved.  ``go_training`` in the ``gspmd`` mode runs its compiled steps
  (captured through the stand-in) and ends as with ``compiled=False``:
  the same state and loss logs.
* Tensor parallel at grid (1, 2) (``compiled_tp``): 3 steps eager and
  compiled: one graph per coin (a data group of one), every metric, each
  rank's shards and gradients, and the gathered Adam state and EMAs
  bit-equal.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_parity import start_ranks, wait_ranks  # noqa: E402
import torch_dp_child as child  # noqa: E402


def _load(path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _part(got: dict, tag: str) -> dict:
    return {k[len(tag) + 1:]: v for k, v in got.items() if k.startswith(tag + "/")}


def _assert_equal(a: dict, b: dict, what: str) -> None:
    assert a.keys() == b.keys() and a, what
    for k in a:
        assert np.array_equal(a[k], b[k]), (what, k)


def _coins(seed: int, n: int):
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    probe = TorchNoise(seed, "cpu")
    return {probe.bernoulli(i, "self_cond", 0.5) for i in range(n)}


@pytest.fixture(scope="module")
def gspmd(tmp_path_factory):
    out = tmp_path_factory.mktemp("compiled_gspmd")
    wait_ranks(start_ranks(["compiled_gspmd", str(out)], str(out / "logs")))
    return out, [_load(out / f"gspmd_rank{r}.npz") for r in range(2)]


def test_compiled_gspmd_steps_equal_eager(gspmd):
    _, ranks = gspmd
    assert _coins(1, child.COMPILED_STEPS) == {True, False}  # both variants ran
    for r, got in enumerate(ranks):
        _assert_equal(_part(got, "compiled"), _part(got, "eager"), f"rank {r}")
        assert sorted(str(g) for g in got["graphs"]) == ["backward:cond", "backward:no_cond",
                                                         "update"]
        assert int(got["test_programs"]) == 1
    # the ranks hold one state: the parameters, gathered EMAs and Adam, global metrics
    a, b = (_part(g, "eager") for g in ranks)
    for k in a:
        if "/grad/" not in k and "per_sample" not in k and "sigmas" not in k:
            assert np.array_equal(a[k], b[k]), k


def test_flat_zero_checkpoint_restores_in_one_process_and_at_world_two(gspmd):
    from diffusesg_torch.train import create_train_state, make_optimizer
    from diffusesg_torch.utils.checkpoint import restore_checkpoint
    from torch_parity import tiny_port_model

    out, ranks = gspmd
    for got in ranks:  # restored at world 2: the steps after it as if never saved
        _assert_equal(_part(got, "restored"), _part(got, "kept"), "restored at world 2")
    cfg = child.tiny_config()
    state = create_train_state(tiny_port_model(cfg, seed=3), child.BETAS,
                               make_optimizer(child.LR, child.DECAY, child.SPE, child.WD))
    assert restore_checkpoint(str(out / "gspmd_ckpt.pt"), state) == {"epoch": 0}
    assert state.step == child.COMPILED_STEPS
    want = _part(ranks[0], "eager")
    for i, (n, p) in enumerate(state.model.named_parameters()):
        assert np.array_equal(p.detach().numpy(), want[f"param/{n}"]), n
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert np.array_equal(state.opt.state[p][k].numpy(), want[f"adam/{k}/{n}"]), (k, n)
        for j, ema in enumerate(state.ema_params):
            assert np.array_equal(ema[i].numpy(), want[f"ema{j}/{n}"]), (j, n)
    assert float(state.opt.param_groups[0]["lr"]) == float(want["lr"])
    assert int(state.opt.state[state.params()[0]]["step"]) == child.COMPILED_STEPS


def test_go_training_gspmd_branch_compiled_equals_eager(gspmd):
    _, ranks = gspmd
    for r, got in enumerate(ranks):
        _assert_equal(_part(got, "go_compiled"), _part(got, "go_eager"), f"rank {r}")
        assert int(got["go_training_captures"]) >= 3  # (a) per coin, (b), the test pass
    assert "go_compiled/train_loss.log" in ranks[0]


def test_compiled_tp_step_equals_eager(tmp_path):
    wait_ranks(start_ranks(["compiled_tp", str(tmp_path), "1", "2"], str(tmp_path / "logs")))
    for r in range(2):
        got = _load(tmp_path / f"compiled_tp_rank{r}.npz")
        _assert_equal(_part(got, "compiled"), _part(got, "eager"), f"rank {r}")
        want = {"cond" if c else "no_cond" for c in _coins(child.TP_SEED, child.COMPILED_STEPS)}
        assert {str(g) for g in got["graphs"]} == want
        if r == 0:
            assert any(k.startswith("compiled/whole/") for k in got)
