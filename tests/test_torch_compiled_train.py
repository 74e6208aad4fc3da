"""The compiled training step (``diffusesg_torch/train/compiled.py``) on the
CPU.

* The CPU path of ``CompiledTrainStep`` and ``CompiledEvalStep`` is the
  eager step, bit for bit.
* The compiled data flow (a program's static batch and draw buffers, the
  draws made ahead by the caller's noise source, the learning rate and EMA
  weights written before the replay, each variant's eager first use, the
  replays, the metrics' copies) runs here with the stand-in of
  tests/helpers/graph_stand_in.py, whose "graph" calls its captured body
  at each replay: bit-equal to the eager step over 5 steps on tiny VG and
  COCO-Stuff (window 10) models, with both coin values, an epoch boundary,
  the EMA warm-up and 2 EMAs, and with self-conditioning off, a ``vp``
  sigma distribution and one-hot encodings; exactly the expected graphs
  captured; every step's metrics intact after later replays; the eval
  step; ``go_training`` (its state and ``train_loss.log``); the
  ``shard_map`` step on two gloo ranks (tests/helpers/torch_dp_child.py
  ``compiled``).
* The state's device form: every parameter has a gradient after an eager
  step of either coin (the compiled step zeroes gradients in place, which
  is bit-equal only so), the lerp of the EMA weights' views equal to the
  lerp with a number and at weight 1 to a copy, and Adam's state through a
  checkpoint with the learning rate as a number into either Adam.
The compiled flow against the JAX package is a case of
tests/test_torch_train_step.py's parametrised test.
"""
import collections
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from graph_stand_in import _Stream, stand_in  # noqa: E402,F401 - the fixture
from torch_parity import (COCO_CFG, SMALL_CFG, clean_batch, coco_small_overrides,  # noqa: E402
                          start_ranks, tiny_overrides, tiny_port_model, wait_ranks)

from diffusesg_torch.ops import cuda_build  # noqa: E402
from diffusesg_torch.sampling.edm_sampler import TorchNoise  # noqa: E402
from diffusesg_torch.train import (create_train_state, ema_slice, make_eval_step,  # noqa: E402
                                   make_optimizer, make_train_step, train_step_config_from)
from diffusesg_torch.train.compiled import (CompiledEvalStep, CompiledTrainStep,  # noqa: E402
                                            make_draws)
from diffusesg_torch.train.train_step import draw_plan  # noqa: E402

STEPS, SEED, BETAS, LR, DECAY, WD, SPE = 5, 3, [0.9, 0.999], 2e-3, 0.5, 1e-2, 2
COMPILED_STEPS = 3  # tests/helpers/torch_dp_child.py's steps of the gloo pair
COUNTS = [16, 11, 5, 2]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread (as tests/test_torch_async_ckpt.py): the tiny
    models gain nothing from more, a parallel test run makes each op wait
    for descheduled threads, and one thread sums in one order, so two runs
    of a step agree bit for bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(case: str):
    """The port config of a case: tiny VG (tests/helpers/torch_parity.py
    ``tiny_overrides``) or small COCO-Stuff (window 10), then the case's
    change."""
    from diffusesg_torch.config import load_config
    if case == "coco":
        return coco_small_overrides(load_config(COCO_CFG))
    cfg = tiny_overrides(load_config(SMALL_CFG))
    with cfg.unlocked():
        if case == "no_self_cond":
            cfg.train.self_cond = False
        elif case == "vp":
            cfg.mcmc.sigma_dist = "vp"
        elif case == "one_hot":
            cfg.train.node_encoding = cfg.train.edge_encoding = "one_hot"
    return cfg


def _batch(cfg, step_cfg, seed: int = 9):
    """A batch of the case's layout: ddpm-range values, or for one-hot
    encodings int labels (adjs [B,N,N]; nodes [B,N,1+4], the type then the
    box)."""
    n = cfg.dataset.max_node_num
    counts = [min(c, n) for c in COUNTS]
    adjs, nodes, flags = clean_batch(len(counts), n, counts, seed=seed)
    if step_cfg.node_encoding == "one_hot":
        rng = np.random.default_rng(seed)
        adjs = rng.integers(0, step_cfg.num_edge_type, adjs.shape).astype(np.float32)
        adjs *= flags[:, :, None] & flags[:, None, :]
        types = rng.integers(0, step_cfg.num_node_type, flags.shape).astype(np.float32)
        nodes = np.concatenate([types[..., None], nodes[..., -4:]], -1) * flags[..., None]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (adjs, nodes, flags))


def _state(cfg):
    model = tiny_port_model(cfg)
    return create_train_state(model, BETAS, make_optimizer(LR, DECAY, SPE, WD))


def _same_state(a, b):
    assert a.step == b.step
    assert all(torch.equal(x, y) for x, y in zip(a.params(), b.params()))
    assert all(torch.equal(x.grad, y.grad) for x, y in zip(a.params(), b.params()))
    for ea, eb in zip(a.ema_params, b.ema_params):
        assert all(torch.equal(x, y) for x, y in zip(ea, eb))
    for p, q in zip(a.params(), b.params()):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a.opt.state[p][k], b.opt.state[q][k])
    assert a.opt.param_groups[0]["lr"] == b.opt.param_groups[0]["lr"]


def _same_metrics(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _coins(n: int, seed: int = SEED):
    probe = TorchNoise(seed, "cpu")
    return [probe.bernoulli(i, "self_cond", 0.5) for i in range(n)]


CASES = ["vg", "coco", "no_self_cond", "vp", "one_hot"]


@pytest.mark.parametrize("case", CASES)
def test_compiled_step_bit_equal_with_stand_in_graphs(case, stand_in):
    """5 steps compiled (through the stand-in) and eager from one state and
    the same draws: every metric of every step, and at the end the
    parameters, gradients, Adam's moments and steps, the learning rate and
    both EMAs bit-equal; the learning rate halves at the epoch boundary
    (steps per epoch 2) and updates 1 and 2 are the EMA warm-up."""
    cfg = _config(case)
    step_cfg = train_step_config_from(cfg)
    batch = _batch(cfg, step_cfg)
    eager_state, comp_state = _state(cfg), _state(cfg)
    eager = make_train_step(eager_state.model, step_cfg)
    comp = CompiledTrainStep(make_train_step(comp_state.model, step_cfg))
    noise_e, noise_c = TorchNoise(SEED, "cpu"), TorchNoise(SEED, "cpu")
    kept = []
    for _ in range(STEPS):
        eager_state, want = eager(eager_state, noise_e, *batch)
        comp_state, got = comp(comp_state, noise_c, *batch)
        _same_metrics(got, want)
        kept.append((got, {k: v.clone() for k, v in want.items()}))
    _same_state(comp_state, eager_state)
    assert comp_state.opt.param_groups[0]["lr"] == LR * DECAY ** 2
    (program,) = comp._programs.values()
    variants = ({"plain"} if not step_cfg.self_condition
                else {"cond" if c else "no_cond" for c in _coins(STEPS)})
    assert set(program.graphs) == variants and len(stand_in) == len(variants)
    if step_cfg.self_condition:
        assert variants == {"cond", "no_cond"}  # the seed takes both coins
    for got, want in kept:  # no step's metrics were overwritten by a later replay
        _same_metrics(got, want)


def test_cpu_path_is_the_eager_step():
    """Without the stand-in the wrappers on the CPU call the eager steps."""
    cfg = _config("vg")
    step_cfg = train_step_config_from(cfg)
    batch = _batch(cfg, step_cfg)
    a, b = _state(cfg), _state(cfg)
    eager, comp = make_train_step(a.model, step_cfg), CompiledTrainStep(
        make_train_step(b.model, step_cfg))
    ev_e, ev_c = make_eval_step(a.model, step_cfg), CompiledEvalStep(
        make_eval_step(b.model, step_cfg))
    ne, nc = TorchNoise(SEED, "cpu"), TorchNoise(SEED, "cpu")
    for _ in range(2):
        a, want = eager(a, ne, *batch)
        b, got = comp(b, nc, *batch)
        _same_metrics(got, want)
        _same_metrics(ev_c(ema_slice(b, 0), nc, b.step, *batch),
                      ev_e(ema_slice(a, 0), ne, a.step, *batch))
    _same_state(b, a)
    assert not comp._programs and not ev_c._programs


def test_compiled_eval_step_equals_eager(stand_in):
    """The test pass's step on the smallest-beta EMA, both coins, through
    the stand-in: one program for the EMA's tensors, the same metrics as
    eager, and each call's metrics intact after the next."""
    cfg = _config("vg")
    step_cfg = train_step_config_from(cfg)
    batch = _batch(cfg, step_cfg)
    state = _state(cfg)
    make_train_step(state.model, step_cfg)(state, TorchNoise(1, "cpu"), *batch)
    eager, comp = make_eval_step(state.model, step_cfg), CompiledEvalStep(
        make_eval_step(state.model, step_cfg))
    ne, nc = TorchNoise(SEED, "cpu"), TorchNoise(SEED, "cpu")
    kept = []
    for i in range(4):
        want = eager(ema_slice(state, 0), ne, i, *batch)
        got = comp(ema_slice(state, 0), nc, i, *batch)  # a new dict over the same tensors
        _same_metrics(got, want)
        kept.append((got, want))
    for got, want in kept:
        _same_metrics(got, want)
    (program,) = comp._programs.values()
    assert set(program.graphs) == {"cond" if c else "no_cond" for c in _coins(4)}


class _Recording:
    """A noise source that records what it is asked for."""

    def __init__(self, noise):
        self.noise, self.asked = noise, []

    def normal(self, step, kind, shape):
        self.asked.append(("normal", kind, tuple(shape)))
        return self.noise.normal(step, kind, shape)

    def uniform(self, step, kind, shape):
        self.asked.append(("uniform", kind, tuple(shape)))
        return self.noise.uniform(step, kind, shape)

    def bernoulli(self, step, kind, p):
        self.asked.append(("bernoulli", kind, p))
        return self.noise.bernoulli(step, kind, p)


@pytest.mark.parametrize("case", ["vg", "no_self_cond", "vp", "one_hot"])
def test_draw_plan_is_the_eager_steps_draws(case):
    """``make_draws`` asks the source for what the eager step asks, in its
    order."""
    from diffusesg_torch.train import make_loss_fn
    cfg = _config(case)
    step_cfg = train_step_config_from(cfg)
    batch = _batch(cfg, step_cfg)
    eager, ahead = _Recording(TorchNoise(0, "cpu")), _Recording(TorchNoise(0, "cpu"))
    make_loss_fn(tiny_port_model(cfg), step_cfg)(None, eager, 0, *batch)
    make_draws(ahead, 0, step_cfg, batch[0], batch[1])
    assert ahead.asked == eager.asked
    assert [a[:2] for a in ahead.asked[:3]] == [a[:2] for a in draw_plan(
        step_cfg, batch[0].shape, batch[1].shape)]


@pytest.mark.parametrize("case", ["vg", "coco"])
@pytest.mark.parametrize("coin", [True, False])
def test_every_parameter_gets_a_gradient(case, coin):
    """An eager step leaves no parameter without a gradient, with and
    without the conditioning pass: so the gradients zeroed in place (which
    Adam updates) are the gradients set to None (which it would skip)."""
    cfg = _config(case)
    step_cfg = train_step_config_from(cfg)
    state = _state(cfg)

    class Coin(TorchNoise):
        def bernoulli(self, step, kind, p):
            return coin
    make_train_step(state.model, step_cfg)(state, Coin(1, "cpu"), *_batch(cfg, step_cfg))
    missing = [n for n, p in state.model.named_parameters() if p.grad is None]
    assert not missing


def test_ema_lerp_of_weight_views():
    """The EMAs' lerp over views of the weight buffer equals the lerp with a
    number weight, and at weight 1 the copy of the warm-up."""
    from diffusesg_torch.train.train_state import EmaWeights
    rng = np.random.default_rng(0)
    shapes = [(7,), (12, 5), (3, 4, 6), (1,)]
    ps = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    ps[0][:3] = -0.0
    weights = EmaWeights(ps, 4)
    ws = [1.0, 1.0 / 3, 0.001, 0.75]
    weights.fill(ws)
    for j, w in enumerate(ws):
        emas = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
        by_number = [e.clone() for e in emas]
        torch._foreach_lerp_(emas, ps, weights.views[j])
        torch._foreach_lerp_(by_number, ps, w)
        assert all(torch.equal(a, b) for a, b in zip(emas, by_number))
        if w == 1.0:
            assert all(torch.equal(a, p) for a, p in zip(emas, ps))


def test_opt_state_keeps_its_form_through_a_checkpoint(tmp_path):
    """A checkpoint keeps the learning rate as a number; a state whose Adam
    holds it as a tensor (the card's form) restores into the plain Adam
    and back, the tensor keeping its identity and taking the saved rate,
    and each Adam keeps its ``capturable`` flag."""
    from diffusesg_torch.train.train_state import load_opt_state, opt_state_dict, set_lr
    from diffusesg_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
    cfg = _config("vg")
    step_cfg = train_step_config_from(cfg)
    batch = _batch(cfg, step_cfg)
    state = _state(cfg)
    make_train_step(state.model, step_cfg)(state, TorchNoise(1, "cpu"), *batch)
    path = save_checkpoint(str(tmp_path / "a"), state, {"epoch": 0})
    saved = torch.load(path, weights_only=False)["opt_state"]
    assert all(type(g["lr"]) is float for g in saved["param_groups"])

    # an Adam whose learning rate is a tensor, as the card's capturable one
    lr = torch.tensor(5.0)
    other = create_train_state(tiny_port_model(cfg, seed=2), BETAS,
                               make_optimizer(LR, DECAY, SPE, WD))
    other.opt.param_groups[0]["lr"] = lr
    set_lr(other.opt, 1e-3)
    assert other.opt.param_groups[0]["lr"] is lr and float(lr) == np.float32(1e-3)
    assert type(opt_state_dict(other.opt)["param_groups"][0]["lr"]) is float
    restore_checkpoint(path, other)
    assert other.opt.param_groups[0]["lr"] is lr and float(lr) == np.float32(LR)
    for p, q in zip(state.params(), other.params()):
        assert torch.equal(state.opt.state[p]["exp_avg"], other.opt.state[q]["exp_avg"])
    # the card's form (capturable, lr a tensor) into the plain Adam
    card = opt_state_dict(state.opt)
    for g in card["param_groups"]:
        g.update(capturable=True, lr=torch.tensor(g["lr"]))
    plain = create_train_state(tiny_port_model(cfg), BETAS, make_optimizer(LR, DECAY, SPE, WD))
    load_opt_state(plain.opt, card)
    group = plain.opt.param_groups[0]
    assert group["capturable"] is False and type(group["lr"]) is float
    assert group["lr"] == float(np.float32(LR))  # the card's rate is an fp32 tensor
    make_train_step(plain.model, step_cfg)(plain, TorchNoise(1, "cpu"), *batch)


def test_launches_into_the_capture_stream_count_in_its_record(stand_in):
    """While a graph is captured on a stream, a launch another thread makes
    into that stream (the autograd engine's backward) counts in the
    graph's record."""
    import threading
    cuda_build.reset_launches()
    with cuda_build.capturing(collections.Counter(), _Stream()) as record:
        t = threading.Thread(target=cuda_build.count_launch, args=("k", "s"))
        t.start()
        t.join()
    cuda_build.count_launch("k", "s")
    assert record == {("k", "s"): 1} and cuda_build.LAUNCHES == {("k", "s"): 1}
    cuda_build.reset_launches()


def test_a_moved_state_is_captured_anew(tmp_path, stand_in):
    """A restore that replaces Adam's state tensors makes the program anew
    (its graphs bound the old ones): the steps after it equal eager."""
    from diffusesg_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
    cfg = _config("vg")
    step_cfg = train_step_config_from(cfg)
    batch = _batch(cfg, step_cfg)
    a, b = _state(cfg), _state(cfg)
    eager, comp = make_train_step(a.model, step_cfg), CompiledTrainStep(
        make_train_step(b.model, step_cfg))
    ne, nc = TorchNoise(SEED, "cpu"), TorchNoise(SEED, "cpu")
    a, _ = eager(a, ne, *batch)
    b, _ = comp(b, nc, *batch)
    first = next(iter(comp._programs.values()))
    path = save_checkpoint(str(tmp_path / "s"), b)
    restore_checkpoint(path, b)
    for _ in range(2):
        a, want = eager(a, ne, *batch)
        b, got = comp(b, nc, *batch)
        _same_metrics(got, want)
    _same_state(b, a)
    assert next(iter(comp._programs.values())) is not first


def _train_run(tmp, compiled: bool):
    """``go_training`` on the tiny config (8 synthetic graphs at batch 4, 2
    epochs, a test pass and a checkpoint each epoch): the final state and
    the run's train and test loss logs."""
    from diffusesg_torch.data import load_data
    from diffusesg_torch.train import go_training
    from diffusesg_torch.utils.logging_utils import set_seed_and_logger
    cfg = _config("vg")
    with cfg.unlocked():
        cfg.seed = 0
        cfg.exp_dir = str(tmp)
        cfg.train.batch_size = cfg.test.batch_size = 4
        cfg.train.max_epoch = 2
        cfg.train.save_interval = 1
        cfg.dataset.synthetic_num_train = 8
        cfg.dataset.synthetic_num_test = 4
    set_seed_and_logger(cfg, mode="train", comment="compiled", log_level="WARNING")
    bundle = load_data(cfg, data_root="/nonexistent")
    state = create_train_state(tiny_port_model(cfg), BETAS, make_optimizer(LR, DECAY, 2, WD))
    state = go_training(state.model, state, train_step_config_from(cfg), cfg, bundle,
                        noise=TorchNoise(SEED, "cpu"), compiled=compiled)
    logs = {}
    for name in ("train_loss.log", "test_loss.log"):
        with open(os.path.join(cfg.logdir, name)) as f:
            logs[name] = f.read()
    return state, logs


def test_go_training_compiled_equals_eager(tmp_path, stand_in):
    """``go_training`` with its compiled steps (through the stand-in) and
    with ``compiled=False``: the same final state and loss logs."""
    comp, comp_logs = _train_run(tmp_path / "compiled", True)
    eager, eager_logs = _train_run(tmp_path / "eager", False)
    _same_state(comp, eager)
    assert comp_logs == eager_logs and comp_logs["test_loss.log"]
    assert len(stand_in) >= 2  # the training and the test step were captured


def test_shard_map_step_on_two_ranks(tmp_path):
    """The compiled ``shard_map`` step on two gloo ranks (the stand-in in
    each rank): two graphs per variant and one update graph around the
    all-reduce, bit-equal to the eager ``shard_map`` step (each rank writes
    both runs; tests/helpers/torch_dp_child.py ``compiled``).  The compiled
    step records one ``step.collective`` a step, the all-reduce's, inside
    its ``step.call``; the eager one a ``step.call`` alone."""
    ranks = start_ranks(["compiled", str(tmp_path)], str(tmp_path / "logs"))
    wait_ranks(ranks)
    for r in range(2):
        with np.load(tmp_path / f"compiled_rank{r}.npz") as f:
            got = {k: f[k] for k in f.files}
        eager = {k[len("eager/"):]: v for k, v in got.items() if k.startswith("eager/")}
        comp = {k[len("compiled/"):]: v for k, v in got.items() if k.startswith("compiled/")}
        assert eager.keys() == comp.keys() and eager
        for k in eager:
            assert np.array_equal(eager[k], comp[k]), (r, k)
        assert sorted(str(g) for g in got["graphs"]) == ["backward:cond", "backward:no_cond",
                                                         "update"]
        steps = [str(k) for k in range(COMPILED_STEPS)]
        spans = [tuple(s) for s in got["spans_compiled"]]
        assert [s for s in spans if s[1] == "step.collective"] == [
            (k, "step.collective", "reduce") for k in steps]
        assert [s for s in spans if s[1] == "step.call"] == [(k, "step.call", "") for k in steps]
        assert [tuple(s) for s in got["spans_eager"]] == [(k, "step.call", "") for k in steps]
