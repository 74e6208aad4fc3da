"""One rank of the port's data-parallel tests on the CPU (gloo).

    python tests/helpers/torch_dp_child.py steps <out_dir>
    python tests/helpers/torch_dp_child.py train <cli.train arguments>
    python tests/helpers/torch_dp_child.py eval <out_dir>
    python tests/helpers/torch_dp_child.py tp <out_dir> <dp> <tp>
    python tests/helpers/torch_dp_child.py compiled <out_dir>
    python tests/helpers/torch_dp_child.py compiled_gspmd <out_dir>
    python tests/helpers/torch_dp_child.py compiled_tp <out_dir> <dp> <tp>
    python tests/helpers/torch_dp_child.py card_tp <out_dir> <tp>
    python tests/helpers/torch_dp_child.py card_gspmd <out_dir>

The rendezvous comes from MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE,
as torchrun sets them; the spawning test starts one process per rank with
its output in a file.  ``steps`` runs two steps of the ``shard_map`` step
and then two of the ``gspmd`` + ZeRO-1 step from the same start on the tiny
model, with the JAX key schedule's draws, and writes each rank's results to
``<out_dir>/<mode>_rank<r>.npz``; ``train`` runs ``cli.train``; ``eval``
runs ``sg_go_sampling`` on 5 graphs with the sanity check and then without
it, and writes rank 0's metrics of both to ``<out_dir>/metrics.json``;
``tp`` runs two tensor-parallel steps on a (dp, tp) grid of the ranks from
the tiny model's single-device state (``TP_BATCH``, ``TorchNoise(TP_SEED)``)
and writes rank 0's losses and gathered state to ``<out_dir>/tp.npz`` and a
checkpoint to ``<out_dir>/tp_ckpt.pt``; ``compiled`` runs the ``shard_map``
step eagerly and compiled (through tests/helpers/graph_stand_in.py) for
``COMPILED_STEPS`` steps from one start and the same draws, and writes both
runs' metrics and final state, the compiled step's graphs and both runs'
spans (utils/tracing.py) to ``<out_dir>/compiled_rank<r>.npz``; ``compiled_gspmd`` does the same for the
``gspmd`` + ZeRO-1 train step and its test-pass step on the smallest-beta
EMA (``<out_dir>/gspmd_rank<r>.npz``), saves the eager run's checkpoint
(``<out_dir>/gspmd_ckpt.pt``) and steps on from it twice, once
uninterrupted and once restored into a fresh ZeRO-1 state, then runs
``go_training`` in the ``gspmd`` mode compiled and with ``compiled=False``
(rank 0 writes both runs' final state and loss logs); ``compiled_tp``
runs the tensor-parallel step eagerly and compiled (``<out_dir>/
compiled_tp_rank<r>.npz``); ``card_tp`` does that on cards through NCCL,
one card a rank, with real CUDA graphs, and counts each graph's NCCL
kernel nodes against the collectives and the NCCL kernels of an eager step
(``<out_dir>/card_tp_rank<r>.npz``); ``card_gspmd`` runs the ``gspmd`` +
ZeRO-1 train step compiled and then eagerly on cards, one card a rank, at
full VG width (the kernels on) and a global batch of 64, 3 steps and the
test pass on the smallest-beta EMA, then gathers the largest-beta one, and
writes whether the two runs are bit-equal and the compiled run's device
memory by part (``<out_dir>/card_gspmd_rank<r>.npz``).
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the global batch of each mode, its nodes per graph: under shard_map rank 0
# holds 27 valid nodes and rank 1 holds 7, under gspmd 16 and 5 (a shard of
# either mode and gspmd's global batch have two rows, one shape for the JAX
# side's one compiled gradient)
COUNTS = {"shard_map": [16, 11, 5, 2], "gspmd": [16, 5]}
BETAS, LR, DECAY, WD, SPE = [0.9, 0.999], 2e-3, 0.5, 1e-2, 1
STEPS = 2
# the tensor-parallel steps' global batch (its nodes per graph) and draws;
# no weight decay, whose share of a small gradient would hide it, and a clip
# below the tiny model's gradient norm (1.21 on the first step), so that the
# global norm decides every update
TP_BATCH, TP_SEED, TP_WD, TP_CLIP = [16, 11, 5, 2], 3, 0.0, 0.5


def tiny_config():
    from diffusesg_torch.config import load_config
    from torch_parity import SMALL_CFG, tiny_overrides
    return tiny_overrides(load_config(os.path.join(HERE, "..", "..", SMALL_CFG)))


def step_keys():
    import jax
    jax.config.update("jax_platforms", "cpu")
    # with key 7 the ranks' self-conditioning coins differ on both steps and
    # the global batch's coin takes both values
    return [jax.random.fold_in(jax.random.PRNGKey(7), i) for i in range(STEPS)]


def run_steps(out_dir):
    from torch_parity import JaxTrainNoise, clean_batch, tiny_port_model

    from diffusesg_torch.parallel.mesh import current_world
    from diffusesg_torch.parallel.shardmap_dp import make_shardmap_train_step
    from diffusesg_torch.parallel.sharded_step import make_sharded_train_step, shard_train_state
    from diffusesg_torch.train import (create_train_state, ema_slice, make_optimizer,
                                       train_step_config_from)
    from diffusesg_torch.utils.checkpoint import save_checkpoint

    world = current_world()
    cfg = tiny_config()
    step_cfg = train_step_config_from(cfg)
    for mode in ("shard_map", "gspmd"):
        counts = COUNTS[mode]
        batch = clean_batch(len(counts), cfg.dataset.max_node_num, counts, seed=9)
        b = len(counts) // world.size
        local = tuple(torch.from_numpy(np.ascontiguousarray(a[world.rank * b:(world.rank + 1) * b]))
                      for a in batch)
        model = tiny_port_model(cfg)
        state = create_train_state(model, BETAS, make_optimizer(LR, DECAY, SPE, WD))
        noise = JaxTrainNoise(step_keys())
        if mode == "shard_map":
            step = make_shardmap_train_step(model, step_cfg, world)
            draws = noise.fold_in(world.rank)  # the rank's stream
        else:
            state = shard_train_state(state, world)
            step = make_sharded_train_step(model, step_cfg, world)
            draws = noise
        out = {}
        for i in range(STEPS):
            state, metrics = step(state, draws, *local)
            for k, v in metrics.items():
                out[f"step{i}/{k}"] = v.numpy()
            for n, p in model.named_parameters():
                out[f"step{i}/grad/{n}"] = p.grad.numpy().copy()
                out[f"step{i}/param/{n}"] = p.detach().numpy().copy()
            for k in range(len(BETAS)):  # collective under ZeRO-1
                for n, t in ema_slice(state, k).items():
                    out[f"step{i}/ema{k}/{n}"] = t.numpy().copy()
        # what the rank holds, ZeRO-1's padding not counted
        pad = dict(zip(state.zero.buckets, state.zero.padding())) if state.zero else {}

        def held(t):
            return (t.numel() - pad.get(t.dtype, 0)) * t.element_size()
        out["adam_bytes"] = np.int64(sum(held(t) for s in state.opt.state.values()
                                         for t in s.values() if t.dim() > 0))
        out["ema_bytes"] = np.int64(sum(held(t) for ema in state.ema_params for t in ema))
        out["param_bytes"] = np.int64(sum(p.numel() * p.element_size() for p in model.parameters()))
        out["self_cond_coins"] = np.asarray([draws.bernoulli(i, "self_cond", 0.5)
                                             for i in range(STEPS)])
        np.savez(os.path.join(out_dir, f"{mode}_rank{world.rank}.npz"), **out)
        save_checkpoint(os.path.join(out_dir, f"{mode}_ckpt"), state, {"epoch": 0})


COMPILED_STEPS = 3


def run_compiled(out_dir):
    import pytest
    from graph_stand_in import install
    from torch_parity import clean_batch, tiny_port_model

    from diffusesg_torch.parallel.mesh import current_world
    from diffusesg_torch.parallel.shardmap_dp import make_shardmap_train_step
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train import create_train_state, make_optimizer, train_step_config_from
    from diffusesg_torch.utils import tracing

    world = current_world()
    cfg = tiny_config()
    step_cfg = train_step_config_from(cfg)
    counts = COUNTS["shard_map"]
    batch = clean_batch(len(counts), cfg.dataset.max_node_num, counts, seed=9)
    b = len(counts) // world.size
    local = tuple(torch.from_numpy(np.ascontiguousarray(a[world.rank * b:(world.rank + 1) * b]))
                  for a in batch)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        install(mp)
        for compiled in (False, True):
            tag = "compiled" if compiled else "eager"
            state = create_train_state(tiny_port_model(cfg), BETAS,
                                       make_optimizer(LR, DECAY, SPE, WD))
            step = make_shardmap_train_step(state.model, step_cfg, world, compiled)
            noise = TorchNoise(5, "cpu").fold_in(world.rank)
            tracing.clear()
            with tracing.recording():
                for i in range(COMPILED_STEPS):
                    state, metrics = step(state, noise, *local)
                    for k, v in metrics.items():
                        out[f"{tag}/step{i}/{k}"] = v.numpy()
            # each step's spans: (step, name, the stage of a collective)
            out[f"spans_{tag}"] = np.asarray([(str(r.group[1]), r.name, r.attrs.get("stage", ""))
                                              for r in tracing.records()])
            for n, p in state.model.named_parameters():
                out[f"{tag}/param/{n}"] = p.detach().numpy().copy()
                out[f"{tag}/grad/{n}"] = p.grad.numpy().copy()
                for k in ("exp_avg", "exp_avg_sq", "step"):
                    out[f"{tag}/adam/{k}/{n}"] = state.opt.state[p][k].numpy().copy()
            for j, ema in enumerate(state.ema_params):
                for n, e in zip(state.param_names(), ema):
                    out[f"{tag}/ema{j}/{n}"] = e.numpy().copy()
            if compiled:
                (program,) = step._programs.values()
                out["graphs"] = np.asarray(sorted(program.graphs))
    np.savez(os.path.join(out_dir, f"compiled_rank{world.rank}.npz"), **out)


def _local_rows(batch, world):
    b = len(batch[0]) // world.size
    return tuple(torch.from_numpy(np.ascontiguousarray(a[world.rank * b:(world.rank + 1) * b]))
                 for a in batch)


def _whole_state(state, tag: str, out: dict) -> None:
    """The state's parameters, EMAs and Adam in the single-device form
    (gathered under ZeRO-1) into ``out`` under ``tag``."""
    from diffusesg_torch.train.train_state import whole_emas_and_opt
    emas, opt = whole_emas_and_opt(state)
    for i, (n, p) in enumerate(state.model.named_parameters()):
        out[f"{tag}/param/{n}"] = p.detach().numpy().copy()
        out[f"{tag}/grad/{n}"] = p.grad.numpy().copy()
        for k, v in opt["state"][i].items():
            out[f"{tag}/adam/{k}/{n}"] = v.numpy().copy()
        for j, ema in enumerate(emas):
            out[f"{tag}/ema{j}/{n}"] = ema[i].numpy().copy()
    out[f"{tag}/lr"] = np.float64(float(opt["param_groups"][0]["lr"]))


def run_compiled_gspmd(out_dir):
    import pytest
    from graph_stand_in import install
    from torch_parity import clean_batch, tiny_port_model

    from diffusesg_torch.parallel.mesh import current_world
    from diffusesg_torch.parallel.sharded_step import (make_sharded_eval_step,
                                                       make_sharded_train_step, shard_train_state)
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train import (create_train_state, ema_slice, make_optimizer,
                                       train_step_config_from)
    from diffusesg_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    world = current_world()
    cfg = tiny_config()
    step_cfg = train_step_config_from(cfg)
    counts = COUNTS["shard_map"]
    local = _local_rows(clean_batch(len(counts), cfg.dataset.max_node_num, counts, seed=9), world)

    def fresh():
        state = create_train_state(tiny_port_model(cfg), BETAS, make_optimizer(LR, DECAY, SPE, WD))
        return shard_train_state(state, world)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        captures = install(mp)
        for compiled in (False, True):
            tag = "compiled" if compiled else "eager"
            state = fresh()
            step = make_sharded_train_step(state.model, step_cfg, world, compiled=compiled)
            test = make_sharded_eval_step(state.model, step_cfg, world, compiled=compiled)
            noise, test_noise = TorchNoise(1, "cpu"), TorchNoise(6, "cpu")
            for i in range(COMPILED_STEPS):
                state, metrics = step(state, noise, *local)
                for k, v in metrics.items():
                    out[f"{tag}/step{i}/{k}"] = v.numpy()
                for k, v in test(ema_slice(state, 0), test_noise, i, *local).items():
                    out[f"{tag}/test{i}/{k}"] = v.numpy()
            _whole_state(state, tag, out)
            if compiled:
                (program,) = step._programs.values()
                out["graphs"] = np.asarray(sorted(program.graphs))
                out["test_programs"] = np.int64(len(test._programs))
                out["go_training_captures"] = np.int64(-len(captures))
                _gspmd_training(out_dir, "go_compiled", True, out)
                out["go_training_captures"] += len(captures)
                _gspmd_training(out_dir, "go_eager", False, out)
                continue
            # the eager run's checkpoint, then two more steps from the state in
            # memory and from the checkpoint restored into a fresh ZeRO-1 state
            path = save_checkpoint(os.path.join(out_dir, "gspmd_ckpt"), state, {"epoch": 0})
            back = fresh()
            restore_checkpoint(path, back)
            for run, st in (("kept", state), ("restored", back)):
                go, noise = make_sharded_train_step(st.model, step_cfg, world), TorchNoise(7, "cpu")
                for i in range(2):
                    st, metrics = go(st, noise, *local)
                    for k, v in metrics.items():
                        out[f"{run}/step{i}/{k}"] = v.numpy()
                _whole_state(st, run, out)
    np.savez(os.path.join(out_dir, f"gspmd_rank{world.rank}.npz"), **out)


def _gspmd_training(out_dir, tag: str, compiled: bool, out: dict) -> None:
    """``go_training`` in the ``gspmd`` mode on the tiny config (8 synthetic
    graphs at a global batch of 4, 2 epochs, a test pass and a checkpoint
    each): the final state and, on rank 0, the loss logs into ``out``
    under ``tag``."""
    from torch_parity import tiny_port_model

    from diffusesg_torch.data import load_data
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train import create_train_state, go_training, make_optimizer
    from diffusesg_torch.train import train_step_config_from
    from diffusesg_torch.utils.logging_utils import set_seed_and_logger

    cfg = tiny_config()
    with cfg.unlocked():
        cfg.seed = 0
        cfg.exp_dir = os.path.join(out_dir, tag)
        cfg.train.batch_size = cfg.test.batch_size = 4
        cfg.train.max_epoch = 2
        cfg.train.save_interval = 1
        cfg.dataset.synthetic_num_train = 8
        cfg.dataset.synthetic_num_test = 4
        cfg.tpu.spmd_mode = "gspmd"
    set_seed_and_logger(cfg, mode="train", comment=tag, log_level="WARNING")
    bundle = load_data(cfg, data_root="/nonexistent")
    state = create_train_state(tiny_port_model(cfg), BETAS, make_optimizer(LR, DECAY, SPE, WD))
    state = go_training(state.model, state, train_step_config_from(cfg), cfg, bundle,
                        noise=TorchNoise(3, "cpu"), compiled=compiled)
    _whole_state(state, tag, out)
    if state.zero is None:
        raise AssertionError("go_training did not take the gspmd branch")
    for name in ("train_loss.log", "test_loss.log"):
        path = os.path.join(cfg.logdir, name)
        if os.path.exists(path):
            with open(path) as f:
                out[f"{tag}/{name}"] = np.asarray(f.read())


def run_compiled_tp(out_dir, dp, tp):
    import pytest
    import torch.distributed as dist
    from graph_stand_in import install

    from diffusesg_torch.parallel.mesh import make_grid
    from diffusesg_torch.parallel.sharded_step import make_sharded_train_step
    from diffusesg_torch.parallel.tp import gather_tp_state, shard_tp_state
    from diffusesg_torch.sampling.edm_sampler import TorchNoise

    cfg = tiny_config()
    grid = make_grid(int(dp), int(tp))
    local = _local_rows(tp_batch(cfg), grid)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        install(mp)
        for compiled in (False, True):
            tag = "compiled" if compiled else "eager"
            model, state, step_cfg = tp_start(cfg)
            state = shard_tp_state(state, grid)
            step = make_sharded_train_step(model, step_cfg, grid, tp=True, compiled=compiled)
            noise = TorchNoise(TP_SEED, "cpu")
            for i in range(COMPILED_STEPS):
                state, metrics = step(state, noise, *local)
                for k, v in metrics.items():
                    out[f"{tag}/step{i}/{k}"] = v.numpy()
            for n, p in model.named_parameters():  # this rank's shards
                out[f"{tag}/param/{n}"] = p.detach().numpy().copy()
                out[f"{tag}/grad/{n}"] = p.grad.numpy().copy()
            payload = gather_tp_state(state)
            if payload is not None:  # the gathered state, on global rank 0
                for n, t in payload["params"].items():
                    out[f"{tag}/whole/{n}"] = t.numpy()
                for k, ema in enumerate(payload["ema_params"]):
                    for i, e in enumerate(ema):
                        out[f"{tag}/ema{k}/{i}"] = e.numpy()
                for i, st in payload["opt_state"]["state"].items():
                    for k, v in st.items():
                        out[f"{tag}/adam/{k}/{i}"] = v.numpy()
            if compiled:
                (program,) = step._programs.values()
                out["graphs"] = np.asarray(sorted(program.graphs))
    np.savez(os.path.join(out_dir, f"compiled_tp_rank{dist.get_rank()}.npz"), **out)


def run_card_tp(out_dir, tp):
    import collections
    import re

    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diffusesg_torch.parallel import tp as tp_mod
    from diffusesg_torch.parallel.mesh import make_grid
    from diffusesg_torch.parallel.sharded_step import make_sharded_train_step
    from diffusesg_torch.parallel.tp import shard_tp_state
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train import create_train_state
    from diffusesg_torch.train.compiled import VARIANT
    from diffusesg_torch.utils import cuda_graphs

    cfg = tiny_config()
    grid = make_grid(1, int(tp))
    dev = grid.device
    local = tuple(t.to(dev) for t in _local_rows(tp_batch(cfg), grid))
    coins = [True, True, False]

    class Coins(TorchNoise):
        fixed = None  # the coin of every step, or the steps' coins in turn

        def bernoulli(self, step, kind, p):
            return coins[step % len(coins)] if self.fixed is None else self.fixed

    calls = collections.Counter()

    class Counting:
        def __getattr__(self, name):
            attr = getattr(dist, name)
            if name != "all_reduce":
                return attr

            def counted(*args, **kw):
                calls[name] += 1
                return attr(*args, **kw)
            return counted

    states, steps, per_step = [], [], {False: [], True: []}
    for compiled in (False, True):
        model, state, step_cfg = tp_start(cfg)
        state = shard_tp_state(create_train_state(model.to(dev), BETAS, state.spec), grid)
        states.append(state)
        steps.append(make_sharded_train_step(model, step_cfg, grid, tp=True, compiled=compiled))
    noises = [Coins(TP_SEED, dev) for _ in range(2)]
    cuda_graphs.KEEP_NODES = True
    tp_mod.dist = Counting()
    equal = True
    try:
        for _ in coins:
            out = []
            for j, compiled in enumerate((False, True)):
                n0 = calls["all_reduce"]
                states[j], m = steps[j](states[j], noises[j], *local)
                per_step[compiled].append(calls["all_reduce"] - n0)
                out.append(m)
            equal &= all(torch.equal(out[0][k], out[1][k]) for k in out[0])
    finally:
        tp_mod.dist = dist
        cuda_graphs.KEEP_NODES = False
    torch.cuda.synchronize()
    a, b = states
    equal &= all(torch.equal(p, q) and torch.equal(p.grad, q.grad)
                 for p, q in zip(a.params(), b.params()))
    equal &= all(torch.equal(x, y) for xs, ys in zip(a.ema_params, b.ema_params)
                 for x, y in zip(xs, ys))
    (program,) = steps[1]._programs.values()
    nodes = {}
    for name, (graph, _) in program.graphs.items():
        path = os.path.join(out_dir, f"card_tp_rank{dist.get_rank()}_{name}.dot")
        graph.debug_dump(path)
        with open(path) as f:
            labels = re.findall(r'label="((?:[^"\\]|\\.)*)"', f.read())
        nodes[name] = sum("KERNEL" in lb.split("|")[0] and "nccl" in lb.lower() for lb in labels)
    eager_nccl = {}
    for coin in (True, False):
        noise = Coins(0, dev)
        noise.fixed = coin
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            steps[0](states[0], noise, *local)
            torch.cuda.synchronize()
        eager_nccl[VARIANT[coin]] = sum(e.count for e in prof.key_averages()
                                        if e.device_type == DeviceType.CUDA
                                        and "nccl" in e.key.lower())
    first = {c: coins.index(c) for c in set(coins)}
    np.savez(os.path.join(out_dir, f"card_tp_rank{dist.get_rank()}.npz"),
             equal=np.bool_(equal), graphs=np.asarray(sorted(nodes)),
             graph_nccl=np.asarray([nodes[VARIANT[c]] for c in (True, False)]),
             eager_nccl=np.asarray([eager_nccl[VARIANT[c]] for c in (True, False)]),
             eager_calls=np.asarray([per_step[False][first[c]] for c in (True, False)]),
             compiled_calls=np.asarray(per_step[True]), coins=np.asarray(coins))


# the cards' gspmd run: the global batch, the coins of its steps, and the
# full-width VG config (bf16, the kernels on), as chip_smoke.py phase 10
CARD_GLOBAL_BATCH, CARD_COINS = 64, [True, True, False]
VG_CONFIG = os.path.join(HERE, "..", "..", "configs", "edm_diffuse_sg_regular_visual_genome.yaml")


def run_card_gspmd(out_dir):
    from diffusesg_torch.config import load_config
    from diffusesg_torch.data import load_data
    from diffusesg_torch.models import build_model
    from diffusesg_torch.parallel.mesh import current_world
    from diffusesg_torch.parallel.sharded_step import (make_sharded_eval_step,
                                                       make_sharded_train_step, shard_train_state)
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train import (create_train_state, ema_slice, make_optimizer,
                                       train_step_config_from)

    world = current_world()
    dev = world.device
    cfg = load_config(VG_CONFIG)
    with cfg.unlocked():
        cfg.seed = 0
        cfg.dataset.synthetic_num_train = CARD_GLOBAL_BATCH
        cfg.dataset.synthetic_num_test = 8
    train = load_data(cfg, data_root="/nonexistent").train
    rows = CARD_GLOBAL_BATCH // world.size
    local = tuple(torch.from_numpy(np.ascontiguousarray(
        a[world.rank * rows:(world.rank + 1) * rows])).to(dev)
        for a in (train.adjs, train.nodes, train.node_flags))
    step_cfg = train_step_config_from(cfg)
    opt = make_optimizer(cfg.train.lr_init, cfg.train.lr_dacey, 1, cfg.train.weight_decay)

    class Coins(TorchNoise):
        def bernoulli(self, step, kind, p):
            return CARD_COINS[step % len(CARD_COINS)]

    out, metrics, states = {}, {}, {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    for compiled in (True, False):  # the compiled run first, alone on the card
        state = create_train_state(build_model(cfg, device=dev, seed=0),
                                   list(cfg.train.ema_coef), opt)
        state = shard_train_state(state, world)
        step = make_sharded_train_step(state.model, step_cfg, world, compiled=compiled)
        test = make_sharded_eval_step(state.model, step_cfg, world, compiled=compiled)
        noise, test_noise = Coins(1, dev), Coins(2, dev)
        got = []
        if compiled:
            torch.cuda.synchronize()
            out["state_bytes"] = np.int64(torch.cuda.memory_allocated() - base)
            torch.cuda.reset_peak_memory_stats()
        for i in range(len(CARD_COINS)):
            state, m = step(state, noise, *local)
            got.append(m)
        for i in range(2):  # the test pass on the smallest-beta EMA, both coins
            got.append(test(ema_slice(state, 0), test_noise, i, *local))
        ema_slice(state, -1)  # the largest-beta EMA, as the trainer's sampling takes it
        torch.cuda.synchronize()
        if compiled:
            zero = state.zero

            def nbytes(tensors):
                return sum(t.numel() * t.element_size() for t in tensors)
            (train_stats,), (test_stats,) = step.stats(), test.stats()
            out.update(
                steady_bytes=np.int64(torch.cuda.memory_allocated() - base),
                peak_bytes=np.int64(torch.cuda.max_memory_allocated() - base),
                params_bytes=np.int64(nbytes(b.data for b in zero.buckets.values())),
                grads_bytes=np.int64(nbytes(b.grad for b in zero.buckets.values())),
                adam_bytes=np.int64(nbytes(t for s in state.opt.state.values() for t in s.values()
                                    if t.dim() > 0)),
                emas_bytes=np.int64(nbytes(e for ema in state.ema_params for e in ema)),
                kept_bytes=np.int64(nbytes(zero._kept)),
                pools_bytes=np.int64(train_stats["pool_bytes"] + test_stats["pool_bytes"]),
                graphs=np.asarray(train_stats["variants"]),
                n_emas=np.int64(len(state.ema_params)))
        metrics[compiled], states[compiled] = got, state
    a, b = states[True], states[False]
    equal = all(x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
                for x, y in zip(metrics[True], metrics[False]))
    equal &= all(torch.equal(p, q) and torch.equal(p.grad, q.grad)
                 for p, q in zip(a.params(), b.params()))
    equal &= all(torch.equal(x, y) for xs, ys in zip(a.ema_params, b.ema_params)
                 for x, y in zip(xs, ys))
    equal &= all(torch.equal(x, y) for p, q in zip(a.opt.state.values(), b.opt.state.values())
                 for x, y in zip(p.values(), q.values()))
    out["equal"] = np.bool_(equal)
    np.savez(os.path.join(out_dir, f"card_gspmd_rank{world.rank}.npz"), **out)


def tp_batch(cfg):
    from torch_parity import clean_batch
    return clean_batch(len(TP_BATCH), cfg.dataset.max_node_num, TP_BATCH, seed=4)


def tp_start(cfg):
    """The tiny model's single-device state and step config, as every rank
    and the test's single-device run build them."""
    from torch_parity import tiny_port_model

    from diffusesg_torch.train import create_train_state, make_optimizer, train_step_config_from
    model = tiny_port_model(cfg)
    state = create_train_state(model, BETAS, make_optimizer(LR, DECAY, SPE, TP_WD, TP_CLIP))
    return model, state, train_step_config_from(cfg)


def run_tp(out_dir, dp, tp):
    import torch.distributed as dist

    from diffusesg_torch.parallel.mesh import make_grid
    from diffusesg_torch.parallel.sharded_step import make_sharded_train_step
    from diffusesg_torch.parallel.tp import gather_tp_state, shard_tp_state
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.utils.checkpoint import save_checkpoint

    cfg = tiny_config()
    grid = make_grid(int(dp), int(tp))
    model, state, step_cfg = tp_start(cfg)
    state = shard_tp_state(state, grid)
    step = make_sharded_train_step(model, step_cfg, grid, tp=True)
    b = len(TP_BATCH) // grid.size
    local = tuple(torch.from_numpy(np.ascontiguousarray(a[grid.rank * b:(grid.rank + 1) * b]))
                  for a in tp_batch(cfg))
    noise = TorchNoise(TP_SEED, "cpu")
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, noise, *local)
        losses.append(float(metrics["loss"]))
    # every rank's replicated leaves, which must stay equal on every rank
    np.savez(os.path.join(out_dir, f"tp_replicated_rank{dist.get_rank()}.npz"), **{
        n: p.detach().numpy() for (n, p), kind in zip(model.named_parameters(), state.tp.kinds)
        if kind not in ("qkv", "rows", "cols")})
    payload = gather_tp_state(state)
    save_checkpoint(os.path.join(out_dir, "tp_ckpt"), state, {"epoch": 0})
    if payload is not None:
        out = {"loss": np.asarray(losses)}
        names = [n for n, _ in model.named_parameters()]
        for i, n in enumerate(names):
            out[f"param/{n}"] = payload["params"][n].numpy()
            for k, ema in enumerate(payload["ema_params"]):
                out[f"ema{k}/{n}"] = ema[i].numpy()
            for m in ("exp_avg", "exp_avg_sq"):
                out[f"{m}/{n}"] = payload["opt_state"]["state"][i][m].numpy()
        np.savez(os.path.join(out_dir, "tp.npz"), **out)


def run_eval(out_dir):
    from diffusesg_torch.data import load_data
    from diffusesg_torch.parallel.mesh import current_world
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.sampling.orchestrator import sg_go_sampling
    from diffusesg_torch.utils.logging_utils import set_seed_and_logger

    world = current_world()
    cfg = eval_config(out_dir)
    set_seed_and_logger(cfg, mode="eval", log_level="WARNING")
    from torch_parity import tiny_port_model
    model = tiny_port_model(cfg).eval()
    bundle = load_data(cfg, eval_mode=True, data_root="/nonexistent")
    runs = {what: sg_go_sampling(model, None, get_mc_sampler(cfg), cfg, bundle, eval_mode=True,
                                 sanity_check=what == "sanity_check")
            for what in ("sanity_check", "model_inference")}
    if world.rank == 0:
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump({"logdir": cfg.logdir, **{
                what: {k: v for k, v in m.items() if not k.startswith("_")}
                for what, m in runs.items()}}, f)
    else:
        assert runs == {"sanity_check": {}, "model_inference": {}}, runs


def eval_config(exp_dir):
    """The tiny config evaluating 5 synthetic graphs at 4 sampling steps:
    with two ranks, rank 1's shard is wrap-padded."""
    cfg = tiny_config()
    with cfg.unlocked():
        cfg.exp_dir = exp_dir
        cfg.dataset.synthetic_num_train = 8
        cfg.dataset.synthetic_num_test = 5
        cfg.test.eval_size = 5
        cfg.test.batch_size = 2
        cfg.test.num_interim = 0
        cfg.mcmc.num_steps = 4
    return cfg


def main():
    from diffusesg_torch.parallel.distributed import maybe_initialize_distributed, shutdown
    torch.set_num_threads(1)
    what = sys.argv[1]
    # neither plots nor TensorBoard (optional in the port; the card's machine
    # has no matplotlib): the runs' logs, JSONL scalars and npz are what the
    # tests read, and the two imports would take most of a run's time
    sys.modules["matplotlib"] = sys.modules["tensorboard"] = None
    if what == "train":
        from diffusesg_torch.cli import train
        train.main(sys.argv[2:])
        print("CHILD_OK", os.environ["RANK"], flush=True)
        return
    assert maybe_initialize_distributed("cuda" if what.startswith("card") else "cpu")
    try:
        {"steps": run_steps, "eval": run_eval, "tp": run_tp, "compiled": run_compiled,
         "compiled_gspmd": run_compiled_gspmd, "compiled_tp": run_compiled_tp,
         "card_tp": run_card_tp, "card_gspmd": run_card_gspmd}[what](*sys.argv[2:])
    finally:
        shutdown()
    print("CHILD_OK", os.environ["RANK"], flush=True)


if __name__ == "__main__":
    main()
