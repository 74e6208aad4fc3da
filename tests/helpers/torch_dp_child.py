"""One rank of the port's data-parallel tests on the CPU (gloo).

    python tests/helpers/torch_dp_child.py steps <out_dir>
    python tests/helpers/torch_dp_child.py train <cli.train arguments>
    python tests/helpers/torch_dp_child.py eval <out_dir>
    python tests/helpers/torch_dp_child.py tp <out_dir> <dp> <tp>
    python tests/helpers/torch_dp_child.py compiled <out_dir>

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
runs' metrics and final state, and the compiled step's graphs, to
``<out_dir>/compiled_rank<r>.npz``.
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
        held = state.opt.optim.state if mode == "gspmd" else state.opt.state
        out["adam_bytes"] = np.int64(sum(t.numel() * t.element_size() for s in held.values()
                                         for t in s.values() if t.dim() > 0))
        out["ema_bytes"] = np.int64(sum(t.numel() * t.element_size() for ema in state.ema_params
                                        for t in ema if t is not None))
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
            for i in range(COMPILED_STEPS):
                state, metrics = step(state, noise, *local)
                for k, v in metrics.items():
                    out[f"{tag}/step{i}/{k}"] = v.numpy()
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
    assert maybe_initialize_distributed("cpu")
    try:
        {"steps": run_steps, "eval": run_eval, "tp": run_tp,
         "compiled": run_compiled}[what](*sys.argv[2:])
    finally:
        shutdown()
    print("CHILD_OK", os.environ["RANK"], flush=True)


if __name__ == "__main__":
    main()
