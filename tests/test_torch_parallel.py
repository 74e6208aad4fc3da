"""The port's data-parallel layer in one process: the rendezvous, the mode
choice, the batch split, the eval shards and their trim against the JAX
package; the data-parallel step at world 1 through gloo against the
single-device step; a rendezvous that fails, or asks for a card that is not
there, raises.

The step cases run the tiny config of __graft_entry__.py:18-27 at fp32 on the
CPU.  At world 1 the mean all-reduce is the identity, so the ``shard_map``
step must equal the single-device step bit for bit, given the same state and
noise; the ``gspmd`` step divides the local sum by the global batch instead
of taking the mean, and is held to tests/test_torch_train_step.py's bars.
"""
import copy
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_parity import (SMALL_CFG, VG_CFG, COCO_CFG, clean_batch, free_port,  # noqa: E402
                          tiny_overrides, tiny_port_model)

RDV_VARS = ["DSG_COORDINATOR", "DSG_NUM_PROCESSES", "DSG_PROCESS_ID", "MASTER_ADDR",
            "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK", "OMPI_COMM_WORLD_RANK",
            "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK", "DSG_DIST_TIMEOUT"]

ENVS = {
    "none": {},
    "torchrun": dict(MASTER_ADDR="10.0.0.1", MASTER_PORT="29500", RANK="3", WORLD_SIZE="8"),
    "torchrun_default_port": dict(MASTER_ADDR="10.0.0.1", RANK="0", WORLD_SIZE="2"),
    "ompi": dict(MASTER_ADDR="10.0.0.2", OMPI_COMM_WORLD_RANK="5",
                 OMPI_COMM_WORLD_SIZE="6"),
    "ompi_without_addr": dict(OMPI_COMM_WORLD_RANK="5", OMPI_COMM_WORLD_SIZE="6"),
    "dsg_over_torchrun": dict(DSG_COORDINATOR="127.0.0.1:1234", DSG_NUM_PROCESSES="2",
                              DSG_PROCESS_ID="1", MASTER_ADDR="10.0.0.1", RANK="3",
                              WORLD_SIZE="8"),
    "torchrun_over_ompi": dict(MASTER_ADDR="10.0.0.3", MASTER_PORT="1", RANK="1",
                               WORLD_SIZE="4", OMPI_COMM_WORLD_RANK="2",
                               OMPI_COMM_WORLD_SIZE="3"),
}


def _set_env(monkeypatch, env):
    for var in RDV_VARS:
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("case", sorted(ENVS))
def test_detect_rendezvous_matches_jax(monkeypatch, case):
    from diffusesg_torch.parallel.distributed import detect_rendezvous
    from diffusesg_tpu.parallel.distributed import detect_rendezvous as jax_detect
    _set_env(monkeypatch, ENVS[case])
    assert detect_rendezvous() == jax_detect()


@pytest.mark.parametrize("path", [SMALL_CFG, VG_CFG, COCO_CFG])
def test_resolve_spmd_mode_matches_jax(path):
    from diffusesg_torch.config import load_config
    from diffusesg_torch.parallel.mesh import resolve_spmd_mode
    from diffusesg_tpu.config import load_config as jload
    from diffusesg_tpu.parallel.mesh import resolve_spmd_mode as jax_resolve
    for mode in ("auto", "gspmd", "shard_map"):
        for kernels in (False, True):
            over = {"tpu.spmd_mode": mode, "tpu.use_pallas_attention": kernels}
            cfg, jcfg = load_config(path, overrides=over), jload(path, overrides=over)
            for size in (1, 2, 8):
                assert resolve_spmd_mode(cfg, size) == jax_resolve(jcfg, size), (mode, kernels, size)
    # the shipped configs as they are
    assert resolve_spmd_mode(load_config(path), 2) == jax_resolve(jload(path), 2)


def test_per_host_batch_size_follows_jax(monkeypatch):
    """JAX's formula with the world size for its process count and one card
    per process (mesh.py:67-77)."""
    import jax
    from diffusesg_torch.parallel.mesh import per_host_batch_size
    from diffusesg_tpu.parallel import mesh as jmesh
    for world in (1, 2, 3, 4, 8):
        monkeypatch.setattr(jax, "process_count", lambda w=world: w)
        for batch in (1, 3, 4, 7, 64, 1000):
            assert per_host_batch_size(batch, world) == jmesh.per_host_batch_size(batch, world)


def _synthetic(n):
    from diffusesg_torch.data.dataset import SceneGraphData
    rng = np.random.default_rng(n)
    return SceneGraphData(adjs=rng.standard_normal((n, 4, 4)).astype(np.float32),
                          nodes=rng.standard_normal((n, 4, 5)).astype(np.float32),
                          node_flags=rng.random((n, 4)) > 0.3, image_ids=np.arange(n) + 100,
                          pkl_data=[{"image_id": int(i)} for i in range(n)],
                          num_node_type=3, num_edge_type=2)


@pytest.mark.parametrize("n", [5, 7, 11, 13])
def test_shard_for_process_and_trim_match_jax(n):
    """The eval shards equal JAX's (wrap-padded to one length), the rows that
    the orchestrator keeps of their rank-order gather are JAX's, each eval row
    once, and the trim returns them in the eval set's order."""
    from diffusesg_torch.data.loader import shard_for_process
    from diffusesg_torch.sampling.orchestrator import process_padding_keep, trim_process_padding
    from diffusesg_tpu.data.loader import shard_for_process as jax_shard
    data = _synthetic(n)
    assert shard_for_process(data, 0, 1) is data
    for world in (2, 3, 4):
        shards = [shard_for_process(data, r, world) for r in range(world)]
        for r, shard in enumerate(shards):
            want = jax_shard(data, r, world)
            for f in ("adjs", "nodes", "node_flags", "image_ids", "pkl_data"):
                np.testing.assert_array_equal(np.asarray(getattr(shard, f)),
                                              np.asarray(getattr(want, f)))
        assert len({len(s) for s in shards}) == 1
        gathered = np.concatenate([s.image_ids for s in shards])
        # the JAX orchestrator's keep (orchestrator.py:399-405), written out
        k_per = -(-n // world)
        jax_keep = np.concatenate([np.arange(p * k_per, p * k_per + n // world
                                             + (1 if p < n % world else 0))
                                   for p in range(world)])
        keep = process_padding_keep(n, world)
        np.testing.assert_array_equal(keep, jax_keep)
        assert sorted(gathered[keep]) == list(data.image_ids)
        res = {"image_ids": gathered, "raw_a": np.concatenate([s.adjs for s in shards]),
               "interim_a": np.zeros((3, 2))}
        trimmed = trim_process_padding(res, n, world)
        np.testing.assert_array_equal(trimmed["image_ids"], data.image_ids)
        np.testing.assert_array_equal(trimmed["raw_a"], data.adjs)
        assert trimmed["interim_a"].shape == (3, 2)


def test_rank_streams_fold_in_once():
    """``TorchNoise.fold_in`` is a stream of its own for each index, the same
    for the same seed; a folded stream advances as it draws, so the trainer
    folds once, where the stream is made: under ``shard_map`` its steps draw
    from ``noise.fold_in(rank)``, and a world of one keeps the single-device
    steps and the stream as it was."""
    from diffusesg_torch.config import load_config
    from diffusesg_torch.parallel.mesh import World
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train import train_step_config_from
    from diffusesg_torch.train.trainer import _steps
    a, b = TorchNoise(5, "cpu"), TorchNoise(5, "cpu")
    d0, d1 = a.fold_in(0).normal(0, "sigma", (4,)), a.fold_in(1).normal(0, "sigma", (4,))
    assert not torch.equal(d0, d1)
    assert torch.equal(d0, b.fold_in(0).normal(0, "sigma", (4,)))
    assert not torch.equal(d0, TorchNoise(5, "cpu").normal(0, "sigma", (4,)))
    s = a.fold_in(1)
    assert not torch.equal(s.normal(0, "x", (3,)), s.normal(0, "x", (3,)))

    cfg = tiny_overrides(load_config(SMALL_CFG))
    with cfg.unlocked():
        cfg.tpu.spmd_mode = "shard_map"
    state, noise = _state(cfg), TorchNoise(5, "cpu")
    cpu = torch.device("cpu")
    got = _steps(state.model, state, cfg, train_step_config_from(cfg), World(1, 2, cpu), noise)
    assert got[0] is state and got[3] is not noise
    first = got[3].normal(0, "sigma", (4,))
    assert torch.equal(first, TorchNoise(5, "cpu").fold_in(1).normal(0, "sigma", (4,)))
    assert not torch.equal(got[3].normal(0, "sigma", (4,)), first)  # the same stream, on
    for world in (None, World(0, 1, cpu)):
        got = _steps(state.model, state, cfg, train_step_config_from(cfg), world, noise)
        assert got[0] is state and got[3] is noise


def test_global_rows_are_the_ranks_rows_of_the_global_draw():
    from diffusesg_torch.parallel.mesh import World
    from diffusesg_torch.parallel.mesh import GlobalRows
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    full = TorchNoise(3, "cpu").normal(0, "noise_adj", (6, 4, 4))
    coin = TorchNoise(3, "cpu")
    coin.normal(0, "noise_adj", (6, 4, 4))
    want_coin = coin.bernoulli(0, "self_cond", 0.5)
    for rank in range(3):
        rows = GlobalRows(TorchNoise(3, "cpu"), World(rank, 3, torch.device("cpu")))
        assert torch.equal(rows.normal(0, "noise_adj", (2, 4, 4)), full[2 * rank:2 * rank + 2])
        assert rows.bernoulli(0, "self_cond", 0.5) == want_coin


def test_collectives_without_a_process_group():
    """With no process group every helper is the single-process identity."""
    from diffusesg_torch.parallel.mesh import (any_rank, current_world, fetch_to_host,
                                               gather_to_host, is_main_process)
    assert current_world() is None and is_main_process()
    x = np.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(gather_to_host(x), x)
    assert any_rank(True) and not any_rank(False)
    m = [{"loss": torch.tensor(1.5), "sigmas": torch.tensor([1.0, 2.0])}]
    got = fetch_to_host(m)
    assert float(got[0]["loss"]) == 1.5 and list(got[0]["sigmas"]) == [1.0, 2.0]


@pytest.fixture()
def world_one(monkeypatch):
    """A gloo process group of one rank in this process, as torchrun's
    variables describe it."""
    from diffusesg_torch.parallel.distributed import maybe_initialize_distributed, shutdown
    from diffusesg_torch.parallel.mesh import current_world
    _set_env(monkeypatch, dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0"))
    assert maybe_initialize_distributed("cpu")
    try:
        yield current_world()
    finally:
        shutdown()


def _state(cfg, lr=2e-3):
    from diffusesg_torch.train import create_train_state, make_optimizer
    return create_train_state(tiny_port_model(cfg), [0.9, 0.999], make_optimizer(lr, 0.5, 1, 1e-2))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_world_one_shard_map_step_is_the_single_device_step(world_one):
    """Two steps (self-conditioning on, both coin values, the learning rate
    halving between them) through gloo at world 1: parameters, Adam moments,
    EMAs and metrics bit-equal to the single-device step on the same draws."""
    from diffusesg_torch.config import load_config
    from diffusesg_torch.parallel.shardmap_dp import make_shardmap_train_step
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train import make_train_step, train_step_config_from
    cfg = tiny_overrides(load_config(SMALL_CFG))
    step_cfg = train_step_config_from(cfg)
    batch = tuple(torch.from_numpy(a) for a in clean_batch(2, 16, [16, 5], seed=9))
    one, dp = _state(cfg), _state(cfg)
    single = make_train_step(one.model, step_cfg)
    data_parallel = make_shardmap_train_step(dp.model, step_cfg, world_one)
    # the rank's stream, folded where it is made, and the same draws for the
    # single-device step
    noise, plain = TorchNoise(4, "cpu").fold_in(0), TorchNoise(4, "cpu").fold_in(0)
    for _ in range(2):
        one, m1 = single(one, plain, *batch)
        dp, m2 = data_parallel(dp, noise, *batch)
        for k in m1:
            assert torch.equal(m1[k], m2[k]), k
    assert _same(one.params(), dp.params())
    for a, b in zip(one.ema_params, dp.ema_params):
        assert _same(a, b)
    for p, q in zip(one.params(), dp.params()):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(one.opt.state[p][k], dp.opt.state[q][k])
    assert one.opt.param_groups[0]["lr"] == dp.opt.param_groups[0]["lr"] == 1e-3


def test_world_one_gspmd_step_and_zero_checkpoint(world_one, tmp_path):
    """The ``gspmd`` step with ZeRO-1 at world 1 stays within the training
    step's bars of the single-device step, its learning rate reaches the
    range Adam, and its checkpoint restores bit-equal in a single-device
    state.  At world 1 the rank owns the flat buffer whole; each parameter
    starts at an aligned address."""
    from diffusesg_torch.config import load_config
    from diffusesg_torch.parallel.sharded_step import make_sharded_train_step, shard_train_state
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train import make_train_step, train_step_config_from
    from diffusesg_torch.train.train_state import whole_emas_and_opt
    from diffusesg_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
    cfg = tiny_overrides(load_config(SMALL_CFG))
    step_cfg = train_step_config_from(cfg)
    batch = tuple(torch.from_numpy(a) for a in clean_batch(2, 16, [16, 5], seed=9))
    one = _state(cfg)
    dp = shard_train_state(_state(cfg), world_one)
    (bucket,) = dp.zero.buckets.values()
    assert (bucket.lo, bucket.hi) == (0, bucket.data.numel())
    assert dp.zero.padding() == [bucket.data.numel() - sum(p.numel() for p in dp.params())]
    assert all((p.data_ptr() - bucket.data.data_ptr()) % 512 == 0 for p in dp.params())
    assert len(dp.opt.param_groups[0]["params"]) == 1
    single = make_train_step(one.model, step_cfg)
    sharded = make_sharded_train_step(dp.model, step_cfg, world_one)
    noise_a, noise_b = TorchNoise(4, "cpu"), TorchNoise(4, "cpu")
    for _ in range(2):
        one, m1 = single(one, noise_a, *batch)
        dp, m2 = sharded(dp, noise_b, *batch)
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=2e-4)
    assert dp.opt.param_groups[0]["lr"] == 1e-3
    for p, q in zip(one.params(), dp.params()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), rtol=0,
                                   atol=1e-4 * float(p.detach().abs().max()) + 0.05 * 2e-3 * 2)
    path = save_checkpoint(str(tmp_path / "zero"), dp, {"epoch": 1})
    back = _state(cfg)
    assert restore_checkpoint(path, back) == {"epoch": 1} and back.step == 2
    assert _same(back.params(), dp.params())
    emas, opt = whole_emas_and_opt(dp)
    for a, b in zip(back.ema_params, emas):
        assert _same(a, b)
    for i, p in enumerate(back.params()):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(back.opt.state[p][k], opt["state"][i][k])
    # and a single-device checkpoint resumes into the ZeRO-1 state
    again = shard_train_state(copy.deepcopy(back), world_one)
    emas, opt = whole_emas_and_opt(again)
    for i, p in enumerate(back.params()):
        assert torch.equal(opt["state"][i]["exp_avg"], back.opt.state[p]["exp_avg"])
    for a, b in zip(back.ema_params, emas):
        assert _same(a, b)


def test_failed_rendezvous_raises(monkeypatch):
    """A configured rendezvous whose peers never come raises once its time is
    up: no process carries on alone as rank 0."""
    import torch.distributed as dist
    from diffusesg_torch.parallel.distributed import maybe_initialize_distributed
    _set_env(monkeypatch, dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                               RANK="1", WORLD_SIZE="2", DSG_DIST_TIMEOUT="2"))
    with pytest.raises(RuntimeError, match="rendezvous was configured"):
        maybe_initialize_distributed("cpu")
    assert not dist.is_initialized()


def test_cli_train_refuses_a_failed_rendezvous(monkeypatch, tmp_path):
    """``cli.train`` under a rendezvous that fails raises before it writes a
    run dir; asked for the card where there is none, it raises too."""
    from diffusesg_torch.cli import train
    _set_env(monkeypatch, dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                               RANK="1", WORLD_SIZE="2", DSG_DIST_TIMEOUT="2"))
    argv = ["-c", SMALL_CFG, "--data_root", "/nonexistent", "-o", f"exp_dir={tmp_path}"]
    with pytest.raises(RuntimeError, match="rendezvous was configured"):
        train.main(argv + ["--device", "cpu"])
    assert os.listdir(tmp_path) == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            train.main(argv)
        assert os.listdir(tmp_path) == []


def test_rendezvous_for_the_card_without_one_raises(monkeypatch):
    import torch.distributed as dist
    from diffusesg_torch.parallel.distributed import maybe_initialize_distributed
    from diffusesg_torch.utils.device import resolve_device
    _set_env(monkeypatch, dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0"))
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            maybe_initialize_distributed("cuda")
    assert not dist.is_initialized()
