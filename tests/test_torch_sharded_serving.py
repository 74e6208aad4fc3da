"""Serving across devices on the CPU: ``make_sharded_serving_fn`` /
``make_sharded_completion_fn`` over ``["cpu"] * 2`` and ``* 4`` against the
single-device core (``gspmd``: the whole batch; ``shard_map``: each block on
the seed's stream folded with its index, the host emulation of
tests/test_serving_multichip.py:74,207), the artifact over several devices,
and ``cli.serve``'s ``--devices`` rule against diffusesg_tpu/cli/serve.py:53-70.

The model is ``configs/vg_small_test.yaml`` at max_node_num 8 and 4 steps
with the seeded weights of ``torch_parity.tiny_port_model`` (no JAX model).
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_parity import node_flags  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CFG = os.path.join(REPO, "configs", "vg_small_test.yaml")
B, N, STEPS, SEED = 4, 8, 4, 11
COUNTS = [8, 6, 3, 1]
# boxes of one batch of rows against the same rows inside a batch of another
# size, fp32 on the CPU: the CPU's matrix products sum in an order that
# depends on the rows, so a block is not bit-equal to its rows of the whole
# batch (it is to the core on those rows).  The bar is the repo's for boxes
# after 4 Heun steps at fp32 (tests/test_torch_slice.py:23, SAMPLE_ATOL); the
# differences read up to 1.01e-5 here.  The decoded types are held equal.
BOX_ATOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tiny model's ops gain nothing from more, and
    a parallel test run (a process a core) makes each op wait for threads the
    others have descheduled, up to a hundred times slower."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    from torch_parity import tiny_port_model

    from diffusesg_torch.config import load_config
    from diffusesg_torch.sampling import get_mc_sampler
    cfg = load_config(SMALL_CFG)
    with cfg.unlocked():
        cfg.dataset.max_node_num = N
        cfg.mcmc.num_steps = STEPS
        cfg.test.batch_size = B
    model = tiny_port_model(cfg).eval()
    return cfg, model, get_mc_sampler(cfg)


def _known_parts(b=B):
    kn, mn = np.zeros((b, N), np.int32), np.zeros((b, N), bool)
    kb, mb = np.full((b, N, 4), 0.5, np.float32), np.zeros((b, N), bool)
    ka, ma = np.zeros((b, N, N), np.int32), np.zeros((b, N, N), bool)
    kn[:, 0], mn[:, 0] = 3, True
    kb[:, 0], mb[:, 0] = [0.25, 0.25, 0.1, 0.2], True
    ka[:, 0, 1], ma[:, 0, 1] = 2, True
    return kn, mn, kb, mb, ka, ma


def _cores(setup, what):
    from diffusesg_torch.serving.export import make_completion_fn, make_serving_fn
    cfg, model, sampler = setup
    make = make_serving_fn if what == "generate" else make_completion_fn
    return make(model, sampler, cfg)


def _sharded(setup, what, devices, mode):
    from diffusesg_torch.serving.export import (make_sharded_completion_fn,
                                                make_sharded_serving_fn)
    cfg, model, sampler = setup
    make = make_sharded_serving_fn if what == "generate" else make_sharded_completion_fn
    return make(model, sampler, cfg, devices, mode)


def _args(what, b=B):
    flags = node_flags(b, N, (COUNTS * 2)[:b])
    return (flags,) if what == "generate" else (flags,) + _known_parts(b)


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _decoded_equal(got, want):
    """Types equal, boxes within BOX_ATOL (another batch size)."""
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=BOX_ATOL)


@pytest.mark.parametrize("what", ["generate", "complete"])
@pytest.mark.parametrize("shards", [2, 4])
def test_gspmd_equals_the_single_device_core_on_the_whole_batch(setup, what, shards):
    """Each block draws its rows of the whole batch's draws, so the blocks
    joined are the single-device function over the whole batch; each block
    alone is the core on its rows with those rows' draws."""
    from diffusesg_torch.parallel.mesh import World
    from diffusesg_torch.parallel.mesh import GlobalRows
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.serving.export import fixed_batch
    fn = _sharded(setup, what, ["cpu"] * shards, "gspmd")
    args = _args(what)
    whole = fixed_batch(_cores(setup, what), B, N, "cpu")
    _decoded_equal(fn(SEED, *args), whole(SEED, *args))
    # an injected source: the same draws in the same order
    _decoded_equal(fn(SEED, *args, noise=TorchNoise(3, "cpu")),
                   whole(SEED, *args, noise=TorchNoise(3, "cpu")))
    got = fn(SEED, *args)
    per = B // shards
    part = fixed_batch(_cores(setup, what), per, N, "cpu")
    for i in range(shards):
        rows = [a[i * per:(i + 1) * per] for a in args]
        draws = GlobalRows(TorchNoise(SEED, "cpu"), World(i, shards, torch.device("cpu")))
        _equal([g[i * per:(i + 1) * per] for g in got], part(SEED, *rows, noise=draws))


@pytest.mark.parametrize("what", ["generate", "complete"])
@pytest.mark.parametrize("shards", [2, 4])
def test_shard_map_equals_the_folded_host_emulation(setup, what, shards):
    """Block i runs the core on its rows with the seed's stream folded with
    i (export.py:114-120); a source passed in is folded the same way."""
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.serving.export import fixed_batch
    fn = _sharded(setup, what, ["cpu"] * shards, "shard_map")
    args = _args(what)
    per = B // shards
    part = fixed_batch(_cores(setup, what), per, N, "cpu")
    for noise, base in ((None, TorchNoise(SEED, "cpu")), (TorchNoise(5, "cpu"),
                                                          TorchNoise(5, "cpu"))):
        got = fn(SEED, *args, noise=noise)
        for i in range(shards):
            rows = [a[i * per:(i + 1) * per] for a in args]
            _equal([g[i * per:(i + 1) * per] for g in got],
                   part(SEED, *rows, noise=base.fold_in(i)))
    # the streams differ from the single-device program's
    whole = fixed_batch(_cores(setup, what), B, N, "cpu")(SEED, *args)
    assert not all(np.array_equal(g, w) for g, w in zip(fn(SEED, *args), whole))


@pytest.mark.parametrize("mode", ["gspmd", "shard_map"])
def test_a_batch_the_shards_do_not_divide_raises(setup, mode):
    fn = _sharded(setup, "generate", ["cpu"] * 4, mode)
    with pytest.raises(ValueError, match="does not split over 4 devices"):
        fn(SEED, node_flags(6, N, [3] * 6))
    with pytest.raises(ValueError, match="unknown spmd_mode"):
        _sharded(setup, "generate", ["cpu"] * 2, "pjit")


def test_artifact_over_two_devices_round_trips_and_is_refused_on_one(setup, tmp_path):
    from diffusesg_torch.serving.export import export_sampler, load_artifact, save_artifact
    cfg, model, sampler = setup
    art = str(tmp_path / "art")
    save_artifact(art, export_sampler(model, sampler, cfg, B, num_devices=2,
                                      spmd_mode="shard_map"), cfg, B)
    with pytest.raises(RuntimeError, match="spans 2 devices but this process has 1"):
        load_artifact(art, device="cpu")
    fn, meta = load_artifact(art, device="cpu", devices=["cpu", "cpu"])
    assert meta["num_devices"] == 2 and meta["batch_size"] == B
    flags = _args("generate")[0]
    _equal(fn(SEED, flags), _sharded(setup, "generate", ["cpu"] * 2, "shard_map")(SEED, flags))
    with pytest.raises(ValueError, match="shape"):
        fn(SEED, flags[:2])
    with pytest.raises(ValueError, match="must divide over the 3 devices"):
        export_sampler(model, sampler, cfg, B, num_devices=3)


@pytest.mark.parametrize("n_local", [1, 2, 4, 8])
def test_devices_rule_matches_jax_case_by_case(monkeypatch, n_local):
    """``resolve_devices`` takes the device count, refusals and messages of
    the JAX package's ``_resolve_mesh`` for every flag and batch."""
    import jax

    import diffusesg_tpu.parallel.mesh as jmesh
    from diffusesg_tpu.cli.serve import _resolve_mesh
    from diffusesg_torch.cli.serve import resolve_devices
    local = [torch.device("cpu")] * n_local
    monkeypatch.setattr(jax, "local_devices", lambda: list(range(n_local)))
    monkeypatch.setattr(jmesh, "make_mesh", lambda n, devices=None: ("mesh", n))
    for flag in (0, 1, 2, 3, 4, 8, 16):
        for batch in (4, 6, 8, 12):
            try:
                want = _resolve_mesh(flag, batch)[1]
            except SystemExit as e:
                with pytest.raises(SystemExit) as got:
                    resolve_devices(flag, batch, local)
                assert str(got.value) == str(e), (flag, batch)
                continue
            assert len(resolve_devices(flag, batch, local)) == want, (flag, batch)


def test_serve_cli_serves_and_exports_across_devices(setup, tmp_path, monkeypatch):
    """cli.serve with --devices 2 on a process that sees two devices builds
    the sharded functions (tpu.spmd_mode: auto picks gspmd with the kernels
    off) and --export_to writes an artifact over two."""
    import diffusesg_torch.serving.export as export
    from diffusesg_torch.cli import serve as serve_cli
    from diffusesg_torch.config import save_config
    from diffusesg_torch.serving.export import fixed_batch, load_artifact
    from diffusesg_torch.train import create_train_state, make_optimizer
    from diffusesg_torch.utils.checkpoint import save_checkpoint
    cfg, model, _ = setup
    run = tmp_path / "run"
    os.makedirs(run)
    save_config(cfg, str(run / "config.yaml"))
    state = create_train_state(model, list(cfg.train.ema_coef), make_optimizer(1e-4, 1.0, 1))
    save_checkpoint(str(run / "models_ckpt" / "00000"), state, {"epoch": 0})
    monkeypatch.setattr(export, "local_devices", lambda device: [torch.device("cpu")] * 2)
    argv = ["-p", str(run), "--device", "cpu", "--devices", "2", "--ema", "none"]
    fn, complete_fn, batch, n, _, _, (_, _, devices, mode) = serve_cli._load_from_checkpoint(
        serve_cli.build_serve_parser().parse_args(argv))
    assert (batch, n, len(devices), mode) == (B, N, 2, "gspmd")
    flags = _args("generate")[0]
    _decoded_equal(fn(SEED, flags),
                   fixed_batch(_cores(setup, "generate"), B, N, "cpu")(SEED, flags))
    _decoded_equal(complete_fn(SEED, *_args("complete")),
                   fixed_batch(_cores(setup, "complete"), B, N, "cpu")(SEED, *_args("complete")))
    art = str(tmp_path / "art")
    serve_cli.main(argv + ["--export_to", art])
    _, meta = load_artifact(art, device="cpu")
    assert meta["num_devices"] == 2
    with pytest.raises(SystemExit, match="--devices 3 but only 2 local devices"):
        serve_cli._load_from_checkpoint(serve_cli.build_serve_parser().parse_args(
            ["-p", str(run), "--device", "cpu", "--devices", "3"]))
