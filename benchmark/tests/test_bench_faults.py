"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU at a tiny size (the program's plain versions, float32), with the
cell's own limits: once sound, then with each fault the cell can have."""
import os
import time

import pytest
import torch
import torch.multiprocessing as mp

from conftest import tiny
from reference.model import Shape

SEED = 2 ** 33 + 12345


def _correct(cell, seconds=0.3, trace=False, world=None, device="cpu"):
    import run
    res = cell.driver().run(cell, SEED, seconds, trace, torch.device(device), time.time(),
                            world)
    return run.result_line(cell, res, trace, "cpu")


@pytest.mark.parametrize("name", ["vg.sample", "coco.sample"])
def test_sampling_sound_then_an_answer_altered(name, monkeypatch):
    cell = tiny(name)
    line = _correct(cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 3 and line["failed"] == 0

    from diffusesg_torch.serving import export
    real = export.make_serving_fn

    def altered(*a, **k):
        fn = real(*a, **k)

        def serve(seed, flags, noise=None):
            adj, node, box = fn(seed, flags, noise=noise)
            box = box.clone()
            box[0][flags[0]] += 0.25  # one graph's boxes moved where they are produced
            return adj, node, box
        return serve
    monkeypatch.setattr(export, "make_serving_fn", altered)
    line = _correct(cell)
    assert not line["correct"]
    assert line["checks"]["box_gap"]["value"] > line["checks"]["box_gap"]["limit"]


def test_sampling_node_types_decoded_wrong(monkeypatch):
    """Every node type one level off where it is decoded (a wrong level
    mapping): the node level gap fails (compared in COCO; VG prints it)."""
    cell = tiny("coco.sample")
    from diffusesg_torch.serving import export
    real = export.make_serving_fn
    types = Shape.of(cell.model_config).node_types

    def shifted(*a, **k):
        fn = real(*a, **k)

        def serve(seed, flags, noise=None):
            adj, node, box = fn(seed, flags, noise=noise)
            return adj, torch.where(flags, (node + 1) % types, node), box
        return serve
    monkeypatch.setattr(export, "make_serving_fn", shifted)
    line = _correct(cell)
    assert not line["correct"]
    check = line["checks"]["node_level_gap"]
    assert check["value"] > check["limit"], check


def test_sampling_traced_run_reads_its_metrics():
    line = _correct(tiny("vg.sample"), trace=True)
    assert line["correct"]
    assert "breakdown" in line and line["device"]["window_s"] > 0
    assert line["metrics"]["mfu.sample"]["value"] > 0


def test_training_sound(monkeypatch):
    line = _correct(tiny("vg.train"))
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1


def test_training_state_unchanged(monkeypatch):
    from diffusesg_torch.train import train_step
    monkeypatch.setattr(train_step.TrainStep, "update", lambda self, state: None)
    line = _correct(tiny("vg.train"))
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] > line["checks"]["change_gap"]["limit"]


def test_training_half_the_batch(monkeypatch):
    from diffusesg_torch.train import compiled
    real = compiled.CompiledTrainStep.__call__

    def half(self, state, noise, adjs, nodes, flags):
        h = adjs.shape[0] // 2
        return real(self, state, noise, adjs[:h], nodes[:h], flags[:h])
    monkeypatch.setattr(compiled.CompiledTrainStep, "__call__", half)
    line = _correct(tiny("vg.train"))
    assert not line["correct"], line["checks"]


class _Stale:
    """Draws where every step after ``after`` gets ``stale``'s: ``draws``
    repeats step 0's noise, ``coin`` drops the conditioning pass."""

    def __init__(self, inner, stale: str, after: int = 1):
        self.inner, self.stale, self.after = inner, stale, after

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def normal(self, step, kind, shape):
        return self.inner.normal(0 if self.stale == "draws" else step, kind, shape)

    def uniform(self, step, kind, shape):
        return self.inner.uniform(0 if self.stale == "draws" else step, kind, shape)

    def bernoulli(self, step, kind, p):
        hit = self.inner.bernoulli(step, kind, p)
        return False if self.stale == "coin" and step > self.after else hit


@pytest.mark.parametrize("stale", ["batch", "draws", "coin"])
def test_training_replay_stale(stale, monkeypatch):
    """A fault that lives in the replays alone, after each variant's first
    use: the batch or the draws of an earlier step fed again (a stale
    static buffer), or the variant with the conditioning pass replayed
    without it.  The compared steps are replays, so the check fails."""
    from diffusesg_torch.train import compiled
    real = compiled.CompiledTrainStep.__call__
    first = {}

    def stale_call(self, state, noise, *batch):
        if stale == "batch":
            # the last eager step's batch, fed again to every replay
            if state.step <= 1:
                first["batch"] = batch
            return real(self, state, noise, *first["batch"])
        return real(self, state, _Stale(noise, stale), *batch)
    monkeypatch.setattr(compiled.CompiledTrainStep, "__call__", stale_call)
    line = _correct(tiny("vg.train"))
    assert not line["correct"], line["checks"]


def _rank(rank, world_size, port, fault, out):
    import traceback

    import torch.distributed as dist
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank))
    try:
        from diffusesg_torch.parallel import distributed, mesh
        if fault:
            from diffusesg_torch.train import train_step
            train_step.TrainStep.reduce_grads = lambda self, state: None
        distributed.maybe_initialize_distributed("cpu")
        world = mesh.current_world()
        cell = tiny("vg.train", chips=4, traffic="train_dp")
        import run
        res = cell.driver().run(cell, SEED, 0.3, False, torch.device("cpu"), time.time(), world)
        if rank == 0:
            out.put(run.result_line(cell, res, False, "cpu"))
    except BaseException:
        out.put({"error": rank, "trace": traceback.format_exc()})
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "exchange_left_out"])
def test_data_parallel_on_four_cpu_ranks(fault):
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, 4, port, fault, out)) for r in range(4)]
    for p in procs:
        p.start()
    try:
        line = out.get(timeout=300)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert "error" not in line, line.get("trace")
    for p in procs:
        p.join(timeout=120)
        assert not p.is_alive()
        assert p.exitcode == 0
    if fault:
        assert not line["correct"], line["checks"]
    else:
        assert line["correct"], line["checks"]
