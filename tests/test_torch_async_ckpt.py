"""Asynchronous checkpoints on the CPU (``tpu.async_checkpointing``, the JAX
package's orbax async saves): a save in the background restores equal to
the state at the save, discovery skips a write in flight, a restore waits
for it, the trainer drains its writes with the JAX trainer's error rules
(diffusesg_tpu/train/trainer.py:302-318), and a ``cli.train`` run with the
config's asynchronous saves resumes; that run's ``backup_code`` copy of the
package is checked too.
"""
import os
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_parity import SMALL_CFG, clean_batch, tiny_overrides, tiny_port_model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tiny model's ops gain nothing from more, and
    a parallel test run (a process a core) makes each op wait for threads the
    others have descheduled, up to a hundred times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_plots_or_tensorboard(monkeypatch):
    """The runs' checkpoints and logs are what these tests read: no
    TensorBoard (its import alone takes seconds) and no plots, both optional
    in the port (as tests/helpers/torch_dp_child.py runs its ranks)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def _state_and_step():
    from diffusesg_torch.config import load_config
    from diffusesg_torch.train import (create_train_state, make_optimizer, make_train_step,
                                       train_step_config_from)
    cfg = tiny_overrides(load_config(SMALL_CFG))
    model = tiny_port_model(cfg)
    state = create_train_state(model, [0.9, 0.999], make_optimizer(2e-3, 1.0, 1, 1e-2))
    step = make_train_step(model, train_step_config_from(cfg))
    batch = tuple(torch.from_numpy(a) for a in clean_batch(2, 16, [16, 7], seed=3))
    return state, step, batch


def _snapshot(state):
    return ([p.detach().clone() for p in state.params()],
            [[e.clone() for e in ema] for ema in state.ema_params],
            {i: {k: torch.as_tensor(v).clone() for k, v in s.items()}
             for i, s in state.opt.state_dict()["state"].items()})


def test_async_save_restores_the_state_at_the_save(tmp_path):
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.utils.checkpoint import (restore_checkpoint, save_checkpoint,
                                                  wait_for_async_saves)
    state, step, batch = _state_and_step()
    noise = TorchNoise(0, "cpu")
    step(state, noise, *batch)
    params, emas, moments = _snapshot(state)
    path = save_checkpoint(str(tmp_path / "00000"), state, {"epoch": 0}, asynchronous=True)
    step(state, noise, *batch)  # the state moves on while the write may be in flight
    wait_for_async_saves()
    other, _, _ = _state_and_step()
    assert restore_checkpoint(path, other) == {"epoch": 0} and other.step == 1
    for a, b in zip(other.params(), params):
        assert torch.equal(a, b)
    for ea, eb in zip(other.ema_params, emas):
        assert all(torch.equal(a, b) for a, b in zip(ea, eb))
    got = other.opt.state_dict()["state"]
    for i, s in moments.items():
        assert all(torch.equal(torch.as_tensor(got[i][k]), v) for k, v in s.items())


def test_discovery_skips_a_write_in_flight(tmp_path):
    from diffusesg_torch.utils.checkpoint import (is_finalized_checkpoint, latest_checkpoint,
                                                  list_checkpoints, select_checkpoints)
    done = tmp_path / "00000.pt"
    torch.save({"step": 0}, done)
    in_flight = tmp_path / ".tmp-abc123.pt"  # a write not yet renamed into place
    torch.save({"step": 1}, in_flight)
    os.utime(in_flight, (time.time() + 60, time.time() + 60))  # and newer
    assert is_finalized_checkpoint(str(done)) and not is_finalized_checkpoint(str(in_flight))
    assert not is_finalized_checkpoint(str(tmp_path / "00001.pt"))  # not written at all
    assert list_checkpoints(str(tmp_path)) == [str(done)]
    assert latest_checkpoint(str(tmp_path)) == str(done)
    assert select_checkpoints(str(tmp_path), num_ckpts=3) == [str(done)]


def test_restore_waits_for_the_write(tmp_path, monkeypatch):
    import diffusesg_torch.utils.checkpoint as ckpt
    state, _, _ = _state_and_step()
    real = ckpt._write

    def slow(path, payload):
        time.sleep(0.5)
        real(path, payload)
    monkeypatch.setattr(ckpt, "_write", slow)
    path = ckpt.save_checkpoint(str(tmp_path / "00003"), state, {"epoch": 3},
                                asynchronous=True)
    assert not os.path.exists(path)  # still in flight
    other, _, _ = _state_and_step()
    assert ckpt.restore_checkpoint(path, other) == {"epoch": 3}
    assert ckpt.read_checkpoint(path)["extra"] == {"epoch": 3}


def _cli_args(exp_dir, *extra):
    return ["-c", os.path.join(REPO, SMALL_CFG), "--data_root", "/nonexistent", "--device",
            "cpu", "--subset", "4", "--batch_size", "4", "--save_interval", "1",
            "-o", f"exp_dir={exp_dir}", "-o", "train.sample_interval=1000", *extra]


def _failing_writes(monkeypatch):
    """Every write fails (in these runs every save is asynchronous)."""
    import diffusesg_torch.utils.checkpoint as ckpt

    def fail(path, payload):
        raise OSError(f"disk full writing {os.path.basename(path)}")
    monkeypatch.setattr(ckpt, "_write", fail)


def test_trainer_drain_fails_a_normal_run_on_a_failed_write(tmp_path, monkeypatch):
    from diffusesg_torch.cli import train as cli
    _failing_writes(monkeypatch)
    with pytest.raises(OSError, match="disk full"):
        cli.main(_cli_args(str(tmp_path), "--max_epoch", "1"))


def test_trainer_drain_keeps_the_original_error_during_an_unwind(tmp_path, monkeypatch):
    from diffusesg_torch.cli import train as cli
    from diffusesg_torch.train import trainer
    _failing_writes(monkeypatch)

    def boom(*args, **kw):
        raise RuntimeError("sampling failed")
    monkeypatch.setattr(trainer, "sg_go_sampling", boom)
    with pytest.raises(RuntimeError, match="sampling failed"):
        cli.main(_cli_args(str(tmp_path), "--max_epoch", "1", "-o",
                           "train.sample_interval=1"))
    # the run's log (cli.train sends the root logger there)
    root = os.path.join(str(tmp_path), "vg_small_test")
    with open(os.path.join(root, os.listdir(root)[0], "process_0.log")) as f:
        log = f.read()
    assert "asynchronous checkpoint write failed during unwind" in log
    assert "OSError: disk full writing 00000.pt" in log


def test_cli_train_with_async_saves_resumes_and_backs_up_the_code(tmp_path):
    """configs/vg_small_test.yaml sets tpu.async_checkpointing: true."""
    from diffusesg_torch.cli import train as cli
    from diffusesg_torch.config import load_config
    from diffusesg_torch.utils.checkpoint import list_checkpoints
    assert load_config(os.path.join(REPO, SMALL_CFG)).tpu.async_checkpointing is True
    state = cli.main(_cli_args(str(tmp_path), "--max_epoch", "2"))
    root = os.path.join(str(tmp_path), "vg_small_test")
    run = os.path.join(root, sorted(os.listdir(root))[-1])
    ckpts = list_checkpoints(os.path.join(run, "models_ckpt"))
    assert [os.path.basename(c) for c in ckpts] == ["00000.pt", "00001.pt"]
    assert os.path.exists(os.path.join(run, "models", "best.pt"))
    assert not [n for n in os.listdir(os.path.join(run, "models_ckpt")) if n.startswith(".tmp")]
    saved = torch.load(ckpts[-1], weights_only=False)
    assert saved["step"] == state.step == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(saved["params"][k], v), k

    resumed = cli.main(_cli_args(str(tmp_path / "again"), "--max_epoch", "3", "--resume", run))
    assert resumed.step == 3

    # backup_code: the package's sources and its CUDA sources, no byte code
    code = os.path.join(run, "code", "diffusesg_torch")
    assert os.path.isfile(os.path.join(code, "train", "trainer.py"))
    assert os.path.isfile(os.path.join(code, "csrc", "hopper_gemm.cuh"))
    assert os.path.isfile(os.path.join(code, "data", "native", "batcher.cc"))
    copied = [os.path.join(d, f) for d, dirs, files in os.walk(code) for f in files + dirs]
    assert not [p for p in copied if "__pycache__" in p or p.endswith((".pyc", ".so"))]


def test_trainer_drops_a_stale_preempt_checkpoint_behind_a_write_in_flight(tmp_path,
                                                                           monkeypatch):
    """A stale ``preempt.pt`` beside the run's first numeric checkpoint goes
    once that checkpoint is finalized, also when its write is still in
    flight at the check (the run's last epoch here)."""
    import diffusesg_torch.utils.checkpoint as ckpt
    from diffusesg_torch.cli import train as cli
    from diffusesg_torch.train import trainer
    real_write, real_save = ckpt._write, trainer.save_checkpoint

    def slow(path, payload):
        time.sleep(0.5)
        real_write(path, payload)

    def save(path, state, extra=None, asynchronous=False):
        out = real_save(path, state, extra, asynchronous)
        if os.path.basename(out) == "00000.pt":  # a file an earlier run left
            torch.save({"step": 0}, os.path.join(os.path.dirname(out), "preempt.pt"))
        return out
    monkeypatch.setattr(ckpt, "_write", slow)
    monkeypatch.setattr(trainer, "save_checkpoint", save)
    cli.main(_cli_args(str(tmp_path), "--max_epoch", "1"))
    root = os.path.join(str(tmp_path), "vg_small_test")
    run = os.path.join(root, os.listdir(root)[0])
    assert sorted(os.listdir(os.path.join(run, "models_ckpt"))) == ["00000.pt"]
