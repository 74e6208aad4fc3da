"""Reference-checkpoint import on the CPU (``utils/torch_import.py``,
``cli.import_ckpt``): a synthetic ``.pth`` in the reference's schema
(trainer_utils.py:168-185: the precond wrapper's state dict under the
prefix variants DDP / DP training leave, with the buffers the reference
saves, K EMA sets, the embedded config, epoch and losses) goes through the
port's importer and through the JAX package's ``import_reference_checkpoint``
followed by the port's ``flax_to_state_dict``; the weights and every EMA set
must be equal, and so must the betas and the epoch.  The imported run
directory then serves (``cli.serve --device cpu`` as a process, over HTTP),
evaluates (``cli.eval``) and resumes (``cli.train --resume``).
"""
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CFG = os.path.join(REPO, "configs", "vg_small_test.yaml")
EPOCH = 1
SHIFTS = {0.999: 0.02, 0.9: 0.01}  # out of order on purpose: EMAs sort by beta


def _tiny_config():
    """vg_small_test at N = 16, embed 24, depths (2, 2): the second block of
    the 16 x 16 stage is shifted, so the reference saves an ``attn_mask``."""
    from diffusesg_torch.config import load_config
    cfg = load_config(SMALL_CFG)
    with cfg.unlocked():
        cfg.dataset.max_node_num = 16
        cfg.model.feature_dims = [24]
        cfg.model.depths = [2, 2]
        cfg.mcmc.num_steps = 4
        cfg.test.batch_size = 4
    return cfg


def _seeded_model(cfg):
    from diffusesg_torch.models import make_model
    model = make_model(cfg)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return model


def reference_state_dict(model, prefix: str, shift: float = 0.0) -> dict:
    """The reference's state dict of this model: every parameter and buffer
    (``relative_position_index``, ``attn_mask``) under ``prefix``."""
    sd = {k: v + shift for k, v in model.state_dict().items()}
    sd.update(dict(model.named_buffers()))
    assert any(k.endswith("attn_mask") for k in sd) and any(
        k.endswith("relative_position_index") for k in sd)
    return {prefix + k: v.clone() for k, v in sd.items()}


def reference_ckpt(model, cfg, prefix: str) -> dict:
    ckpt = {"model": reference_state_dict(model, prefix), "config": cfg.to_dict(),
            "epoch": EPOCH, "train_loss": 0.5, "test_loss": 0.6}
    for beta, shift in SHIFTS.items():
        ckpt[f"model_ema_beta_{beta:.4f}"] = reference_state_dict(model, prefix, shift)
    return ckpt


@pytest.mark.parametrize("prefix", ["", "module.", "model.", "module.model."])
def test_import_matches_the_jax_importer(prefix):
    from diffusesg_tpu.utils.torch_import import config_from_ckpt as jconfig
    from diffusesg_tpu.utils.torch_import import import_reference_checkpoint as jimport
    from diffusesg_torch.utils.torch_import import config_from_ckpt, import_reference_checkpoint
    from diffusesg_torch.utils.weights import flax_to_state_dict
    model = _seeded_model(_tiny_config())
    ckpt = reference_ckpt(model, _tiny_config(), prefix)
    cfg = config_from_ckpt(ckpt)
    assert cfg.to_dict() == jconfig(ckpt).to_dict()

    state, extra = import_reference_checkpoint(ckpt, cfg)
    want = jimport(ckpt, jconfig(ckpt))
    to_sd = lambda tree: flax_to_state_dict(jax.tree.map(np.asarray, tree), 1)  # noqa: E731
    got = state.model.state_dict()
    ref = to_sd(want["params"])
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
        assert torch.equal(got[k], model.state_dict()[k]), k
    assert state.ema_betas == [0.9, 0.999]  # the JAX importer holds them in float32
    np.testing.assert_array_equal(np.float32(state.ema_betas), np.asarray(want["ema_betas"]))
    names = state.param_names()
    for i, ema in enumerate(state.ema_params):
        jema = to_sd(jax.tree.map(lambda x, i=i: np.asarray(x)[i], want["ema_params"]))
        for name, t in zip(names, ema):
            assert torch.equal(t, jema[name]), (i, name)
            assert torch.equal(t, model.state_dict()[name] + SHIFTS[state.ema_betas[i]]), name
    assert extra == dict(want["extra"]) == {"epoch": EPOCH, "imported_from_torch": 1,
                                            "train_loss": 0.5, "test_loss": 0.6}
    assert state.step == 0 and not state.opt.state


def test_a_mismatched_model_raises_naming_the_keys():
    from diffusesg_torch.utils.torch_import import config_from_ckpt, import_reference_checkpoint
    cfg = _tiny_config()
    ckpt = reference_ckpt(_seeded_model(cfg), cfg, "module.model.")
    bad_sd = dict(ckpt["model"], **{"module.model.extra.weight": torch.zeros(1)})
    del bad_sd["module.model.patch_embed.proj.bias"]
    bad = dict(ckpt, model=bad_sd)
    with pytest.raises(RuntimeError, match=r"(?s)Missing key.*Unexpected key.*extra\.weight"):
        import_reference_checkpoint(bad, config_from_ckpt(ckpt))
    other = config_from_ckpt(ckpt)
    with other.unlocked():
        other.model.feature_dims = [48]
    with pytest.raises(RuntimeError, match="size mismatch"):
        import_reference_checkpoint(ckpt, other)
    with pytest.raises(ValueError, match="DiffuseSG denoiser"):
        import_reference_checkpoint(dict(ckpt, model={"x.weight": torch.zeros(1)}),
                                    config_from_ckpt(ckpt))


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """(run dir, the model that went in) after ``cli.import_ckpt``."""
    from diffusesg_torch.cli import import_ckpt
    cfg = _tiny_config()
    model = _seeded_model(cfg)
    root = tmp_path_factory.mktemp("import")
    pth = str(root / "reference.pth")
    torch.save(reference_ckpt(model, cfg, "module.model."), pth)
    run = str(root / "run")
    path = import_ckpt.main([pth, "-o", run])
    assert path == os.path.join(os.path.abspath(run), "models_ckpt", f"{EPOCH:05d}.pt")
    return run, model


def test_imported_run_dir_holds_what_went_in(imported):
    from diffusesg_torch.config import load_config
    from diffusesg_torch.utils.checkpoint import latest_checkpoint, read_checkpoint
    run, model = imported
    payload = read_checkpoint(latest_checkpoint(os.path.join(run, "models_ckpt")))
    for k, v in model.state_dict().items():
        assert torch.equal(payload["params"][k], v), k
    names = [n for n, _ in model.named_parameters()]
    assert payload["ema_betas"] == [0.9, 0.999]
    for beta, ema in zip(payload["ema_betas"], payload["ema_params"]):
        for name, t in zip(names, ema):
            assert torch.equal(t, model.state_dict()[name] + SHIFTS[beta]), name
    assert payload["extra"]["epoch"] == EPOCH and payload["extra"]["imported_from_torch"] == 1
    assert load_config(os.path.join(run, "config.yaml")).dataset.max_node_num == 16


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url, payload=None, timeout=30):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def test_imported_run_dir_serves_over_http(imported):
    """``python -m diffusesg_torch.cli.serve -p <run> --device cpu``: a seeded
    request answers what the same loader's sampler gives in this process."""
    from diffusesg_torch.cli.serve import _load_from_checkpoint, build_serve_parser
    from diffusesg_torch.serving.server import BatchingSampler
    run, _ = imported
    port = _free_port()
    argv = ["-p", run, "--device", "cpu", "--port", str(port), "--batch_size", "2"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-m", "diffusesg_torch.cli.serve", *argv], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, proc.stdout.read()
            try:
                health = _get(base + "/healthz", timeout=2)
                break
            except OSError:
                assert time.time() < deadline, "cli.serve did not come up in 120 s"
                time.sleep(0.5)
        assert health == {"status": "ok", "batch_size": 2, "max_node_num": 16}
        got = _get(base + "/v1/generate", {"num_graphs": 2, "num_nodes": [16, 3], "seed": 5})
    finally:
        proc.terminate()
        proc.wait(30)
    fn, *_ = _load_from_checkpoint(build_serve_parser().parse_args(argv))
    batcher = BatchingSampler(fn, 2, 16)
    try:
        assert got["graphs"] == batcher.generate(2, [16, 3], seed=5)
    finally:
        batcher.close()
    assert len(got["graphs"][1]["nodes"]) == 3


def test_imported_run_dir_evaluates_and_resumes(imported, tmp_path, monkeypatch):
    import diffusesg_torch.eval.sg_statistics as tstat
    import diffusesg_torch.utils.visual as tvis
    from diffusesg_torch.cli import eval as eval_cli
    from diffusesg_torch.cli import train as train_cli
    run, model = imported
    monkeypatch.setattr(tstat, "_plot_report", lambda *a, **k: None)
    for name in ("plot_graphs_adj", "plot_scene_graph", "plot_scene_graph_bbox"):
        monkeypatch.setattr(tvis, name, lambda *a, **k: None)
    (metrics,) = eval_cli.main(["-p", run, "--device", "cpu", "--eval_size", "8",
                                "--num_steps", "2", "--data_root", "/nonexistent",
                                "--use_ema", "0.999", "-o", f"exp_dir={tmp_path / 'eval'}"])
    keys = [k for k in metrics if not k.startswith("_")]
    assert keys and all(np.isfinite(metrics[k]) for k in keys)

    state = train_cli.main(["-c", os.path.join(run, "config.yaml"), "--data_root",
                            "/nonexistent", "--device", "cpu", "--subset", "8", "--batch_size",
                            "4", "--max_epoch", str(EPOCH + 2), "--resume", run,
                            "-o", f"exp_dir={tmp_path / 'train'}"])
    assert state.step == 2  # the imported step 0, then epoch EPOCH + 1's two steps
    assert state.ema_betas == [0.9, 0.999]
    moved = [not torch.equal(p, model.state_dict()[n]) for n, p in state.model.named_parameters()]
    assert any(moved)
