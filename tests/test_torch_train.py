"""The training slice's pieces on the CPU: the port's objective, losses,
stochastic self-conditioning, EMA ramp, data pipeline, checkpoints, trainer
and CLI vs the JAX package, on shared weights and the JAX key schedule's own
random draws (the whole training step is in tests/test_torch_train_step.py).

fp32, small sizes (N = 16, embed 24, depths (2, 2), window 8).  Tolerances
are stated at each test.
"""
import os
import signal
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_parity import (JaxTrainNoise, SMALL_CFG, clean_batch, load_pair,  # noqa: E402
                          model_pair)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTS = [16, 11, 5, 2]
LR = 2e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _step_keys(n, seed=0):
    return [jax.random.fold_in(jax.random.PRNGKey(seed), i) for i in range(n)]


# ------------------------------------------------------------ (e) the pieces

@pytest.mark.parametrize("sigma_dist,precond", [("edm", "edm"), ("vp", "vp"), ("ve", "ve")])
def test_objective_matches_jax_under_its_own_draws(sigma_dist, precond):
    """Same key schedule -> same sigmas, weights, coefficients and noisy
    inputs; fp32 elementwise math, rtol 1e-5 + atol 1e-6."""
    from diffusesg_tpu.diffusion.edm import NodeAdjEDMObjective as JObj
    from diffusesg_torch.diffusion.edm import NodeAdjEDMObjective as TObj
    adjs, nodes, flags = clean_batch(4, 16, COUNTS, seed=1)
    key = _step_keys(1, seed=3)[0]
    rng_obj, _ = jax.random.split(key)
    want = JObj(precond, sigma_dist, False).get_input_output(
        rng_obj, jnp.asarray(adjs), jnp.asarray(nodes), jnp.asarray(flags))
    noise = JaxTrainNoise([key])
    got = TObj(precond, sigma_dist, False).get_input_output(noise, 0, _t(adjs), _t(nodes),
                                                            _t(flags))
    assert {k for _, k in noise.requests} == {"sigma", "noise_adj", "noise_node"}
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("iou_loss_type", ["iou", "giou", "giou_squared", "diou", "ciou"])
def test_losses_and_their_gradients_match_jax(iou_loss_type):
    """Rainbow + IoU aux loss values and d(loss)/d(prediction); rtol 1e-4 +
    atol 1e-6 (fp32, sums over at most 16 x 16 entries)."""
    from diffusesg_tpu.train.loss import NodeAdjRainbowLoss as JLoss
    from diffusesg_tpu.train.loss import bbox_iou_aux_loss as jiou
    from diffusesg_torch.train.loss import NodeAdjRainbowLoss as TLoss
    from diffusesg_torch.train.loss import bbox_iou_aux_loss as tiou
    adjs, nodes, flags = clean_batch(4, 16, COUNTS, seed=2)
    pa, px, _ = clean_batch(4, 16, COUNTS, seed=3)
    w = np.random.default_rng(4).uniform(0.5, 3.0, 4).astype(np.float32)

    def jtotal(pa_, px_):
        la, lx = JLoss(1.5, 0.7)(pa_, px_, jnp.asarray(adjs), jnp.asarray(nodes),
                                 jnp.asarray(flags), jnp.asarray(w))
        lx = lx + 0.5 * jiou(px_, jnp.asarray(nodes), jnp.asarray(flags), jnp.asarray(w),
                             iou_loss_type)
        return la.mean() + lx.mean(), (la, lx)

    (jl, (jla, jlx)), jg = jax.value_and_grad(jtotal, argnums=(0, 1), has_aux=True)(
        jnp.asarray(pa), jnp.asarray(px))
    tpa, tpx = _t(pa).requires_grad_(), _t(px).requires_grad_()
    la, lx = TLoss(1.5, 0.7)(tpa, tpx, _t(adjs), _t(nodes), _t(flags), _t(w))
    lx = lx + 0.5 * tiou(tpx, _t(nodes), _t(flags), _t(w), iou_loss_type)
    total = la.mean() + lx.mean()
    ga, gx = torch.autograd.grad(total, (tpa, tpx))
    tol = dict(rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(la.detach().numpy(), np.asarray(jla), **tol)
    np.testing.assert_allclose(lx.detach().numpy(), np.asarray(jlx), **tol)
    np.testing.assert_allclose(float(total.detach()), float(jl), rtol=1e-4)
    np.testing.assert_allclose(ga.numpy(), np.asarray(jg[0]), **tol)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jg[1]), **tol)


def _key_with_branch(want_sc: bool):
    for i in range(64):
        key = jax.random.PRNGKey(100 + i)
        if bool(jax.random.bernoulli(jax.random.split(key)[1], 0.5)) == want_sc:
            return key
    raise AssertionError("no key found")


@pytest.mark.parametrize("with_self_cond_pass", [True, False])
def test_precond_forward_train_matches_jax_in_both_branches(with_self_cond_pass):
    """Values at atol 2e-4 / rtol 1e-3 (the forward's fp32 bar); the
    conditioning pass must leave no graph behind."""
    from diffusesg_tpu.models.precond import precond_forward_train as jfwd
    from diffusesg_torch.models.precond import precond_forward_train as tfwd
    jcfg, tcfg = load_pair()
    jm, params, tm = model_pair(jcfg, tcfg)
    adjs, nodes, flags = clean_batch(4, 16, COUNTS, seed=5)
    sig = np.array([0.2, 0.8, 2.0, 9.0], np.float32)
    key = _key_with_branch(with_self_cond_pass)
    want = jfwd(lambda *a: jm.apply(params, *a), "edm", True, jax.random.split(key)[1],
                jnp.asarray(adjs), jnp.asarray(nodes), jnp.asarray(flags), jnp.asarray(sig))
    noise = JaxTrainNoise([key])
    calls = []

    def denoiser(*a):
        calls.append(torch.is_grad_enabled())
        return tm(*a)
    got = tfwd(denoiser, "edm", True, noise, 0, _t(adjs), _t(nodes), _t(flags), _t(sig))
    assert calls == ([False, True] if with_self_cond_pass else [True])
    assert noise.requests == [(0, "self_cond")]
    for a, b in zip(got, want):
        assert a.requires_grad
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=2e-4, rtol=1e-3)


def test_ema_ramp_and_schedule_match_jax():
    from diffusesg_tpu.train.train_state import ema_effective_decay as jdecay
    from diffusesg_torch.train.train_state import ema_effective_decay, make_optimizer
    betas = [0.9, 0.95, 0.99, 0.999, 0.9999]
    for step in (0, 1, 2, 3, 9, 10, 99, 10_000, 1_000_000):
        want = np.asarray(jdecay(jnp.asarray(betas, jnp.float32), jnp.asarray(step)))
        got = [ema_effective_decay(b, step) for b in betas]
        np.testing.assert_allclose(got, want, rtol=1e-6)
    spec = make_optimizer(2e-4, 0.5, steps_per_epoch=3)
    assert [spec.lr(c) for c in (0, 2, 3, 5, 6)] == [2e-4, 2e-4, 1e-4, 1e-4, 5e-5]


# ------------------------------------------------------------ weights, data


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_state_dict_to_flax_inverts_flax_to_state_dict():
    from diffusesg_torch.utils.weights import flax_to_state_dict, state_dict_to_flax
    jcfg, tcfg = load_pair()
    _, params, tm = model_pair(jcfg, tcfg)
    back = state_dict_to_flax(tm.state_dict())
    want = params if "params" in params else {"params": params}
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for (path, a), (_, b) in zip(_leaves(back), _leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=jax.tree_util.keystr(path))
    again = flax_to_state_dict(back)
    assert all(torch.equal(again[k], v) for k, v in tm.state_dict().items())


# ------------------------------------------------------------- data pipeline

def test_synthetic_dataset_and_batches_match_jax():
    from diffusesg_tpu.data import load_data as jload
    from diffusesg_tpu.data.loader import Batches as JBatches
    from diffusesg_torch.data import Batches, load_data, pad_batch, prefetch_to_device
    jcfg, tcfg = load_pair()
    for cfg in (jcfg, tcfg):
        with cfg.unlocked():
            cfg.dataset.subset = None
            cfg.dataset.synthetic_num_train = 22
            cfg.dataset.synthetic_num_test = 6
    jb, tb = jload(jcfg, data_root="/nonexistent"), load_data(tcfg, data_root="/nonexistent")
    for split in ("train", "test"):
        for field in ("adjs", "nodes", "node_flags", "image_ids"):
            a, b = getattr(getattr(tb, split), field), getattr(getattr(jb, split), field)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f"{split}.{field}")
    assert tb.train_triplet_dict == jb.train_triplet_dict
    for kw in (dict(), dict(process_index=1, process_count=2), dict(drop_remainder=True)):
        ours, theirs = Batches(tb.train, 8, seed=3, **kw), JBatches(jb.train, 8, seed=3,
                                                                    native=False, **kw)
        ours.set_epoch(2), theirs.set_epoch(2)
        assert len(ours) == len(theirs)
        for x, y in zip(ours, theirs):
            assert all(np.array_equal(p, q) for p, q in zip(x, y))
    small = Batches(tb.test, 12)  # 6 graphs tile to one batch of 12
    assert len(small) == 1 and next(iter(small))[0].shape[0] == 12
    last = list(Batches(tb.train, 8, shuffle=False))[-1]
    padded, n_real = pad_batch(last[:3], 8)
    assert n_real == 6 and all(a.shape[0] == 8 for a in padded)
    np.testing.assert_array_equal(padded[0][6:], last[0][:2])
    got = list(prefetch_to_device(Batches(tb.train, 8, shuffle=False), "cpu",
                                  transform=lambda item: pad_batch(item[:3], 8)[0]))
    assert len(got) == 3 and all(t.shape[0] == 8 for batch in got for t in batch)


# ------------------------------------------- (g) trainer, checkpoints, the CLI

def _cli_args(exp_dir, *extra):
    return ["-c", os.path.join(REPO, SMALL_CFG), "--data_root", "/nonexistent", "--device",
            "cpu", "--subset", "8", "--batch_size", "4", "--save_interval", "1",
            "-o", f"exp_dir={exp_dir}", *extra]


def _run_dir(exp_dir):
    root = os.path.join(exp_dir, "vg_small_test")
    runs = sorted(os.path.join(root, d) for d in os.listdir(root))
    return runs[-1]


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    from diffusesg_torch.cli import train as cli
    from diffusesg_torch.utils.checkpoint import latest_checkpoint, list_checkpoints
    state = cli.main(_cli_args(str(tmp_path), "--max_epoch", "2"))
    assert state.step == 4  # 8 graphs / batch 4, 2 epochs
    run = _run_dir(str(tmp_path))
    ckpts = list_checkpoints(os.path.join(run, "models_ckpt"))
    assert [os.path.basename(c) for c in ckpts] == ["00000.pt", "00001.pt"]
    assert latest_checkpoint(os.path.join(run, "models_ckpt")) == ckpts[-1]
    for name in ("config.yaml", "train_loss.log", "test_loss.log", "scalars.jsonl",
                 os.path.join("models", "best.pt")):
        assert os.path.exists(os.path.join(run, name)), name
    with open(os.path.join(run, "train_loss.log")) as f:
        rows = [line.split("\t") for line in f]
    assert len(rows) == 16 and all(np.isfinite(float(v)) for r in rows for v in r[1:])

    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    resumed = cli.main(_cli_args(str(tmp_path / "second"), "--max_epoch", "3", "--resume", run))
    assert resumed.step == 6  # restored 4 updates, ran epoch 2 only
    assert any(not torch.equal(before[k], v) for k, v in resumed.model.state_dict().items())


def test_checkpoint_round_trip_restores_bit_equal_state(tmp_path):
    from diffusesg_torch.models import build_model
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train import (create_train_state, make_optimizer, make_train_step,
                                       train_step_config_from)
    from diffusesg_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
    _, tcfg = load_pair()
    step_cfg = train_step_config_from(tcfg)
    adjs, nodes, flags = (_t(a) for a in clean_batch(4, 16, COUNTS, seed=4))

    def fresh(seed):
        model = build_model(tcfg, device="cpu", seed=seed)
        return create_train_state(model, [0.9, 0.999], make_optimizer(LR, 1.0, 1, 1e-2))

    state = fresh(0)
    step = make_train_step(state.model, step_cfg)
    noise = TorchNoise(0, "cpu")
    for _ in range(2):
        step(state, noise, adjs, nodes, flags)
    path = save_checkpoint(str(tmp_path / "ck"), state, extra={"epoch": 7})
    assert path.endswith("ck.pt") and os.listdir(tmp_path) == ["ck.pt"]  # no temp file left

    other = fresh(1)
    extra = restore_checkpoint(path, other)
    assert extra == {"epoch": 7} and other.step == 2 and other.ema_betas == state.ema_betas
    for a, b in zip(other.params(), state.params()):
        assert torch.equal(a, b)
    for ea, eb in zip(other.ema_params, state.ema_params):
        assert all(torch.equal(a, b) for a, b in zip(ea, eb))
    sa, sb = other.opt.state_dict()["state"], state.opt.state_dict()["state"]
    assert sa.keys() == sb.keys() and len(sa) == len(state.params())
    for k in sa:
        assert all(torch.equal(torch.as_tensor(sa[k][f]), torch.as_tensor(sb[k][f]))
                   for f in ("step", "exp_avg", "exp_avg_sq"))
    # and the restored state takes the same next step, bit for bit
    step(state, TorchNoise(5, "cpu"), adjs, nodes, flags)
    make_train_step(other.model, step_cfg)(other, TorchNoise(5, "cpu"), adjs, nodes, flags)
    assert all(torch.equal(a, b) for a, b in zip(other.params(), state.params()))


def test_preempt_signal_checkpoints_and_resume_continues(tmp_path):
    from diffusesg_torch.cli import train as cli
    from diffusesg_torch.train import train_step as ts
    from diffusesg_torch.utils.checkpoint import latest_checkpoint

    real = ts.make_train_step
    seen = {"n": 0}

    def flaky(model, cfg):
        inner = real(model, cfg)

        def step(state, noise, *batch):
            seen["n"] += 1
            if seen["n"] == 3:  # the first step of epoch 1
                signal.raise_signal(signal.SIGTERM)
            return inner(state, noise, *batch)
        return step

    from diffusesg_torch.train import trainer  # go_training builds its steps there
    old_handler = signal.getsignal(signal.SIGTERM)
    trainer.make_train_step = flaky
    try:
        state = cli.main(_cli_args(str(tmp_path), "--max_epoch", "4"))
    finally:
        trainer.make_train_step = real
    assert signal.getsignal(signal.SIGTERM) == old_handler  # handlers restored
    assert state.step == 3  # stopped after the step in flight
    run = _run_dir(str(tmp_path))
    newest = latest_checkpoint(os.path.join(run, "models_ckpt"))
    assert os.path.basename(newest) == "preempt.pt"
    extra = torch.load(newest, weights_only=False)["extra"]
    assert extra == {"epoch": 0, "preempted": True}  # epoch 1 was cut: re-run it

    resumed = cli.main(_cli_args(str(tmp_path / "again"), "--max_epoch", "2", "--resume", run))
    assert resumed.step == 5  # 3 restored + the two steps of epoch 1


def test_train_cli_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from diffusesg_torch.cli import train as cli
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-c", os.path.join(REPO, SMALL_CFG), "--data_root", "/nonexistent"])
