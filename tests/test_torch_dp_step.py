"""The two data-parallel steps across two gloo processes, against the JAX
package, over two steps with stochastic self-conditioning on.

fp32, the tiny config of __graft_entry__.py:18-27 (N = 16, embed 48, depths
(1, 1)).  The shards hold different numbers of valid nodes, so the IoU
divisor differs between a shard and the global batch: under ``shard_map`` a
global batch of 4 graphs with 16, 11, 5 and 2 nodes (rank 0 the first two),
under ``gspmd`` one of 2 graphs with 16 and 5.  The ranks run
tests/helpers/torch_dp_child.py while this process computes the JAX side:
  * ``shard_map``: JAX's host emulation of its shard_map step
    (tests/test_shardmap_dp.py:28-35): shard i takes ``fold_in(key, i)``,
    the gradients of the two shards are averaged before clip and Adam.  The
    keys are chosen so that the ranks' self-conditioning coins differ on
    both steps: one rank runs the conditioning pass while the other does not.
  * ``gspmd`` + ZeRO-1: JAX's single-device step on the global batch.
The bars are tests/test_torch_train_step.py's: loss rtol 2e-4, gradients rtol
5e-3 + 5e-3 * max|leaf|, parameters and EMAs within 1e-4 |w| + 0.05 lr where
Adam's update has a stable sign, within 2.5 lr per step elsewhere.  The
learning rate halves between the two steps (one step an epoch).
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from test_torch_train_step import _UNSTABLE_FRAC, _assert_weights_close  # noqa: E402
from torch_parity import (SMALL_CFG, JaxTrainNoise, clean_batch, start_ranks,  # noqa: E402
                          tiny_overrides, tiny_port_model, wait_ranks)
from torch_dp_child import BETAS, COUNTS, DECAY, LR, SPE, STEPS, WD, step_keys  # noqa: E402


def _flax(named):
    from diffusesg_torch.utils.weights import state_dict_to_flax
    return state_dict_to_flax({k: torch.from_numpy(np.asarray(v)) for k, v in named.items()})


def _jax_reference():
    """{mode: [per step: loss, loss_adj, loss_node, clipped grads, params, emas]}."""
    from diffusesg_tpu.config import load_config as jload
    from diffusesg_tpu.models import build_model as jbuild
    from diffusesg_tpu.train import train_state as jts
    from diffusesg_tpu.train import train_step as jstep
    from diffusesg_torch.config import load_config as tload
    from diffusesg_torch.utils.weights import state_dict_to_flax

    jcfg, tcfg = tiny_overrides(jload(SMALL_CFG)), tiny_overrides(tload(SMALL_CFG))
    jm = jbuild(jcfg)
    params = jax.tree.map(jnp.asarray, state_dict_to_flax(tiny_port_model(tcfg).state_dict()))
    opt = jts.make_optimizer(LR, DECAY, SPE, WD)
    grad_fn = jax.jit(jax.value_and_grad(
        jstep.make_loss_fn(jm.apply, jstep.train_step_config_from(jcfg)), has_aux=True))

    @jax.jit
    def apply(state, grads):
        """The update half of the JAX step (train_step.py:137-143)."""
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        new = jax.tree.map(lambda p, u: p + u, state.params, updates)
        emas = jts.update_emas(state.ema_params, new, state.ema_betas, step=state.step)
        return jts.TrainState(step=state.step + 1, params=new, opt_state=opt_state,
                              ema_params=emas, ema_betas=state.ema_betas)

    # host arithmetic in numpy: every eager jnp op of a new shape compiles
    def host(tree):
        return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)

    keys = step_keys()
    init = jax.jit(lambda p: jts.create_train_state(p, BETAS, opt))
    out = {}
    for mode in ("shard_map", "gspmd"):
        counts = COUNTS[mode]
        batch = clean_batch(len(counts), tcfg.dataset.max_node_num, counts, seed=9)
        state = init(params)
        steps = []
        for i, key in enumerate(keys):
            if mode == "gspmd":
                parts = [grad_fn(state.params, key, *batch)]
            else:
                b = len(counts) // 2
                parts = [grad_fn(state.params, jax.random.fold_in(key, r),
                                 *(a[r * b:(r + 1) * b] for a in batch)) for r in range(2)]
            grads = jax.tree.map(lambda *g: sum(g) / len(g), *(host(g) for _, g in parts))
            loss, la, lx = (np.mean([float(f(l, a)) for (l, a), _ in parts]) for f in (
                lambda l, a: l, lambda l, a: np.mean(a["loss_adj"]),
                lambda l, a: np.mean(a["loss_node"])))
            norm = np.sqrt(sum(np.sum(g ** 2) for g in jax.tree.leaves(grads)))
            before = host(state.params)
            state = apply(state, jax.tree.map(lambda g: g.astype(np.float32), grads))
            emas = host(state.ema_params)
            steps.append(dict(loss=loss, loss_adj=la, loss_node=lx, before=before,
                              grads=jax.tree.map(lambda g: g * min(1.0, 10.0 / norm), grads),
                              params=host(state.params),
                              emas=[jax.tree.map(lambda e: e[k], emas) for k in range(len(BETAS))]))
        out[mode] = steps
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_steps")
    ranks = start_ranks(["steps", str(out)], str(out / "logs"))
    try:
        ref = _jax_reference()
    finally:
        wait_ranks(ranks)
    got = {(m, r): dict(np.load(out / f"{m}_rank{r}.npz"))
           for m in ("shard_map", "gspmd") for r in (0, 1)}
    return out, ref, got


def _named(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _check_against_jax(ref_steps, got):
    unstable = None
    for i, want in enumerate(ref_steps):
        for k in ("loss", "loss_adj", "loss_node"):
            np.testing.assert_allclose(float(got[f"step{i}/{k}"]), want[k], rtol=2e-4,
                                       err_msg=f"step {i} {k}")
        gtree = _flax(_named(got, f"step{i}/grad/"))
        for (path, w), (_, g) in zip(_leaves(want["grads"]), _leaves(gtree)):
            w, g = np.asarray(w), np.asarray(g)
            np.testing.assert_allclose(g, w, rtol=5e-3, atol=5e-3 * (np.abs(w).max() + 1e-12),
                                       err_msg=f"step {i} grad {jax.tree_util.keystr(path)}")
        eff = [np.asarray(g) + WD * np.asarray(p) for (_, g), (_, p) in
               zip(_leaves(want["grads"]), _leaves(want["before"]))]
        masks = [np.abs(e) <= _UNSTABLE_FRAC * (np.abs(e).max() + 1e-12) for e in eff]
        unstable = masks if unstable is None else [a | b for a, b in zip(unstable, masks)]
        _assert_weights_close(_flax(_named(got, f"step{i}/param/")), want["params"], unstable,
                              i + 1, LR, f"step {i} params")
        for k in range(len(BETAS)):
            _assert_weights_close(_flax(_named(got, f"step{i}/ema{k}/")), want["emas"][k],
                                  unstable, i + 1, LR, f"step {i} ema[{k}]")


def test_shard_map_step_matches_jax_emulation(run):
    _, ref, got = run
    _check_against_jax(ref["shard_map"], got[("shard_map", 0)])


def test_shard_map_draws_a_coin_per_rank(run):
    """The ranks' self-conditioning coins are JAX's folded ones and differ
    on both steps, yet both ranks reduced a gradient for every parameter."""
    _, _, got = run
    keys = step_keys()
    for r in (0, 1):
        want = [JaxTrainNoise(keys).fold_in(r).bernoulli(i, "self_cond", 0.5) for i in range(STEPS)]
        assert list(got[("shard_map", r)]["self_cond_coins"]) == want
    assert all(got[("shard_map", 0)]["self_cond_coins"] != got[("shard_map", 1)]["self_cond_coins"])


@pytest.mark.parametrize("mode", ["shard_map", "gspmd"])
def test_ranks_end_with_the_same_state(run, mode):
    """Parameters, EMAs and the reduced metrics are bit-equal on both ranks;
    the per-sample vectors are each rank's own."""
    _, _, got = run
    a, b = got[(mode, 0)], got[(mode, 1)]
    for k in a:
        if "/param/" in k or "/ema" in k or k.endswith(("/loss", "/loss_adj", "/loss_node")):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not np.array_equal(a[f"step{STEPS - 1}/loss_adj_per_sample"],
                              b[f"step{STEPS - 1}/loss_adj_per_sample"])


def test_gspmd_step_matches_jax_global_batch(run):
    _, ref, got = run
    _check_against_jax(ref["gspmd"], got[("gspmd", 0)])


def test_gspmd_ranks_hold_a_share_of_adam_and_the_emas(run):
    """ZeRO-1: each rank holds about half of the Adam moments and of the EMA
    bytes (its contiguous range of the flat buffers, the padding not
    counted), together all of them; ``shard_map`` holds all on each rank."""
    _, _, got = run
    params = int(got[("gspmd", 0)]["param_bytes"])
    for key, per_param in (("adam_bytes", 2), ("ema_bytes", len(BETAS))):
        held = [int(got[("gspmd", r)][key]) for r in (0, 1)]
        assert sum(held) == per_param * params, (key, held)
        assert all(0.4 < h / (per_param * params) < 0.6 for h in held), (key, held)
        assert int(got[("shard_map", 0)][key]) == per_param * params


@pytest.mark.parametrize("mode", ["shard_map", "gspmd"])
def test_data_parallel_checkpoint_restores_in_one_process(run, mode):
    """Rank 0's checkpoint (the ZeRO-1 state gathered to it) restores into a
    single-device state, bit-equal to what the ranks held after the steps."""
    from diffusesg_torch.config import load_config
    from diffusesg_torch.train import create_train_state, ema_slice, make_optimizer
    from diffusesg_torch.utils.checkpoint import restore_checkpoint

    out, _, got = run
    cfg = tiny_overrides(load_config(SMALL_CFG))
    state = create_train_state(tiny_port_model(cfg, seed=3), BETAS,
                               make_optimizer(LR, DECAY, SPE, WD))
    assert restore_checkpoint(str(out / f"{mode}_ckpt.pt"), state) == {"epoch": 0}
    assert state.step == STEPS and state.zero is None
    last = got[(mode, 0)]
    for n, p in state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), last[f"step{STEPS - 1}/param/{n}"])
        moments = state.opt.state[p]
        assert int(moments["step"]) == STEPS and moments["exp_avg"].abs().max() > 0
    for k in range(len(BETAS)):
        for n, t in ema_slice(state, k).items():
            np.testing.assert_array_equal(t.numpy(), last[f"step{STEPS - 1}/ema{k}/{n}"])
