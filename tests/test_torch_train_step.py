"""The training step as a whole on the CPU: three steps of ``make_train_step``
in the port and in the JAX package from the same flax parameters (carried
across with ``utils/weights.py``) and the JAX key schedule's own draws, with
stochastic self-conditioning on and off.

fp32, N = 16, embed 24, depths (2, 2), window 8.  The bars are those of
tests/test_train_parity.py: loss rtol 2e-4; gradients leaf by leaf rtol 5e-3
+ 5e-3 * max|leaf|; parameters and both EMAs after each step within 1e-4 *
|w| + 0.05 * lr on the elements whose Adam update has a stable sign, and
within 2.5 * lr per step on the rest.  The learning rate halves at the epoch
boundary between steps 2 and 3.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_parity import JaxTrainNoise, clean_batch, load_pair, model_pair  # noqa: E402

COUNTS = [16, 11, 5, 2]
LR = 2e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _step_keys(n, seed=0):
    return [jax.random.fold_in(jax.random.PRNGKey(seed), i) for i in range(n)]


_UNSTABLE_FRAC = 4e-3  # |g| <= frac * max|g_leaf|: Adam's g / (|g| + eps) may flip sign


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_grads_close(got_tree, want_tree, what):
    for (path, want), (_, got) in zip(_leaves(want_tree), _leaves(got_tree)):
        want, got = np.asarray(want), np.asarray(got)
        np.testing.assert_allclose(
            got, want, rtol=5e-3, atol=5e-3 * (np.abs(want).max() + 1e-12),
            err_msg=f"{what} at {jax.tree_util.keystr(path)}")


def _assert_weights_close(got_tree, want_tree, unstable, steps_done, lr, what):
    for (path, want), (_, got), mask in zip(_leaves(want_tree), _leaves(got_tree), unstable):
        want, got = np.asarray(want), np.asarray(got)
        diff = np.abs(got - want)
        bad = (~mask) & (diff > 1e-4 * np.abs(want) + 0.05 * lr)
        assert not bad.any(), (f"{what} at {jax.tree_util.keystr(path)}: {bad.sum()} stable "
                               f"elements off by up to {diff[bad].max():.3e}")
        assert diff[mask].max(initial=0.0) <= 2.5 * lr * steps_done, (
            f"{what} at {jax.tree_util.keystr(path)}: unstable-element drift")


@pytest.mark.parametrize("self_cond", [True, False])
def test_three_training_steps_match_jax(self_cond):
    from diffusesg_tpu.train import train_state as jts
    from diffusesg_tpu.train import train_step as jstep
    from diffusesg_torch.train import (create_train_state, ema_slice, make_loss_fn,
                                       make_optimizer, make_train_step, train_step_config_from)
    from diffusesg_torch.utils.weights import state_dict_to_flax

    jcfg, tcfg = load_pair()
    for cfg in (jcfg, tcfg):
        with cfg.unlocked():
            cfg.train.self_cond = self_cond
    jm, params, tm = model_pair(jcfg, tcfg)
    params = jax.tree.map(jnp.asarray, params)
    betas, decay, wd, spe = [0.9, 0.999], 0.5, 1e-2, 2
    adjs, nodes, flags = clean_batch(4, 16, COUNTS, seed=9)

    jopt = jts.make_optimizer(LR, decay, spe, wd)
    jstate = jts.create_train_state(params, betas, jopt)
    jcfg_step = jstep.train_step_config_from(jcfg)
    jloss = jstep.make_loss_fn(jm.apply, jcfg_step)
    jtrain = jstep.make_train_step(jm.apply, jopt, jcfg_step)

    @jax.jit  # one compile; op-by-op dispatch of the un-jitted step takes far longer
    def jboth(state, key, *batch):
        out = jax.value_and_grad(jloss, has_aux=True)(state.params, key, *batch)
        return out, jtrain(state, key, *batch)

    tcfg_step = train_step_config_from(tcfg)
    assert tcfg_step == type(tcfg_step)(**{f: getattr(jcfg_step, f) for f in
                                           tcfg_step.__dataclass_fields__})
    tstate = create_train_state(tm, betas, make_optimizer(LR, decay, spe, wd))
    tloss = make_loss_fn(tm, tcfg_step)
    ttrain = make_train_step(tm, tcfg_step)

    keys = _step_keys(3, seed=1)
    noise = JaxTrainNoise(keys)
    if self_cond:  # the three steps take both branches of the Bernoulli draw
        assert len({noise.bernoulli(i, "self_cond", 0.5) for i in range(3)}) == 2
    jb = tuple(jnp.asarray(a) for a in (adjs, nodes, flags))
    tb = tuple(_t(a) for a in (adjs, nodes, flags))
    names = tstate.param_names()
    unstable = None
    for i, key in enumerate(keys):
        jparams_before = jstate.params
        ((jl, jaux), jgrads), (jstate, jmetrics) = jboth(jstate, key, *jb)

        loss, aux = tloss(None, noise, tstate.step, *tb)
        grads = torch.autograd.grad(loss, tstate.params())
        lr_used = tstate.spec.lr(tstate.step)
        tstate, metrics = ttrain(tstate, noise, *tb)

        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-4, err_msg=f"step {i} loss")
        np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=2e-4)
        for k in ("loss_adj", "loss_node", "sigmas"):
            np.testing.assert_allclose(aux[k].detach().numpy(), np.asarray(jaux[k]), rtol=2e-4,
                                       atol=1e-6, err_msg=f"step {i} {k}")
        gtree = state_dict_to_flax(dict(zip(names, grads)))
        _assert_grads_close(gtree, jgrads, f"step {i} grad")

        # Adam divides the clipped gradient plus the coupled decay term by its
        # own magnitude: where that sum is near zero the update's sign is noise
        norm = float(np.sqrt(sum(float(jnp.sum(g ** 2)) for _, g in _leaves(jgrads))))
        eff = [np.asarray(g) * min(1.0, 10.0 / norm) + wd * np.asarray(p)
               for (_, g), (_, p) in zip(_leaves(jgrads), _leaves(jparams_before))]
        masks = [np.abs(e) <= _UNSTABLE_FRAC * (np.abs(e).max() + 1e-12) for e in eff]
        unstable = masks if unstable is None else [a | b for a, b in zip(unstable, masks)]
        assert lr_used == LR * (decay if i >= spe else 1.0)  # the epoch boundary
        assert tstate.opt.param_groups[0]["lr"] == lr_used and tstate.step == i + 1
        ptree = state_dict_to_flax(dict(zip(names, tstate.params())))
        _assert_weights_close(ptree, jstate.params, unstable, i + 1, LR, f"step {i} params")
        for k in range(len(betas)):
            etree = state_dict_to_flax(ema_slice(tstate, k))
            _assert_weights_close(etree, jts.ema_slice(jstate.ema_params, k), unstable, i + 1,
                                  LR, f"step {i} ema[{k}]")
    # warm-up ramp: after 3 updates EMA k is p2 + d3 * (p3 ... ) -- not a copy any more
    assert not torch.equal(tstate.ema_params[0][0], tstate.params()[0])
