"""Tensor parallelism's rules on the CPU, in one process: the port's rule
table (``parallel.tp.tp_axis``) against the JAX package's ``_tp_axis`` on
the tiny model's flax tree (carried through ``utils.weights``), the split
of the tiny model by heads (its stages have 3 and 6 heads), the warning
that names the leaves that stay replicated, and the refusal of a model
whose kernels are on.  The collectives run in tests/test_torch_tp_step.py.
"""
import logging
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_parity import SMALL_CFG, tiny_overrides, tiny_port_model  # noqa: E402


def _tiny_model():
    from diffusesg_torch.config import load_config
    return tiny_port_model(tiny_overrides(load_config(SMALL_CFG)))


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_rule_table_marks_the_leaves_jax_marks_on_the_same_axis():
    """Each port leaf is marked along its split axis (1, 2, ... along it,
    zeros when replicated) and carried to the flax tree: JAX's rule must
    name the same leaves, on the axis the marks run along."""
    from diffusesg_tpu.parallel.tp import _tp_axis
    from diffusesg_torch.parallel.tp import tp_axis
    from diffusesg_torch.utils.weights import state_dict_to_flax
    sd = _tiny_model().state_dict()
    marked = {}
    for name, t in sd.items():
        ax = tp_axis(name, t.ndim)
        m = torch.zeros_like(t)
        if ax is not None:
            shape = [1] * t.ndim
            shape[ax] = t.shape[ax]
            m += torch.arange(1, t.shape[ax] + 1, dtype=t.dtype).reshape(shape)
        marked[name] = m
    split = 0
    for path, leaf in _leaves(state_dict_to_flax(marked)):
        ax = _tp_axis(path[-1], leaf.ndim)
        if ax is None:
            assert not leaf.any(), path
            continue
        split += 1
        moved = np.moveaxis(leaf, ax, 0)
        want = np.arange(1, leaf.shape[ax] + 1).reshape((-1,) + (1,) * (leaf.ndim - 1))
        np.testing.assert_array_equal(moved, np.broadcast_to(want, moved.shape), err_msg=path)
    # four blocks, six split leaves each (qkv and fc1 kernel and bias, proj and fc2 kernel)
    assert split == 24
    # the readout heads' fc1 / fc2 are the same class as a block's MLP, and replicated
    assert tp_axis("readout_adj_mlp.fc1.weight", 2) is None
    assert tp_axis("up_layers.0.blocks.0.mlp.fc1.bias", 1) == 0
    assert tp_axis("up_layers.0.blocks.0.attn.proj.bias", 1) is None


@pytest.mark.parametrize("tp", [2, 3, 4])
def test_split_by_heads_and_the_replicated_leaves_are_named(caplog, tp):
    """Rank r holds the q, k and v rows of its heads; an attention whose
    heads tp does not divide (or an MLP whose hidden columns it does not)
    stays whole, and the warning names its leaves."""
    from diffusesg_torch.parallel.tp import ModelGroup, shard_model
    full = _tiny_model()
    whole = {n: p.detach().clone() for n, p in full.named_parameters()}
    rank = tp - 1
    with caplog.at_level(logging.WARNING):
        model = _tiny_model()
        kinds = shard_model(model, ModelGroup(rank=rank, size=tp, group=None))
    assert len(kinds) == len(list(model.parameters()))
    warned = "\n".join(r.getMessage() for r in caplog.records)
    params = dict(model.named_parameters())
    for prefix, heads in (("down_layers.0.blocks.0", 3), ("down_layers.1.blocks.0", 6),
                          ("up_layers.0.blocks.0", 6), ("up_layers.1.blocks.0", 3)):
        c = whole[f"{prefix}.attn.proj.weight"].shape[0]
        hidden = whole[f"{prefix}.mlp.fc1.weight"].shape[0]
        q = params[f"{prefix}.attn.qkv.weight"]
        if heads % tp:
            assert f"{prefix}.attn.qkv.weight shape=({3 * c}, {c}) axis=0" in warned
            assert f"{prefix}.attn.proj.weight shape=({c}, {c}) axis=1" in warned
            torch.testing.assert_close(q, whole[f"{prefix}.attn.qkv.weight"], rtol=0, atol=0)
        else:
            local = c // tp
            want = torch.cat([whole[f"{prefix}.attn.qkv.weight"][j * c + rank * local:
                                                                  j * c + (rank + 1) * local]
                              for j in range(3)])
            torch.testing.assert_close(q, want, rtol=0, atol=0)
            torch.testing.assert_close(params[f"{prefix}.attn.proj.weight"],
                                       whole[f"{prefix}.attn.proj.weight"][:, rank * local:
                                                                          (rank + 1) * local],
                                       rtol=0, atol=0)
            assert f"{prefix}.attn.qkv" not in warned
        fc1 = params[f"{prefix}.mlp.fc1.weight"]
        if hidden % tp:
            assert f"{prefix}.mlp.fc1.weight" in warned and fc1.shape[0] == hidden
        else:
            assert fc1.shape[0] == hidden // tp and f"{prefix}.mlp.fc1" not in warned
    # the readout heads stay whole
    assert params["readout_node_mlp.fc1.weight"].shape == whole["readout_node_mlp.fc1.weight"].shape


def test_tensor_parallel_with_the_kernels_on_raises():
    from diffusesg_torch.config import load_config
    from diffusesg_torch.models import make_model
    from diffusesg_torch.parallel.tp import ModelGroup, shard_model
    cfg = tiny_overrides(load_config(SMALL_CFG))
    with cfg.unlocked():
        cfg.tpu.use_pallas_attention = True
    model = make_model(cfg)
    assert model.use_kernels
    with pytest.raises(ValueError, match="use_pallas_attention: false"):
        shard_model(model, ModelGroup(rank=0, size=2, group=None))
