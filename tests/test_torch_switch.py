"""The config's ``tpu.use_pallas_attention`` switch in the port (CPU, fp32).

The JAX factory runs its kernels only when the switch is on and its XLA
composition in ``tpu.compute_dtype`` otherwise (diffusesg_tpu/models/
factory.py).  The port's ``make_model`` reads the same keys: with the switch
off every layer runs its plain version and no kernel entry point is reached,
forward or backward; with it on the entry points are reached (on the CPU they
take their plain versions).  ``configs/vg_small_test.yaml`` sets float32 and
the switch off, with head_dim 16, which no kernel covers.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_parity import (ATOL, COCO_CFG, RTOL, SMALL_CFG, VG_CFG, model_pair,  # noqa: E402
                          node_flags)

from diffusesg_torch.config import ConfigDict, load_config  # noqa: E402
from diffusesg_torch.models import make_model  # noqa: E402
from diffusesg_torch.models.layers import (Mlp, PatchBreakup, PatchMerging, SwinBlock,  # noqa: E402
                                           WindowAttention)
from diffusesg_torch.ops import cuda_build  # noqa: E402
from diffusesg_torch.ops import mlp_block_kernel as mk  # noqa: E402
from diffusesg_torch.ops import patch_resample as pr  # noqa: E402
from diffusesg_torch.ops import readout_kernel as rk  # noqa: E402
from diffusesg_torch.ops import swin_block_v3 as sw  # noqa: E402
from diffusesg_torch.ops import window_attention as wa  # noqa: E402

# every dispatcher between a layer and its kernel: (module, name)
ENTRIES = [(sw, "swin_attn_fwd"), (sw, "swin_attn_bwd"), (mk, "token_mlp_fwd"),
           (mk, "token_mlp_bwd"), (pr, "patch_merge_fwd"), (pr, "patch_breakup_fwd"),
           (rk, "readout_mlp_fwd"), (wa, "window_attention_fwd")]
KERNEL_LAYERS = (SwinBlock, WindowAttention, Mlp, PatchMerging, PatchBreakup)


def _without_tpu(cfg):
    return ConfigDict({k: v for k, v in cfg.to_dict().items() if k != "tpu"})


def _switched(cfg, on: bool):
    with cfg.unlocked():
        cfg.tpu.use_pallas_attention = on
    return cfg


@pytest.mark.parametrize("path,on,dtype", [(SMALL_CFG, False, torch.float32),
                                           (VG_CFG, True, torch.bfloat16),
                                           (COCO_CFG, True, torch.bfloat16),
                                           (None, False, torch.float32)])
def test_make_model_reads_the_switch(path, on, dtype):
    """Every layer with a kernel gets the config's switch; a config without
    a ``tpu:`` block gives the switch off and float32."""
    cfg = _without_tpu(load_config(SMALL_CFG)) if path is None else load_config(path)
    model = make_model(cfg)
    assert model.use_kernels is on and model.dtype == dtype
    layers = [m for m in model.modules() if isinstance(m, KERNEL_LAYERS)]
    assert {type(m) for m in layers} == set(KERNEL_LAYERS)
    assert all(m.use_kernels is on for m in layers)


def _loss(model, seed=0):
    n = 16
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    a, x = model(f(2, n, n), f(2, n, 5), torch.from_numpy(node_flags(2, n, [n, 9])),
                 f(2), f(2, n, n), f(2, n, 5))
    return (a.float() ** 2).mean() + (x.float() ** 2).mean()


def _small_model(on: bool):
    model = make_model(_switched(load_config(SMALL_CFG), on))
    torch.manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(std=0.15)
    return model


def test_switch_off_never_enters_a_kernel_entry_point(monkeypatch):
    """Forward and backward of the small model with the switch off, every
    kernel dispatcher and the kernel library made to raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel entry point was reached with the switch off")
    for mod, name in ENTRIES:
        monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setattr(cuda_build, "lib", refuse)
    model = _small_model(False)
    grads = torch.autograd.grad(_loss(model), list(model.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)
    assert sum(float(g.abs().sum()) > 0 for g in grads) > len(grads) // 2


def test_switch_on_reaches_the_entry_points(monkeypatch):
    """The same model with the switch on goes through every dispatcher its
    layers have (on CPU tensors they run the plain versions), and computes
    the same loss and gradients as with the switch off."""
    reached = []

    def recording(mod, name):
        orig = getattr(mod, name)

        def entry(*args, **kwargs):
            reached.append(name)
            return orig(*args, **kwargs)
        return entry
    for mod, name in ENTRIES:
        monkeypatch.setattr(mod, name, recording(mod, name))
    on, off = _small_model(True), _small_model(False)
    loss_on = _loss(on)
    forward = set(reached)
    grads_on = torch.autograd.grad(loss_on, list(on.parameters()))
    assert forward == {"swin_attn_fwd", "token_mlp_fwd", "patch_merge_fwd", "patch_breakup_fwd",
                       "readout_mlp_fwd"}
    assert {"swin_attn_bwd", "token_mlp_bwd"} <= set(reached)
    reached.clear()
    loss_off = _loss(off)
    grads_off = torch.autograd.grad(loss_off, list(off.parameters()))
    assert reached == []
    torch.testing.assert_close(loss_on, loss_off, rtol=1e-5, atol=0)
    for g_on, g_off in zip(grads_on, grads_off):
        torch.testing.assert_close(g_on, g_off, rtol=1e-4, atol=1e-6)


def test_window_attention_switch(monkeypatch):
    """The stand-alone WindowAttention: its kernel entry with the switch on,
    the plain attention with it off; the same values on the CPU."""
    calls = []
    entry = wa.window_attention_fwd
    monkeypatch.setattr(wa, "window_attention_fwd",
                        lambda *args: calls.append(len(calls)) or entry(*args))
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 64, 48).astype(np.float32))
    outs = []
    for on in (False, True):
        m = WindowAttention(48, 8, 3, use_kernels=on)
        torch.manual_seed(1)
        with torch.no_grad():
            for p in m.parameters():
                p.normal_(std=0.2)
        outs.append(m(x))
        assert len(calls) == int(on)
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-6, atol=1e-6)


def test_small_config_matches_the_jax_xla_model():
    """``configs/vg_small_test.yaml`` as the file has it (N = 16, embed 48,
    depths (1, 1), window 8: head_dim 16, float32, switch off): the port's
    denoiser built through ``make_model`` against the JAX XLA model on shared
    weights, fp32, atol 2e-4 / rtol 1e-3."""
    from diffusesg_tpu.config import load_config as jload
    jcfg, tcfg = jload(SMALL_CFG), load_config(SMALL_CFG)
    jm, params, tm = model_pair(jcfg, tcfg)
    assert not tm.use_kernels and tm.dtype == torch.float32
    assert not jm.use_pallas
    n = tcfg.dataset.max_node_num
    rng = np.random.default_rng(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    adj, node, sa, sx = f(2, n, n), f(2, n, 5), f(2, n, n), f(2, n, 5)
    flags = node_flags(2, n, [n, 6])
    c_noise = np.log(np.array([0.4, 3.0], np.float32)) / 4.0
    ja, jx = jm.apply(params, adj, node, flags, c_noise, sa, sx)
    with torch.no_grad():
        ta, tx = tm(*(torch.from_numpy(v) for v in (adj, node, flags, c_noise, sa, sx)))
    assert float(np.abs(np.asarray(ja)).max()) > 1e-2  # the weights make the outputs matter
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL, rtol=RTOL)

