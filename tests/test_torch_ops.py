"""Port kernel modules (plain versions, CPU) vs the JAX package's XLA
compositions, fp32, atol 2e-4 / rtol 1e-3.

Each wrapper is called on CPU tensors, which is where it takes its plain
version; the JAX side runs the entry that holds the Pallas kernel, which off
the TPU falls back to the same XLA composition its own tests use.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusesg_tpu.models.layers import relative_position_index, shifted_window_attn_mask
from diffusesg_tpu.ops.mlp_block_kernel import fused_mlp_block, mlp_block_xla
from diffusesg_tpu.ops.patch_resample import fused_patch_breakup, fused_patch_merge
from diffusesg_tpu.ops.readout_kernel import fused_readout_mlp
from diffusesg_tpu.ops.swin_block_v3 import fused_swin_block_v3
from diffusesg_torch.models import layers as tlayers
from diffusesg_torch.ops.mlp_block_kernel import mlp_block_plain, token_mlp
from diffusesg_torch.ops.patch_resample import patch_breakup, patch_merge
from diffusesg_torch.ops.readout_kernel import readout_mlp
from diffusesg_torch.ops.swin_block_v3 import fused_swin_block, swin_attn

ATOL, RTOL = 2e-4, 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def _block_params(rng, c, heads, window, hidden):
    L = window * window
    table = rng.standard_normal(((2 * window - 1) ** 2, heads)).astype(np.float32)
    rel = table[relative_position_index(window).reshape(-1)].reshape(L, L, heads)
    n = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)  # noqa: E731
    return dict(ln1_g=1 + n(c), ln1_b=n(c), wqkv=n(c, 3 * c), bqkv=n(3 * c),
                wproj=n(c, c), bproj=n(c), rel=rel.transpose(2, 0, 1).copy(),
                ln2_g=1 + n(c), ln2_b=n(c), w1=n(c, hidden), b1=n(hidden),
                w2=n(hidden, c), b2=n(c))


@pytest.mark.parametrize("h,c,heads,shift", [
    (16, 24, 3, 0),   # windowed stage, unshifted
    (16, 24, 3, 4),   # shifted windows with the -100 mask
    (8, 48, 6, 0),    # the window covers the grid
])
def test_swin_block_matches_jax(h, c, heads, shift):
    rng = np.random.default_rng(h + c + shift)
    window, b = 8, 2
    p = _block_params(rng, c, heads, window, 4 * c)
    x = rng.standard_normal((b, h, h, c)).astype(np.float32)
    ss = (rng.standard_normal((b, 2 * c)) * 0.5).astype(np.float32)
    mask = shifted_window_attn_mask(h, h, window, shift) if shift else None

    xr = jnp.roll(x, (-shift, -shift), axis=(1, 2)) if shift else x
    ref = fused_swin_block_v3(
        xr, ss, p["ln1_g"], p["ln1_b"], p["wqkv"], p["bqkv"], p["wproj"], p["bproj"],
        p["rel"], None if mask is None else jnp.asarray(mask), p["ln2_g"], p["ln2_b"],
        p["w1"], p["b1"], p["w2"], p["b2"], heads, window)
    if shift:
        ref = jnp.roll(ref, (shift, shift), axis=(1, 2))

    tp = {k: _t(v) for k, v in p.items()}
    port = fused_swin_block(
        _t(x), _t(ss), tp["ln1_g"], tp["ln1_b"], tp["wqkv"].T, tp["bqkv"], tp["wproj"].T,
        tp["bproj"], tp["rel"], None if mask is None else _t(mask), tp["ln2_g"], tp["ln2_b"],
        tp["w1"].T, tp["b1"], tp["w2"].T, tp["b2"], heads, window, shift)
    _close(port, ref)
    # the attention half alone is the other rounding point of the block
    attn = swin_attn(_t(x), _t(ss), tp["ln1_g"], tp["ln1_b"], tp["wqkv"].T, tp["bqkv"],
                     tp["wproj"].T, tp["bproj"], tp["rel"],
                     None if mask is None else _t(mask), heads, window, shift)
    assert attn.shape == (b, h, h, c) and torch.isfinite(attn).all()


@pytest.mark.parametrize("c", [24, 48])
def test_token_mlp_matches_jax(c):
    rng = np.random.default_rng(c)
    p = _block_params(rng, c, 3, 8, 4 * c)
    x = rng.standard_normal((2, 64, c)).astype(np.float32)
    ref = fused_mlp_block(x, p["ln2_g"], p["ln2_b"], p["w1"], p["b1"], p["w2"], p["b2"])
    np.testing.assert_allclose(
        np.asarray(ref),
        np.asarray(mlp_block_xla(x, p["ln2_g"], p["ln2_b"], p["w1"], p["b1"], p["w2"], p["b2"])))
    tp = {k: _t(v) for k, v in p.items()}
    args = (tp["ln2_g"], tp["ln2_b"], tp["w1"].T, tp["b1"], tp["w2"].T, tp["b2"])
    port = token_mlp(_t(x), *args)
    _close(port, ref)
    assert torch.equal(port, mlp_block_plain(_t(x), *args))


# small widths, then every C of the model's merges at small grids: K = 4C of
# 384, 768 and 1536
@pytest.mark.parametrize("h,c", [(16, 24), (8, 48), (8, 96), (4, 192), (4, 384)])
def test_patch_merge_matches_jax(h, c):
    rng = np.random.default_rng(h * c)
    x = rng.standard_normal((2, h, h, c)).astype(np.float32)
    g = (1 + 0.2 * rng.standard_normal(4 * c)).astype(np.float32)
    bt = (0.2 * rng.standard_normal(4 * c)).astype(np.float32)
    w = (0.2 * rng.standard_normal((4 * c, 2 * c))).astype(np.float32)
    ref = fused_patch_merge(x, g, bt, w)
    port = patch_merge(_t(x), _t(g), _t(bt), _t(w).T)
    assert port.shape == (2, h // 2, h // 2, 2 * c)
    _close(port, ref)


@pytest.mark.parametrize("h,c_out,with_skip", [(8, 24, True), (4, 48, True), (8, 24, False)])
def test_patch_breakup_matches_jax(h, c_out, with_skip):
    rng = np.random.default_rng(h * c_out)
    dim = 4 * c_out
    c1 = dim // 2 if with_skip else dim
    x = rng.standard_normal((2, h, h, c1)).astype(np.float32)
    skip = rng.standard_normal((2, h, h, dim - c1)).astype(np.float32) if with_skip else None
    n = lambda *s: (0.2 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    w_in, g1, b1, g2, b2, w_out = n(dim, dim), 1 + n(dim), n(dim), 1 + n(c_out), n(c_out), \
        n(c_out, c_out)
    xcat = np.concatenate([x, skip], -1) if with_skip else x
    ref = fused_patch_breakup(xcat, w_in, g1, b1, g2, b2, w_out)
    port = patch_breakup(_t(x), None if skip is None else _t(skip), _t(w_in).T, _t(g1),
                         _t(b1), _t(g2), _t(b2), _t(w_out).T)
    assert port.shape == (2, 2 * h, 2 * h, c_out)
    _close(port, ref)


@pytest.mark.parametrize("n_out", [1, 5, 16])
def test_readout_matches_jax(n_out):
    rng = np.random.default_rng(n_out)
    c = 24
    x = rng.standard_normal((2 * 256, c)).astype(np.float32)
    w1, b1 = (0.3 * rng.standard_normal((c, c))).astype(np.float32), \
        (0.3 * rng.standard_normal(c)).astype(np.float32)
    w2, b2 = (0.3 * rng.standard_normal((c, n_out))).astype(np.float32), \
        (0.3 * rng.standard_normal(n_out)).astype(np.float32)
    ref = fused_readout_mlp(x, w1, b1, w2, b2)
    port = readout_mlp(_t(x), _t(w1).T, _t(b1), _t(w2).T, _t(b2))
    assert port.dtype == torch.float32 and port.shape == (2 * 256, n_out)
    _close(port, ref)


@pytest.mark.parametrize("window,shift,h", [(8, 4, 16), (4, 2, 8)])
def test_static_window_tables_match_jax(window, shift, h):
    np.testing.assert_array_equal(tlayers.relative_position_index(window),
                                  relative_position_index(window))
    np.testing.assert_array_equal(tlayers.shifted_window_attn_mask(h, h, window, shift),
                                  shifted_window_attn_mask(h, h, window, shift))


def test_cpu_wrappers_leave_no_kernel_counts():
    from diffusesg_torch.ops import cuda_build
    cuda_build.reset_launches()
    x = torch.randn(8, 16)
    readout_mlp(x, torch.randn(16, 16), torch.randn(16), torch.randn(3, 16), torch.randn(3))
    assert cuda_build.launches_by_kernel() == {}
    assert jax.default_backend() == "cpu"
