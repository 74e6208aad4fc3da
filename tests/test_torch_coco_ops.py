"""The port's Swin block at window 10 (L = 100, the COCO-Stuff geometry),
plain versions on the CPU vs the JAX package's XLA compositions.

fp32 inputs from a numpy seed.  Forward: atol 2e-4 / rtol 1e-3.  Backward:
rtol 2e-3 + atol 2e-3 * max|ref| per leaf, the bar of
tests/test_torch_train_ops.py.  The static tables are exact.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusesg_tpu.models.layers import relative_position_index, shifted_window_attn_mask
from diffusesg_tpu.ops.mlp_block_kernel import mlp_block_xla
from diffusesg_tpu.ops.swin_block_kernel import swin_attn_block_xla
from diffusesg_torch.models import layers as tlayers
from diffusesg_torch.ops import cuda_build
from diffusesg_torch.ops import mlp_block_kernel as mk
from diffusesg_torch.ops import swin_block_v3 as sw

ATOL, RTOL = 2e-4, 1e-3
WINDOW, L = 10, 100

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import h100_tiles  # noqa: E402
# (grid, shift): the three geometries of the COCO model's stages
GEOMETRIES = [(20, 0), (20, 5), (10, 0)]
ATTN_NAMES = ["dx", "dss", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwproj", "dbproj", "drel"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _case(b, h, c, heads, shift, seed):
    rs = np.random.RandomState(seed)
    f = np.float32
    n = lambda *s, sc=1.0: (rs.randn(*s) * sc).astype(f)  # noqa: E731
    table = n((2 * WINDOW - 1) ** 2, heads)
    rel = table[relative_position_index(WINDOW).reshape(-1)].reshape(L, L, heads)
    return dict(x=n(b, h, h, c), ss=n(b, 2 * c, sc=0.5), g1=1 + n(c, sc=0.1), b1n=n(c, sc=0.1),
                wqkv=n(c, 3 * c, sc=c ** -0.5), bqkv=n(3 * c, sc=0.1),
                wproj=n(c, c, sc=c ** -0.5), bproj=n(c, sc=0.1),
                rel=rel.transpose(2, 0, 1).copy(), g2=1 + n(c, sc=0.1), b2n=n(c, sc=0.1),
                w1=n(c, 4 * c, sc=c ** -0.5), bb1=n(4 * c, sc=0.1),
                w2=n(4 * c, c, sc=(4 * c) ** -0.5), bb2=n(c, sc=0.1), dy=n(b, h, h, c),
                mask=shifted_window_attn_mask(h, h, WINDOW, shift) if shift else None)


ATTN_KEYS = ("ss", "g1", "b1n", "wqkv", "bqkv", "wproj", "bproj", "rel")


def _rolled(a, shift):
    return jnp.roll(jnp.asarray(a), (-shift, -shift), axis=(1, 2)) if shift else jnp.asarray(a)


@pytest.mark.parametrize("h,shift", GEOMETRIES)
def test_window_10_block_matches_jax(h, shift):
    c, heads = 48, 3
    p = _case(2, h, c, heads, shift, seed=h + shift)
    mask = None if p["mask"] is None else jnp.asarray(p["mask"])
    y = swin_attn_block_xla(_rolled(p["x"], shift), *(jnp.asarray(p[k]) for k in ATTN_KEYS),
                            mask, num_heads=heads, window=WINDOW)
    ref = mlp_block_xla(y.reshape(2, h * h, c), *(jnp.asarray(p[k]) for k in
                                                  ("g2", "b2n", "w1", "bb1", "w2", "bb2")),
                        approximate=False).reshape(2, h, h, c)
    if shift:
        y, ref = (jnp.roll(a, (shift, shift), axis=(1, 2)) for a in (y, ref))
    t = {k: (None if v is None else _t(v)) for k, v in p.items()}
    attn_args = (t["x"], t["ss"], t["g1"], t["b1n"], t["wqkv"].T, t["bqkv"], t["wproj"].T,
                 t["bproj"], t["rel"], t["mask"])
    half = sw.swin_attn(*attn_args, heads, WINDOW, shift)
    whole = sw.fused_swin_block(*attn_args, t["g2"], t["b2n"], t["w1"].T, t["bb1"], t["w2"].T,
                                t["bb2"], heads, WINDOW, shift)
    np.testing.assert_allclose(half.numpy(), np.asarray(y), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(whole.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("h,shift", GEOMETRIES)
def test_window_10_attn_bwd_plain_matches_jax_vjp(h, shift):
    c, heads = 64, 2
    p = _case(2, h, c, heads, shift, seed=3 * h + shift)
    mask = None if p["mask"] is None else jnp.asarray(p["mask"])

    def fwd(x, *rest):
        return swin_attn_block_xla(x, *rest, mask, num_heads=heads, window=WINDOW)
    _, vjp = jax.vjp(fwd, _rolled(p["x"], shift), *(jnp.asarray(p[k]) for k in ATTN_KEYS))
    want = vjp(_rolled(p["dy"], shift))
    t = {k: (None if v is None else _t(v)) for k, v in p.items()}
    got = sw.swin_attn_bwd_plain(t["x"], t["ss"], t["dy"], t["g1"], t["b1n"], t["wqkv"].T,
                                 t["bqkv"], t["wproj"].T, t["rel"], t["mask"], heads, WINDOW,
                                 shift)
    for name, a, b in zip(ATTN_NAMES, got, want):
        b = np.asarray(b, dtype=np.float64)
        if name == "dx" and shift:
            b = np.roll(b, (shift, shift), axis=(1, 2))
        if name in ("dwqkv", "dwproj"):
            b = b.T
        np.testing.assert_allclose(a.double().numpy(), b, rtol=2e-3, atol=2e-3 * np.abs(b).max(),
                                   err_msg=name)
    # and the autograd.Function routes a CPU tensor's backward through it
    leaves = [t[k].clone().requires_grad_() for k in ("x", "ss", "g1", "b1n")]
    leaves += [t["wqkv"].T.clone().requires_grad_(), t["bqkv"].clone().requires_grad_(),
               t["wproj"].T.clone().requires_grad_(), t["bproj"].clone().requires_grad_(),
               t["rel"].clone().requires_grad_()]
    via = torch.autograd.grad(sw.swin_attn(*leaves, t["mask"], heads, WINDOW, shift), leaves,
                              t["dy"])
    assert all(torch.equal(a, b) for a, b in zip(via, got))


def test_a_mask_row_that_is_minus_100_everywhere_gives_a_finite_softmax():
    """A row masked at every column keeps equal scores, not NaN: what a wrong
    -inf padding of the 100 -> 112 columns would break on the card."""
    h, c, heads = 20, 32, 1
    p = _case(1, h, c, heads, 5, seed=1)
    p["mask"][:, 7, :] = -100.0
    t = {k: (None if v is None else _t(v)) for k, v in p.items()}
    args = (t["x"], t["ss"], t["g1"], t["b1n"], t["wqkv"].T, t["bqkv"], t["wproj"].T,
            t["bproj"], t["rel"], t["mask"], heads, WINDOW, 5)
    y = sw.swin_attn(*args)
    ref = swin_attn_block_xla(_rolled(p["x"], 5), *(jnp.asarray(p[k]) for k in ATTN_KEYS),
                              jnp.asarray(p["mask"]), num_heads=heads, window=WINDOW)
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(jnp.roll(ref, (5, 5), axis=(1, 2))),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("window,shift,h", [(10, 5, 20), (10, 5, 40)])
def test_window_10_static_tables_match_jax(window, shift, h):
    np.testing.assert_array_equal(tlayers.relative_position_index(window),
                                  relative_position_index(window))
    mask = tlayers.shifted_window_attn_mask(h, h, window, shift)
    assert mask.shape == ((h // window) ** 2, 100, 100)
    np.testing.assert_array_equal(mask, shifted_window_attn_mask(h, h, window, shift))


@pytest.mark.parametrize("b,hw,c,heads", [(64, 40, 96, 3), (16, 20, 192, 6), (4, 10, 384, 12),
                                          (1, 10, 384, 12), (5, 40, 96, 3)])
def test_backward_grid_plans_cover_the_coco_shapes(monkeypatch, b, hw, c, heads):
    """The backward kernels' plans at COCO-Stuff shapes, the tiles from a
    stub of the H100 library (tests/helpers/h100_tiles.py)."""
    h100_tiles.install(monkeypatch)
    plan = sw.attn_bwd_splits(b, hw, hw, c, heads, WINDOW)
    n_windows = b * (hw // WINDOW) ** 2
    assert 1 <= plan["rows"] <= -(-hw * hw // 8)
    assert all(v >= 1 for v in plan.values())
    classes = (hw // WINDOW) ** 2 if hw > WINDOW else 1
    wpb = sw.window_core_plan(n_windows, heads, classes, cuda_build.blocks_per_sm(
        h100_tiles.DEVICE, "dsg_swin_attn_bwd_core_per_sm", L))
    assert 1 <= sw.core_blocks(n_windows, classes, wpb) <= n_windows
    m = b * hw * hw
    gemm = sw.attn_bwd_gemm_plan(m, c, h100_tiles.DEVICE)
    for key, align in (("bqkv", 1), ("bproj", 1)):
        chunk = -(-m // plan[key])
        chunk = -(-chunk // align) * align
        assert chunk * (plan[key] - 1) < m, (key, plan[key])  # no split is empty
    assert gemm["kchunk"] * (gemm["w"] - 1) < m <= gemm["kchunk"] * gemm["w"]
    mlp = mk.mlp_bwd_plan(m, c, 4 * c, h100_tiles.DEVICE)
    assert mlp["w"] >= 1 and mlp["fused"] == (c in (96, 192))
    assert mlp["fused"] or 1 <= mlp["ln"] <= cuda_build.TARGET_BLOCKS


@pytest.mark.parametrize("b,hw,c,heads", [(64, 40, 96, 3), (64, 20, 192, 6), (64, 10, 384, 12),
                                          (16, 10, 384, 12), (1, 10, 384, 12), (5, 40, 96, 3)])
def test_forward_grid_plan_covers_the_coco_shapes(monkeypatch, b, hw, c, heads):
    """swin_attn's plan at COCO-Stuff shapes (window 10: a window in 112
    rows, one a block), the tile from a stub of the H100 library
    (tests/helpers/h100_tiles.py): every window once a head group, groups
    of at most the heads a block holds, and the heads split only where the
    windows cannot fill the card (10x10 C384 from batch 64 down, where a
    block holds half its heads too)."""
    h100_tiles.install(monkeypatch)
    tile = sw.attn_tile(h100_tiles.DEVICE, c, L)
    assert tile[:2] == (112, 1)
    n_windows = b * (hw // WINDOW) ** 2
    plan = sw.attn_plan(n_windows, heads, 1, tile)
    assert plan["tiles"] == n_windows
    assert plan["heads"] <= tile[3] and plan["groups"] * plan["heads"] >= heads
    assert (plan["groups"] - 1) * plan["heads"] < heads  # no group is empty
    # one wave: a second group only where twice the tiles still fit in it
    assert (plan["groups"] > 1) == (2 * n_windows <= 132 * tile[2] or heads > tile[3])


@pytest.mark.parametrize("window,c,heads,match", [
    (7, 64, 2, "swin_attn covers windows"),      # a window the kernels are not built for
    (10, 96, 2, "swin_attn covers windows"),     # head_dim 48
])
def test_an_uncovered_geometry_raises_by_name(window, c, heads, match):
    """Off the CPU the wrapper launches its kernel or raises; no plain version
    stands in (meta tensors reach the check without a card)."""
    L_ = window * window
    h = 2 * window
    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    args = (m(1, h, h, c), m(1, 2 * c), m(c), m(c), m(3 * c, c), m(3 * c), m(c, c), m(c),
            m(heads, L_, L_), None, heads, window, 0)
    with pytest.raises(ValueError, match=match):
        sw.swin_attn_fwd(*args)
    with pytest.raises(ValueError, match=match):
        sw.swin_attn_bwd(args[0], args[1], m(1, h, h, c), *args[2:7], *args[8:])
