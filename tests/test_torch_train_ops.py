"""Backward of the port's kernel modules (plain versions, CPU) vs the JAX
package: ``jax.vjp`` of its XLA compositions and, for the attention half,
its Pallas backward kernel in interpret mode; and vs ``torch.autograd`` of
the port's own plain forwards in double precision.

fp32 inputs from a numpy seed.  Tolerances: against JAX in fp32, rtol 2e-3 +
atol 2e-3 * max|ref| (the bar of tests/test_backward_kernels.py, scaled to
the leaf because sums over tokens grow with the token count); against
autograd in fp64, 1e-9 relative to max|ref|.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusesg_tpu.models.layers import shifted_window_attn_mask
from diffusesg_tpu.ops import mlp_block_kernel as jmlp
from diffusesg_tpu.ops import swin_block_v3 as jv3
from diffusesg_tpu.ops.patch_resample import patch_breakup_xla, patch_merge_xla
from diffusesg_tpu.ops.readout_kernel import readout_mlp_xla
from diffusesg_tpu.ops.swin_block_kernel import swin_attn_block_xla
from diffusesg_torch.ops import cuda_build
from diffusesg_torch.ops import mlp_block_kernel as mk
from diffusesg_torch.ops import swin_block_v3 as sw
from diffusesg_torch.ops import patch_resample as pr
from diffusesg_torch.ops.patch_resample import patch_breakup, patch_merge
from diffusesg_torch.ops.readout_kernel import readout_mlp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import h100_tiles  # noqa: E402

RTOL, ATOL_FRAC = 2e-3, 2e-3


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _close(got, want, name, rtol=RTOL, atol_frac=ATOL_FRAC):
    want = np.asarray(want, dtype=np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * np.abs(want).max(),
                               err_msg=name)


def _mlp_case(n, c, seed):
    rs = np.random.RandomState(seed)
    hidden = 4 * c
    f = np.float32
    return dict(x=rs.randn(n, c).astype(f), g=(1 + 0.1 * rs.randn(c)).astype(f),
                b=(0.1 * rs.randn(c)).astype(f), w1=(rs.randn(c, hidden) * c ** -0.5).astype(f),
                b1=(0.1 * rs.randn(hidden)).astype(f),
                w2=(rs.randn(hidden, c) * hidden ** -0.5).astype(f),
                b2=(0.1 * rs.randn(c)).astype(f), ct=rs.randn(n, c).astype(f))


MLP_NAMES = ["dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"]


@pytest.mark.parametrize("n,c", [(96, 32), (40, 64)])
def test_mlp_bwd_plain_matches_jax_vjp(n, c):
    p = _mlp_case(n, c, seed=n + c)
    fwd = lambda *a: jmlp.mlp_block_xla(a[0][None], *a[1:], approximate=False)[0]  # noqa: E731
    _, vjp = jax.vjp(fwd, *(jnp.asarray(p[k]) for k in ("x", "g", "b", "w1", "b1", "w2", "b2")))
    want = vjp(jnp.asarray(p["ct"]))
    got = mk.mlp_bwd_plain(_t(p["x"]), _t(p["ct"]), _t(p["g"]), _t(p["b"]), _t(p["w1"]).T,
                           _t(p["b1"]), _t(p["w2"]).T)
    for name, a, b in zip(MLP_NAMES, got, want):
        _close(a, np.asarray(b).T if name in ("dw1", "dw2") else b, name)


def _attn_case(b, h, c, heads, shift, seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    L = 64
    n = lambda *s, sc=1.0: (rs.randn(*s) * sc).astype(dtype)  # noqa: E731
    return dict(x=n(b, h, h, c), ss=n(b, 2 * c, sc=0.5), g=(1 + n(c, sc=0.1)).astype(dtype),
                bt=n(c, sc=0.1), wqkv=n(c, 3 * c, sc=c ** -0.5), bqkv=n(3 * c, sc=0.1),
                wproj=n(c, c, sc=c ** -0.5), bproj=n(c, sc=0.1), rel=n(heads, L, L),
                mask=(shifted_window_attn_mask(h, h, 8, shift).astype(dtype) if shift else None),
                dy=n(b, h, h, c))


ATTN_NAMES = ["dx", "dss", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwproj", "dbproj", "drel"]


def _port_attn_bwd(p, heads, shift, dtype=torch.float32):
    t = {k: (None if v is None else _t(v, dtype)) for k, v in p.items()}
    return sw.swin_attn_bwd_plain(t["x"], t["ss"], t["dy"], t["g"], t["bt"], t["wqkv"].T,
                                  t["bqkv"], t["wproj"].T, t["rel"], t["mask"], heads, 8, shift)


def _rolled(a, shift):
    return jnp.roll(jnp.asarray(a), (-shift, -shift), axis=(1, 2)) if shift else jnp.asarray(a)


def _compare_attn(got, want, shift):
    for name, a, b in zip(ATTN_NAMES, got, want):
        b = np.asarray(b)
        if name == "dx" and shift:
            b = np.roll(b, (shift, shift), axis=(1, 2))
        _close(a, b.T if name in ("dwqkv", "dwproj") else b, name)


@pytest.mark.parametrize("h,c,heads,shift", [(16, 64, 2, 0), (16, 64, 2, 4), (8, 96, 3, 0)])
def test_swin_attn_bwd_plain_matches_jax_vjp(h, c, heads, shift):
    p = _attn_case(2, h, c, heads, shift, seed=h + c + shift)
    mask = None if p["mask"] is None else jnp.asarray(p["mask"])

    def fwd(x, ss, g, bt, wq, bq, wp, bp, rel):
        return swin_attn_block_xla(x, ss, g, bt, wq, bq, wp, bp, rel, mask,
                                   num_heads=heads, window=8)
    args = [_rolled(p["x"], shift)] + [jnp.asarray(p[k]) for k in
                                       ("ss", "g", "bt", "wqkv", "bqkv", "wproj", "bproj", "rel")]
    _, vjp = jax.vjp(fwd, *args)
    want = vjp(_rolled(p["dy"], shift))
    _compare_attn(_port_attn_bwd(p, heads, shift), want, shift)


@pytest.mark.parametrize("shift", [0, 4])
def test_swin_attn_bwd_plain_matches_pallas_backward_in_interpret_mode(shift):
    h, c, heads = 16, 64, 2
    p = _attn_case(2, h, c, heads, shift, seed=11 + shift)
    mask = None if p["mask"] is None else jnp.asarray(p["mask"])
    jv3.INTERPRET = True
    try:
        want = jv3._attn_bwd_call(
            _rolled(p["x"], shift), *(jnp.asarray(p[k]) for k in
                                      ("ss", "g", "bt", "wqkv", "bqkv", "wproj", "rel")),
            mask, _rolled(p["dy"], shift), heads, 8)
    finally:
        jv3.INTERPRET = False
    assert want is not None
    _compare_attn(_port_attn_bwd(p, heads, shift), want, shift)


@pytest.mark.parametrize("n,c", [(256, 32), (96, 64)])
def test_mlp_bwd_plain_matches_pallas_backward_in_interpret_mode(n, c):
    """The counterpart of the attention half's check above: the MLP half's
    plain backward against the Pallas kernel ``mlp_bwd_call`` in interpret
    mode.  The kernel takes the tanh-form GELU derivative against the erf
    forward (``_gelu_tanh_grad``); the port takes the exact erf derivative,
    the vjp of its forward and of the JAX XLA composition.  So the bar is
    the JAX suite's own for that kernel, 5e-3 (tests/test_backward_kernels.py),
    relative to each leaf's max as above."""
    p = _mlp_case(n, c, seed=7 + c)
    jmlp.INTERPRET = True
    try:
        want = jmlp.mlp_bwd_call(*(jnp.asarray(p[k]) for k in
                                   ("x", "g", "b", "w1", "b1", "w2", "ct")))
    finally:
        jmlp.INTERPRET = False
    assert want is not None
    got = mk.mlp_bwd_plain(_t(p["x"]), _t(p["ct"]), _t(p["g"]), _t(p["b"]), _t(p["w1"]).T,
                           _t(p["b1"]), _t(p["w2"]).T)
    for name, a, b in zip(MLP_NAMES, got, want):
        b = np.asarray(b).reshape(-1) if name in ("dgamma", "dbeta", "db1", "db2") else b
        _close(a, np.asarray(b).T if name in ("dw1", "dw2") else b, name, rtol=5e-3,
               atol_frac=5e-3)


def _max_rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def test_mlp_bwd_plain_is_the_vjp_of_its_forward_in_double():
    p = {k: _t(v, torch.float64) for k, v in _mlp_case(48, 16, seed=3).items()}
    leaves = [p[k].clone().requires_grad_() for k in ("x", "g", "b")]
    leaves += [p["w1"].T.clone().requires_grad_(), p["b1"].clone().requires_grad_(),
               p["w2"].T.clone().requires_grad_(), p["b2"].clone().requires_grad_()]
    want = torch.autograd.grad(mk.mlp_block_plain(*leaves), leaves, p["ct"])
    got = mk.mlp_bwd_plain(leaves[0].detach(), p["ct"], *(t.detach() for t in leaves[1:6]))
    for name, a, b in zip(MLP_NAMES, got, want):
        assert a.dtype == torch.float64 and _max_rel(a, b) < 1e-9, name
    # and the autograd.Function routes a CPU tensor's backward through it
    via = torch.autograd.grad(mk.token_mlp(*leaves), leaves, p["ct"])
    for name, a, b in zip(MLP_NAMES, via, want):
        assert _max_rel(a, b) < 1e-9, name


@pytest.mark.parametrize("shift", [0, 4])
def test_swin_attn_bwd_plain_is_the_vjp_of_its_forward_in_double(shift):
    heads = 2
    p = _attn_case(2, 16, 64, heads, shift, seed=5, dtype=np.float64)
    t = {k: (None if v is None else _t(v, torch.float64)) for k, v in p.items()}
    leaves = [t["x"], t["ss"], t["g"], t["bt"], t["wqkv"].T.contiguous(), t["bqkv"],
              t["wproj"].T.contiguous(), t["bproj"], t["rel"]]
    leaves = [x.clone().requires_grad_() for x in leaves]
    y = sw.swin_attn_block_plain(*leaves, t["mask"], heads, 8, shift)
    want = torch.autograd.grad(y, leaves, t["dy"])
    got = _port_attn_bwd(p, heads, shift, torch.float64)
    for name, a, b in zip(ATTN_NAMES, got, want):
        assert a.dtype == torch.float64 and _max_rel(a, b) < 1e-9, name
    via = torch.autograd.grad(sw.swin_attn(*leaves, t["mask"], heads, 8, shift), leaves, t["dy"])
    for name, a, b in zip(ATTN_NAMES, via, want):
        assert _max_rel(a, b) < 1e-9, name


def _function_grads(fn, tensors, ct):
    leaves = [None if x is None else x.clone().requires_grad_() for x in tensors]
    out = fn(*leaves)
    return torch.autograd.grad(out, [x for x in leaves if x is not None], ct)


@pytest.mark.parametrize("window,shift", [(8, 0), (8, 4), (10, 5)])
def test_window_core_drel_plain_is_the_plain_backwards_drel(window, shift):
    """The plain backward of the window core alone, fed the qkv and d(attn)
    that ``swin_attn_bwd_plain`` computes (raster rows, unrolled, as
    ``swin_attn_bwd_operands_plain`` returns them), gives that function's
    d(rel_bias): the check of the kernel's core in chip_smoke.py."""
    import torch.nn.functional as F
    rs = np.random.RandomState(window + shift)
    b, hw, heads = 2, 2 * window, 2
    c, L = 32 * heads, window * window
    x, dy = _t(rs.randn(b, hw, hw, c)), _t(rs.randn(b, hw, hw, c))
    ss = _t(0.5 * rs.randn(b, 2 * c))
    g, bt = _t(1 + 0.1 * rs.randn(c)), _t(0.1 * rs.randn(c))
    wqkv, bqkv = _t(rs.randn(3 * c, c) * c ** -0.5), _t(0.1 * rs.randn(3 * c))
    wproj, rel = _t(rs.randn(c, c) * c ** -0.5), _t(rs.randn(heads, L, L))
    mask = _t(shifted_window_attn_mask(hw, hw, window, shift)) if shift else None
    want = sw.swin_attn_bwd_plain(x, ss, dy, g, bt, wqkv, bqkv, wproj, rel, mask, heads,
                                  window, shift)[8]
    scale, sh = ss[:, None, None, :].chunk(2, dim=-1)
    hbar, _ = mk.ln_stats(F.silu(sh + x * (scale + 1.0)))
    hn, qkv, dattn = sw.swin_attn_bwd_operands_plain(x, ss, dy, g, bt, wqkv, bqkv, wproj,
                                                     window, shift)
    _close(hn, (hbar * g + bt).numpy(), "hn", rtol=1e-5, atol_frac=1e-5)
    _close(qkv, ((hbar * g + bt) @ wqkv.T + bqkv).numpy(), "qkv", rtol=1e-5, atol_frac=1e-5)
    _close(dattn, (dy @ wproj).numpy(), "dattn", rtol=1e-5, atol_frac=1e-5)
    got = sw.window_core_drel_plain(qkv, dattn, rel, mask, heads, window, shift)
    _close(got, want.numpy(), "drel", rtol=1e-5, atol_frac=1e-5)


def test_patch_merge_function_gradients_match_jax_vjp():
    rs = np.random.RandomState(1)
    h, c = 8, 24
    f = np.float32
    x, g, bt = rs.randn(2, h, h, c).astype(f), (1 + 0.2 * rs.randn(4 * c)).astype(f), \
        (0.2 * rs.randn(4 * c)).astype(f)
    w = (0.2 * rs.randn(4 * c, 2 * c)).astype(f)
    ct = rs.randn(2, h // 2, h // 2, 2 * c).astype(f)
    _, vjp = jax.vjp(patch_merge_xla, *(jnp.asarray(a) for a in (x, g, bt, w)))
    want = vjp(jnp.asarray(ct))
    got = _function_grads(patch_merge, [_t(x), _t(g), _t(bt), _t(w).T.contiguous()], _t(ct))
    for name, a, b in zip(("dx", "dg", "db", "dw"), got, want):
        _close(a, np.asarray(b).T if name == "dw" else b, name)


@pytest.mark.parametrize("with_skip", [True, False])
def test_patch_breakup_function_gradients_match_jax_vjp(with_skip):
    rs = np.random.RandomState(2)
    h, c_out = 4, 24
    dim = 4 * c_out
    f = np.float32
    n = lambda *s: (0.2 * rs.randn(*s)).astype(f)  # noqa: E731
    xcat = rs.randn(2, h, h, dim).astype(f)
    w_in, g1, b1, g2, b2, w_out = n(dim, dim), 1 + n(dim), n(dim), 1 + n(c_out), n(c_out), \
        n(c_out, c_out)
    ct = rs.randn(2, 2 * h, 2 * h, c_out).astype(f)
    _, vjp = jax.vjp(patch_breakup_xla, *(jnp.asarray(a) for a in
                                          (xcat, w_in, g1, b1, g2, b2, w_out)))
    want = [np.asarray(a) for a in vjp(jnp.asarray(ct))]
    c1 = dim // 2 if with_skip else dim
    x, skip = _t(xcat[..., :c1]), (_t(xcat[..., c1:]) if with_skip else None)
    got = list(_function_grads(
        patch_breakup, [x, skip, _t(w_in).T.contiguous(), _t(g1), _t(b1), _t(g2), _t(b2),
                        _t(w_out).T.contiguous()], _t(ct)))
    dx = got.pop(0)
    if with_skip:
        dx = torch.cat([dx, got.pop(0)], dim=-1)
    for name, a, b in zip(("dx", "dw_in", "dg1", "db1", "dg2", "db2", "dw_out"), [dx] + got, want):
        _close(a, b.T if name in ("dw_in", "dw_out") else b, name)


@pytest.mark.parametrize("which", ["merge", "breakup", "breakup_no_skip"])
def test_resample_functions_on_cpu_tensors_take_plain_vjp(monkeypatch, which):
    """On CPU tensors ``_PatchMerge`` and ``_PatchBreakup`` differentiate
    their plain versions through ``cuda_build.plain_vjp`` (the card's kernel
    backwards are CUDA-only), in bf16 as the model runs them: each gradient
    bit-equal to autograd through the plain version itself."""
    from diffusesg_torch.ops import cuda_build
    calls = []
    orig = cuda_build.plain_vjp

    def recording(fn, *args):
        calls.append(fn.__name__)
        return orig(fn, *args)
    monkeypatch.setattr(cuda_build, "plain_vjp", recording)
    gen = torch.Generator().manual_seed(3)
    r = lambda *s, scale=1.0, dt=torch.bfloat16: (torch.randn(*s, generator=gen)  # noqa: E731
                                                  * scale).to(dt)
    if which == "merge":
        c = 16
        tensors = [r(2, 8, 8, c), 1 + r(4 * c, scale=0.1, dt=torch.float32),
                   r(4 * c, scale=0.1, dt=torch.float32), r(2 * c, 4 * c, scale=0.125)]
        fn, plain, ct = patch_merge, pr.patch_merge_plain, r(2, 4, 4, 2 * c)
    else:
        c_out, cin = 8, 64
        skip = r(2, 4, 4, cin // 2) if which == "breakup" else None
        tensors = [r(2, 4, 4, cin // 2 if skip is not None else cin), skip,
                   r(4 * c_out, cin, scale=0.125), 1 + r(4 * c_out, scale=0.1, dt=torch.float32),
                   r(4 * c_out, scale=0.1, dt=torch.float32),
                   1 + r(c_out, scale=0.1, dt=torch.float32), r(c_out, scale=0.1, dt=torch.float32),
                   r(c_out, c_out, scale=0.3)]
        fn, plain, ct = patch_breakup, pr.patch_breakup_plain, r(2, 8, 8, c_out)
    got = _function_grads(fn, tensors, ct)
    assert calls == [plain.__name__]
    want = _function_grads(plain, tensors, ct)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("n_out", [1, 5])
def test_readout_function_gradients_match_jax_vjp(n_out):
    rs = np.random.RandomState(n_out)
    c = 24
    f = np.float32
    x, w1, b1 = rs.randn(128, c).astype(f), (0.3 * rs.randn(c, c)).astype(f), \
        (0.3 * rs.randn(c)).astype(f)
    w2, b2 = (0.3 * rs.randn(c, n_out)).astype(f), (0.3 * rs.randn(n_out)).astype(f)
    ct = rs.randn(128, n_out).astype(f)
    _, vjp = jax.vjp(readout_mlp_xla, *(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    want = vjp(jnp.asarray(ct))
    got = _function_grads(readout_mlp, [_t(x), _t(w1).T.contiguous(), _t(b1),
                                        _t(w2).T.contiguous(), _t(b2)], _t(ct))
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        _close(a, np.asarray(b).T if name in ("dw1", "dw2") else b, name)


@pytest.mark.parametrize("parallel,length,min_len,align", [
    (6, 262144, 256, 32), (288, 4096, 256, 32), (1, 200, 256, 32), (2, 65536, 64, 1),
    (12, 1000, 64, 1), (1, 7, 64, 1)])
def test_split_count_leaves_no_part_empty(parallel, length, min_len, align):
    splits = cuda_build.split_count(parallel, length, min_len, align)
    chunk = -(-length // splits)
    chunk = -(-chunk // align) * align
    assert splits >= 1 and chunk * (splits - 1) < length <= chunk * splits
    assert splits == 1 or chunk >= min(min_len, length)
    assert parallel * splits <= max(parallel, 2 * cuda_build.TARGET_BLOCKS)


@pytest.mark.parametrize("b,hw,c,heads", [(64, 64, 96, 3), (16, 16, 384, 12), (4, 8, 768, 24),
                                          (2, 16, 64, 2)])
def test_backward_grid_plans_cover_the_vg_shapes(monkeypatch, b, hw, c, heads):
    """The backward kernels' plans at VG shapes, the tiles from a stub of the
    H100 library: the reductions beside the GEMMs, the backward window
    core's blocks, the token split of the weight gradients (whole 64-token
    boxes, none empty) and the MLP's fused or chained plan."""
    h100_tiles.install(monkeypatch)
    plan = sw.attn_bwd_splits(b, hw, hw, c, heads, 8)
    n_windows, m = b * (hw // 8) ** 2, b * hw * hw
    assert 1 <= plan["rows"] <= -(-hw * hw // 8)
    assert all(v >= 1 for v in plan.values())
    wpb = sw.window_core_plan(n_windows, heads, 1, cuda_build.blocks_per_sm(
        "dsg_swin_attn_bwd_core_per_sm", 64))
    assert 1 <= sw.core_blocks(n_windows, 1, wpb) <= n_windows
    for gemm in (sw.attn_bwd_gemm_plan(m, c), mk.mlp_bwd_plan(m, c, 4 * c)):
        splits, chunk = gemm["w"], gemm["kchunk"]
        assert splits >= 1 and chunk % 64 == 0 and chunk * (splits - 1) < m <= chunk * splits
    mlp = mk.mlp_bwd_plan(m, c, 4 * c)
    assert mlp["fused"] == (c in (96, 192))
    assert mlp["fused"] or 1 <= mlp["ln"] <= cuda_build.TARGET_BLOCKS
