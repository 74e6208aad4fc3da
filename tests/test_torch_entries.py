"""The port's four stand-alone kernel entries (plain versions, CPU) vs the
JAX package: window attention (``fused_window_attention_qkhd``), the
attention half and the whole Swin block on a pre-rolled grid
(``fused_swin_attn_block``, ``fused_swin_block``) and the accumulated matrix
product of the int8 micro-benchmark (``mm_accumulate``).

fp32 inputs from a numpy seed go through both packages.  The JAX side runs
its XLA composition and the Pallas kernel itself in interpret mode, switched
on as the JAX package's own tests switch it on (the module flag
``INTERPRET``).  Tolerances are stated per test.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from diffusesg_tpu.models import layers as jlayers
from diffusesg_tpu.ops import mlp_block_kernel as jmlp
from diffusesg_tpu.ops import swin_block_kernel as jswin
from diffusesg_tpu.ops import swin_full_block as jfull
from diffusesg_tpu.ops import window_attention as jwa
from diffusesg_torch.models import layers as tlayers
from diffusesg_torch.ops import mm_microbench as mm
from diffusesg_torch.ops import swin_block_kernel as sk
from diffusesg_torch.ops import swin_full_block as sf
from diffusesg_torch.ops import window_attention as wa
from diffusesg_torch.utils import weights as tweights


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


class _interpret:
    """Run the Pallas kernels of the given JAX modules in interpret mode."""

    def __init__(self, *modules):
        self.modules = modules

    def __enter__(self):
        for m in self.modules:
            m.INTERPRET = True

    def __exit__(self, *exc):
        for m in self.modules:
            m.INTERPRET = False


# ----------------------------------------------------------- window attention

def _attention_inputs(nwb, nh, L, hd, nw, seed):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(nwb, nh, L, hd).astype(np.float32) for _ in range(3))
    rel = (rs.randn(nh, L, L) * 0.1).astype(np.float32)
    mask = None
    if nw:
        mask = rs.choice([0.0, -100.0], size=(nw, L, L), p=[0.8, 0.2]).astype(np.float32)
        mask[0, 3, :] = -100.0  # a row that is masked everywhere: softmax of equal scores
    return q, k, v, rel, mask


ATTENTION_SHAPES = [(8, 3, 64, 32, 4), (4, 2, 100, 32, 4), (16, 3, 16, 16, 8)]


@pytest.mark.parametrize("nwb,nh,L,hd,nw", ATTENTION_SHAPES)
@pytest.mark.parametrize("with_mask", [False, True])
def test_window_attention_matches_jax_xla_and_interpreted_kernel(nwb, nh, L, hd, nw, with_mask):
    """atol 2e-5 / rtol 1e-4: the bar of tests/test_window_attention.py."""
    q, k, v, rel, mask = _attention_inputs(nwb, nh, L, hd, nw if with_mask else 0, seed=L + hd)
    scale = 0.3 if L == 100 else hd ** -0.5
    jargs = [jnp.asarray(a) for a in (q, k, v, rel)] + [None if mask is None else
                                                        jnp.asarray(mask)]
    want_xla = jwa._attention_xla(*jargs, scale)
    with _interpret(jwa):
        want_kernel = jwa.fused_window_attention_qkhd(*jargs, scale)
    got = wa.fused_window_attention_qkhd(_t(q), _t(k), _t(v), _t(rel),
                                         None if mask is None else _t(mask), scale)
    assert got.shape == (nwb, nh, L, hd) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), atol=2e-5, rtol=1e-4)
    assert torch.equal(got, wa.attention_plain(_t(q), _t(k), _t(v), _t(rel),
                                               None if mask is None else _t(mask), scale))


def test_window_attention_trims_surplus_masks():
    q, k, v, rel, mask = _attention_inputs(2, 2, 16, 16, 4, seed=0)
    got = wa.fused_window_attention_qkhd(_t(q), _t(k), _t(v), _t(rel), _t(mask), 0.25)
    want = jwa.fused_window_attention_qkhd(*(jnp.asarray(a) for a in (q, k, v, rel, mask)), 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("nwb,nh,L,hd,nw", ATTENTION_SHAPES[1:])
def test_window_attention_gradients_match_jax(nwb, nh, L, hd, nw):
    """atol 1e-3 / rtol 1e-3: the bar of tests/test_window_attention.py."""
    q, k, v, rel, mask = _attention_inputs(nwb, nh, L, hd, nw, seed=7)
    scale = hd ** -0.5
    want = jax.grad(lambda *a: jnp.sum(jwa._attention_xla(*a, jnp.asarray(mask), scale) ** 2),
                    argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, rel)))
    leaves = [_t(a).requires_grad_() for a in (q, k, v, rel)]
    out = wa.fused_window_attention_qkhd(*leaves, _t(mask), scale)
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=1e-3)


def test_window_attention_raises_by_name_for_an_uncovered_geometry():
    """Off the CPU the wrapper launches its kernel or raises: no plain
    version stands in (a meta tensor reaches the check without a card)."""
    q = torch.empty(4, 2, 49, 32, device="meta")
    with pytest.raises(ValueError, match="window_attention covers L in"):
        wa.fused_window_attention_qkhd(q, q, q, torch.empty(2, 49, 49, device="meta"))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dim,window,heads,with_mask", [(64, 10, 2, True), (48, 8, 3, False)])
def test_window_attention_module_matches_flax(dim, window, heads, with_mask, use_pallas):
    """The port's ``WindowAttention.forward`` on weights carried across by
    ``utils.weights``; fp32, atol 2e-4 / rtol 1e-3."""
    rs = np.random.RandomState(dim)
    L, nwb = window * window, 8
    x = rs.randn(nwb, L, dim).astype(np.float32)
    mask = (jlayers.shifted_window_attn_mask(2 * window, 2 * window, window, window // 2)
            if with_mask else None)
    jm = jlayers.WindowAttention(dim=dim, window=window, num_heads=heads, use_pallas=use_pallas)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), mask)["params"]
    params = jax.tree.map(lambda p: (rs.randn(*p.shape) * 0.2).astype(np.float32), params)
    with _interpret(jwa):
        want = jm.apply({"params": params}, jnp.asarray(x), mask)

    tm = tlayers.WindowAttention(dim, window, heads)
    tm.load_state_dict(tweights.window_attention_to_state_dict(params), strict=True)
    got = tm(_t(x), mask)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-4, rtol=1e-3)
    back = tweights.window_attention_to_flax(tm.state_dict())
    for key, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(np.asarray(leaf), functools.reduce(
            lambda d, k: d[k.key], key, back))


# ------------------------------------------- the pre-rolled half and whole block

def _block_case(b, h, c, nh, window, shifted, seed=0):
    rs = np.random.RandomState(seed)
    L, hidden = window * window, 4 * c
    f = np.float32
    n = lambda *s, sc=1.0: (rs.randn(*s) * sc).astype(f)  # noqa: E731
    attn = [n(b, h, h, c), n(b, 2 * c, sc=0.1), 1 + n(c, sc=0.1), n(c, sc=0.1),
            n(c, 3 * c, sc=c ** -0.5), n(3 * c, sc=0.01), n(c, c, sc=c ** -0.5), n(c, sc=0.01),
            n(nh, L, L, sc=0.05)]
    mask = jlayers.shifted_window_attn_mask(h, h, window, window // 2) if shifted else None
    mlp = [1 + n(c, sc=0.1), n(c, sc=0.1), n(c, hidden, sc=c ** -0.5), n(hidden, sc=0.01),
           n(hidden, c, sc=hidden ** -0.5), n(c, sc=0.01)]
    return attn, mask, mlp


def _port_args(attn, mask, mlp=()):
    """The port takes Linear weights as [out, in]."""
    t = [_t(a) for a in attn]
    t[4], t[6] = t[4].T.contiguous(), t[6].T.contiguous()
    m = [_t(a) for a in mlp]
    if m:
        m[2], m[4] = m[2].T.contiguous(), m[4].T.contiguous()
    return t + [None if mask is None else _t(mask)] + m


BLOCK_SHAPES = [(2, 16, 64, 2, 8, True), (2, 20, 64, 2, 10, True), (2, 10, 64, 2, 10, False)]


@pytest.mark.parametrize("b,h,c,nh,window,shifted", BLOCK_SHAPES)
def test_swin_attn_block_entry_matches_jax(b, h, c, nh, window, shifted):
    """``fused_swin_attn_block`` on a pre-rolled x vs ``swin_attn_block_xla``
    and vs the Pallas kernel in interpret mode.  Across the two frameworks in
    fp32: atol 2e-4 / rtol 1e-3 (tests/test_fused_block_kernels.py holds the
    kernel to 2e-5 of the XLA path inside one framework)."""
    attn, mask, _ = _block_case(b, h, c, nh, window, shifted, seed=h + window)
    jargs = [jnp.asarray(a) for a in attn] + [None if mask is None else jnp.asarray(mask)]
    want_xla = jswin.swin_attn_block_xla(*jargs, num_heads=nh, window=window)
    with _interpret(jswin):
        want_kernel = jswin.fused_swin_attn_block(*jargs, nh, window)
    got = sk.fused_swin_attn_block(*_port_args(attn, mask), nh, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), atol=2e-4, rtol=1e-3)
    assert torch.equal(got, sk.swin_attn_block_plain(*_port_args(attn, mask), nh, window))


@pytest.mark.parametrize("b,h,c,nh,window,shifted", BLOCK_SHAPES)
def test_swin_full_block_entry_matches_jax(b, h, c, nh, window, shifted):
    """``fused_swin_block`` on a pre-rolled x vs ``swin_block_xla`` with the
    erf GELU (``approximate=False``), fp32, atol 2e-4 / rtol 1e-3; and vs the
    Pallas kernel in interpret mode at rtol 1e-3 / atol 5e-3, the bar of
    tests/test_swin_full_block.py: the TPU kernel's fused MLP uses the tanh
    GELU, the port the exact erf form."""
    attn, mask, mlp = _block_case(b, h, c, nh, window, shifted, seed=h + window + 1)
    jargs = ([jnp.asarray(a) for a in attn] + [None if mask is None else jnp.asarray(mask)]
             + [jnp.asarray(a) for a in mlp])
    want_xla = jfull.swin_block_xla(*jargs, num_heads=nh, window=window, approximate=False)
    with _interpret(jfull, jmlp):
        want_kernel = jfull.fused_swin_block(*jargs, nh, window)
    got = sf.fused_swin_block(*_port_args(attn, mask, mlp), nh, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), atol=5e-3, rtol=1e-3)
    assert torch.equal(got, sf.swin_block_plain(*_port_args(attn, mask, mlp), nh, window))


def test_pre_rolled_entries_differentiate_like_the_jax_vjp():
    """Gradients of the whole-block entry vs ``jax.vjp`` of ``swin_block_xla``
    (erf GELU): rtol 2e-3 + atol 2e-3 * max|ref| per leaf, the bar of
    tests/test_torch_train_ops.py."""
    b, h, c, nh, window = 2, 20, 32, 1, 10
    attn, mask, mlp = _block_case(b, h, c, nh, window, True, seed=3)
    ct = np.random.RandomState(4).randn(b, h, h, c).astype(np.float32)
    jmask = jnp.asarray(mask)

    def fwd(*a):
        return jfull.swin_block_xla(*a[:9], jmask, *a[9:], num_heads=nh, window=window,
                                    approximate=False)
    _, vjp = jax.vjp(fwd, *(jnp.asarray(a) for a in attn + mlp))
    want = vjp(jnp.asarray(ct))
    args = _port_args(attn, mask, mlp)
    leaves = [a.clone().requires_grad_() for a in args[:9] + args[10:]]
    out = sf.fused_swin_block(*leaves[:9], args[9], *leaves[9:], nh, window)
    got = torch.autograd.grad(out, leaves, _t(ct))
    transposed = {4, 6, 11, 13}
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w).T if i in transposed else np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-3, atol=2e-3 * np.abs(w).max(),
                                   err_msg=f"leaf {i}")


# ------------------------------------------------------------- mm_accumulate

def _mm_kernel(a_ref, b_ref, o_ref, *, acc_dtype, repeats):
    """scripts/microbench_int8.py::mm_kernel with its R as an argument (the
    script cannot be imported: it prepends to sys.path and runs on a TPU)."""
    acc0 = jnp.zeros(o_ref.shape, acc_dtype)
    acc1 = jnp.zeros(o_ref.shape, acc_dtype)

    def body(i, accs):
        a0, a1 = accs
        a0 = a0 + jnp.dot(a_ref[:], b_ref[:], preferred_element_type=acc_dtype)
        a1 = a1 + jnp.dot(a_ref[:], b_ref[:], preferred_element_type=acc_dtype)
        return a0, a1

    acc0, acc1 = jax.lax.fori_loop(0, repeats // 2, body, (acc0, acc1))
    o_ref[:] = (acc0 + acc1).astype(o_ref.dtype)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("m,k,n,repeats", [(32, 64, 48, 8), (64, 96, 96, 64)])
def test_mm_accumulate_matches_numpy_and_the_interpreted_kernel(kind, m, k, n, repeats):
    """int32 exact; bf16 within 1e-2 relative of the float64 product."""
    rs = np.random.RandomState(m + n)
    if kind == "int8":
        a, b = (rs.randint(-127, 127, s).astype(np.int8) for s in ((m, k), (k, n)))
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        ja, jb, acc, out_dtype = jnp.asarray(a), jnp.asarray(b), jnp.int32, jnp.int32
        exact = repeats * (a.astype(np.int64) @ b.astype(np.int64))
    else:
        ta, tb = (torch.from_numpy(rs.randn(*s).astype(np.float32)).bfloat16()
                  for s in ((m, k), (k, n)))
        ja, jb = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (ta, tb))
        acc, out_dtype = jnp.float32, jnp.float32
        exact = repeats * (ta.double().numpy() @ tb.double().numpy())
    got = mm.mm_accumulate(ta, tb, repeats)
    kernel = pl.pallas_call(
        functools.partial(_mm_kernel, acc_dtype=acc, repeats=repeats),
        out_shape=jax.ShapeDtypeStruct((m, n), out_dtype), interpret=True)(ja, jb)
    if kind == "int8":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), exact)
        np.testing.assert_array_equal(np.asarray(kernel), exact)
    else:
        assert got.dtype == torch.float32
        scale = np.abs(exact).max()
        assert np.abs(got.numpy() - exact).max() <= 1e-2 * scale
        assert np.abs(got.numpy() - np.asarray(kernel)).max() <= 1e-2 * scale


@pytest.mark.parametrize("m,k,n", mm.SHAPES)
def test_mm_grid_is_a_multiple_of_the_sm_count(m, k, n):
    tiles, copies = mm.grid_plan(m, n, 132)
    assert tiles == -(-m // mm.TILE) * -(-n // mm.TILE) and (tiles * copies) % 132 == 0
    assert all((tiles * c) % 132 for c in range(1, copies))
    assert mm.operations(m, k, n, 64, copies) == 2 * m * k * n * 64 * copies
    # exact in int32 at the benchmark's own sizes: |sum| <= 127 * 127 * k * 64
    assert 127 * 127 * k * 64 < 2 ** 31
