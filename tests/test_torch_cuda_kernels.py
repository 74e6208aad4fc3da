"""Each hand-written CUDA kernel, forward and backward, against its plain
PyTorch version on the card.

These need an NVIDIA GPU with nvcc (sm_90a); without one every test skips
from the ``cuda`` fixture, and counts nothing.  Run them on the card with
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py``.  Inputs are bf16 at
small shapes the kernels cover (window 8 and 10, head_dim 32); the tolerance is
bf16's: the two versions round their bf16 intermediates at the same points
but sum in different orders, so an intermediate can land one bf16 ulp apart.
"""
import pytest
import torch

from diffusesg_torch.models.layers import shifted_window_attn_mask
from diffusesg_torch.ops import cuda_build
from diffusesg_torch.ops import mlp_block_kernel as mk
from diffusesg_torch.ops import patch_resample as pr
from diffusesg_torch.ops import readout_kernel as rk
from diffusesg_torch.ops import swin_block_v3 as sw

pytestmark = pytest.mark.gpu

ATOL, RTOL = 3e-2, 2e-2


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.lib()
    return torch.device("cuda", 0)


def _rnd(dev, *shape, scale=1.0, offset=0.0, dtype=torch.bfloat16):
    return (torch.randn(shape, device=dev) * scale + offset).to(dtype)


def _lin(dev, n_out, n_in):
    return _rnd(dev, n_out, n_in, scale=n_in ** -0.5)


def _vec(dev, n, offset=0.0):
    return _rnd(dev, n, scale=0.1, offset=offset, dtype=torch.float32)


def _check(name, kern, plain, *args):
    """``name``: the kernel whose launch counter one call moves by one, or a
    tuple of them for an entry that launches several kernels."""
    names = (name,) if isinstance(name, str) else name
    before = cuda_build.launches_by_kernel()
    out = kern(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    after = cuda_build.launches_by_kernel()
    assert {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)} == {
        k: 1 for k in names}
    assert out.shape == ref.shape and out.dtype == ref.dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=RTOL)


def _bit_equal_again(kern, *args):
    """Two launches on the same inputs give the same bits (no atomics)."""
    assert torch.equal(kern(*args), kern(*args))


# (grid, heads, shift, batch): batch 7 at 64x64 gives the window core a run
# that is not a multiple of its windows per block, batch 23 at 16x16 the same
# within each of the 4 mask classes, batch 1 at 8x8 a single window
@pytest.mark.parametrize("hw,heads,shift,b", [(16, 2, 0, 2), (16, 2, 4, 2), (8, 3, 0, 2),
                                              (64, 3, 0, 7), (16, 12, 4, 23), (8, 3, 0, 1)])
def test_swin_attn_kernel(cuda, hw, heads, shift, b):
    torch.manual_seed(hw + shift)
    c = 32 * heads
    mask = (torch.from_numpy(shifted_window_attn_mask(hw, hw, 8, shift)).to(cuda)
            if shift else None)
    args = (_rnd(cuda, b, hw, hw, c), _rnd(cuda, b, 2 * c, scale=0.5), _vec(cuda, c, 1.0),
            _vec(cuda, c), _lin(cuda, 3 * c, c), _vec(cuda, 3 * c), _lin(cuda, c, c),
            _vec(cuda, c), _rnd(cuda, heads, 64, 64, dtype=torch.float32), mask, heads, 8, shift)
    _check("swin_attn", sw.swin_attn, sw.swin_attn_block_plain, *args)
    _bit_equal_again(sw.swin_attn, *args)


# (C, tokens): no token count is a multiple of the row tile; the smaller
# counts take the hidden-split path (fp32 partials and a closing pass), the
# larger ones fill the card with row tiles alone
@pytest.mark.parametrize("c,m,split", [(64, 200, True), (96, 300, True), (96, 40000, False),
                                       (192, 1000, True), (192, 20000, False),
                                       (384, 520, True), (384, 9000, False),
                                       (768, 100, True), (768, 5000, False)])
def test_token_mlp_kernel(cuda, c, m, split):
    torch.manual_seed(c)
    plan = mk.mlp_fwd_plan(m, 4 * c, mk.mlp_tile(c), cuda_build.sm_count(cuda))
    assert (plan["splits"] > 1) == split, plan
    args = (_rnd(cuda, m, c), _vec(cuda, c, 1.0), _vec(cuda, c), _lin(cuda, 4 * c, c),
            _vec(cuda, 4 * c), _lin(cuda, c, 4 * c), _vec(cuda, c))
    _check("token_mlp", mk.token_mlp, mk.mlp_block_plain, *args)
    _bit_equal_again(mk.token_mlp, *args)


# patch_merge at a small width and at every VG and COCO stage it runs (batch
# 16: 64x64 C96, 32x32 C192, 16x16 C384 -> K = 1536, 40x40 C96, 20x20 C192),
# and at ragged row counts (not a multiple of the 64- or 128-row tile): one
# launch of the Hopper GEMM with the gather and LayerNorm in its prologue;
# 128-row panels at VG 64x64, 64-row panels where they would split N (COCO
# 40x40) or where K > 384, the one-warpgroup tile at K = 1536
@pytest.mark.parametrize("hw,c,b,rows", [(16, 48, 2, 128), (64, 96, 16, 128), (32, 192, 16, 64),
                                         (16, 384, 16, 64), (40, 96, 16, 64), (20, 192, 16, 64),
                                         (62, 96, 9, 128), (10, 96, 3, 64), (6, 384, 3, 64),
                                         (20, 192, 1, 64)])
def test_patch_merge_kernel(cuda, hw, c, b, rows):
    torch.manual_seed(hw + c + b)
    m = b * (hw // 2) ** 2
    plan = pr.merge_plan(m, c, 2 * c, cuda_build.sm_count(cuda))
    assert pr.merge_tile(c, bool(plan["wide"]))[0] == rows, plan
    args = (_rnd(cuda, b, hw, hw, c), _vec(cuda, 4 * c, 1.0), _vec(cuda, 4 * c),
            _lin(cuda, 2 * c, 4 * c))
    _check("patch_merge", pr.patch_merge, pr.patch_merge_plain, *args)
    _bit_equal_again(pr.patch_merge, *args)


# patch_breakup at a small width and at the five stages of both models, with
# and without the skip: 4c <= 384 takes the fused path (LayerNorms and
# scatter in the first GEMM's epilogue), 768 and 1536 the split path (fp32
# rows and a row pass)
@pytest.mark.parametrize("hw,cin,cout,fused", [(8, 128, 32, True), (8, 1536, 384, False),
                                               (16, 768, 192, False), (32, 384, 96, True),
                                               (10, 768, 192, False), (20, 384, 96, True)])
@pytest.mark.parametrize("with_skip", [True, False])
def test_patch_breakup_kernel(cuda, hw, cin, cout, fused, with_skip):
    torch.manual_seed(hw + cin)
    dim = 4 * cout
    assert bool(pr.breakup_tile(cin, dim, "in")[3]) == fused
    c1 = cin // 2 if with_skip else cin
    skip = _rnd(cuda, 2, hw, hw, cin - c1) if with_skip else None
    args = (_rnd(cuda, 2, hw, hw, c1), skip, _lin(cuda, dim, cin), _vec(cuda, dim, 1.0),
            _vec(cuda, dim), _vec(cuda, cout, 1.0), _vec(cuda, cout), _lin(cuda, cout, cout))
    _check("patch_breakup", pr.patch_breakup, pr.patch_breakup_plain, *args)
    _bit_equal_again(pr.patch_breakup, *args)


# readout at the model's row counts (batch 16: the VG and COCO adjacency
# heads over B N N tokens, the node heads over B N) and ragged ones (300 rows:
# tiles split unevenly across the persistent grid's warpgroups; 1 row)
@pytest.mark.parametrize("m,n_out", [(16 * 64 * 64, 1), (16 * 64, 5), (16 * 40 * 40, 1),
                                     (16 * 40, 5), (300, 1), (300, 5), (300, 16), (1, 16)])
def test_readout_kernel(cuda, m, n_out):
    torch.manual_seed(n_out + m)
    args = (_rnd(cuda, m, 96), _lin(cuda, 96, 96), _vec(cuda, 96), _lin(cuda, n_out, 96),
            _vec(cuda, n_out))
    _check("readout", rk.readout_mlp, rk.readout_mlp_plain, *args)
    _bit_equal_again(rk.readout_mlp, *args)


def test_small_config_runs_its_plain_versions_on_the_card(cuda):
    """configs/vg_small_test.yaml switches the kernels off (float32, head_dim
    16): its denoiser runs the plain versions on the card, launches no
    kernel, and agrees with the same model on the CPU."""
    from diffusesg_torch.config import load_config
    from diffusesg_torch.models import make_model
    cfg = load_config("configs/vg_small_test.yaml")
    ref = make_model(cfg).eval()
    torch.manual_seed(0)
    for p in ref.parameters():
        torch.nn.init.normal_(p, std=0.15)
    model = make_model(cfg).eval().to(cuda)
    model.load_state_dict(ref.state_dict())
    n = cfg.dataset.max_node_num
    flags = torch.ones(2, n, dtype=torch.bool)
    flags[1, 7:] = False
    x = (torch.randn(2, n, n), torch.randn(2, n, 5), flags, torch.tensor([0.1, -0.3]),
         torch.randn(2, n, n), torch.randn(2, n, 5))
    before = dict(cuda_build.LAUNCHES)
    with torch.no_grad():
        got = model(*(t.to(cuda) for t in x))
        want = ref(*x)
    torch.cuda.synchronize()
    assert dict(cuda_build.LAUNCHES) == before
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert float((g.cpu() - w).norm() / w.norm()) < 1e-4


def test_inpainted_sample_pins_known_entries_on_the_card(cuda):
    """The full-width VG model (kernels on, bf16) samples with inpainting on
    the card: every forward kernel launches, and the known entries of the
    output are the ground truth exactly."""
    from diffusesg_torch.config import load_config
    from diffusesg_torch.models import build_model
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.sampling.orchestrator import inpaint_masks
    from diffusesg_torch.serving.generate import make_denoiser
    cfg = load_config("configs/edm_diffuse_sg_regular_visual_genome.yaml")
    with cfg.unlocked():
        cfg.mcmc.num_steps = 4
    model = build_model(cfg, device=cuda, seed=0)
    assert model.use_kernels
    n = cfg.dataset.max_node_num
    counts = torch.tensor([64, 40, 12, 5])
    flags = torch.arange(n)[None, :] < counts[:, None]
    mask_a, known = (torch.from_numpy(m).to(cuda) for m in inpaint_masks(flags.numpy(), 0.5))
    gen = torch.Generator().manual_seed(3)
    gt_a = (torch.rand(4, n, n, generator=gen) * 2 - 1).to(cuda)
    gt_x = (torch.rand(4, n, 5, generator=gen) * 2 - 1).to(cuda)
    flags = flags.to(cuda)
    before = cuda_build.launches_by_kernel()
    adjs, nodes = get_mc_sampler(cfg).sample(
        make_denoiser(model, cfg, flags), flags, 5, 1, seed=1,
        inpaint=dict(gt_adjs=gt_a, gt_nodes=gt_x, mask_adjs=mask_a, mask_nodes=known))
    torch.cuda.synchronize()
    after = cuda_build.launches_by_kernel()
    assert all(after.get(k, 0) > before.get(k, 0)
               for k in ("swin_attn", "token_mlp", "patch_merge", "patch_breakup", "readout"))
    pair = mask_a & flags[:, :, None] & flags[:, None, :]
    assert torch.equal(adjs[pair], gt_a[pair]) and torch.equal(nodes[known], gt_x[known])
    unknown = flags & ~known
    assert torch.isfinite(nodes).all() and not torch.equal(nodes[unknown], gt_x[unknown])


# The backward kernels' outputs are gradients: sums over tokens whose scale
# grows with the token count, so each is compared relative to its tensor:
# 2e-2 of the element (a bf16 ulp is 2^-8) plus 1e-2 of the tensor's max.
def _check_grads(name, kern, plain, *args):
    before = cuda_build.launches_by_kernel().get(name, 0)
    outs = kern(*args)
    refs = plain(*args)
    torch.cuda.synchronize()
    assert cuda_build.launches_by_kernel()[name] == before + 1
    assert len(outs) == len(refs)
    for i, (out, ref) in enumerate(zip(outs, refs)):
        assert out.shape == ref.shape and out.dtype == ref.dtype, i
        o, r = out.float(), ref.float()
        tol = 2e-2 * r.abs() + 1e-2 * r.abs().max()
        assert bool(((o - r).abs() <= tol).all()), (name, i, float((o - r).abs().max()))


@pytest.mark.parametrize("hw,heads,shift", [(64, 3, 0), (32, 6, 0), (16, 12, 0), (16, 12, 4),
                                            (8, 24, 0)])
def test_swin_attn_bwd_kernel(cuda, hw, heads, shift):
    torch.manual_seed(hw + shift)
    c, b = 32 * heads, 2
    mask = (torch.from_numpy(shifted_window_attn_mask(hw, hw, 8, shift)).to(cuda)
            if shift else None)
    _check_grads("swin_attn_bwd", sw.swin_attn_bwd, sw.swin_attn_bwd_plain,
                 _rnd(cuda, b, hw, hw, c), _rnd(cuda, b, 2 * c, scale=0.5),
                 _rnd(cuda, b, hw, hw, c), _vec(cuda, c, 1.0), _vec(cuda, c),
                 _lin(cuda, 3 * c, c), _vec(cuda, 3 * c), _lin(cuda, c, c),
                 _rnd(cuda, heads, 64, 64, dtype=torch.float32), mask, heads, 8, shift)


@pytest.mark.parametrize("c,m", [(96, 8192), (192, 2048), (384, 520), (768, 128)])
def test_token_mlp_bwd_kernel(cuda, c, m):
    torch.manual_seed(c)
    _check_grads("token_mlp_bwd", mk.token_mlp_bwd, mk.mlp_bwd_plain, _rnd(cuda, m, c),
                 _rnd(cuda, m, c), _vec(cuda, c, 1.0), _vec(cuda, c), _lin(cuda, 4 * c, c),
                 _vec(cuda, 4 * c), _lin(cuda, c, 4 * c))


# token_mlp_bwd at every VG and COCO width and token count of batch 1 (the
# fused row tile at C96 and C192, the chain at C384 and C768, K7), and
# ragged token counts: not a multiple of the fused tile's 128 rows, nor of
# the GEMMs' 64 or 128, nor of the weight gradients' 64-token boxes
MLP_BWD_SHAPES = [(96, 4096), (192, 1024), (384, 256), (768, 64), (96, 1600), (192, 400),
                  (384, 100), (96, 1000), (192, 300), (96, 33), (768, 100), (384, 4500)]


@pytest.mark.parametrize("c,m", MLP_BWD_SHAPES)
def test_token_mlp_bwd_kernel_model_shapes(cuda, c, m):
    torch.manual_seed(c + m)
    args = (_rnd(cuda, m, c), _rnd(cuda, m, c), _vec(cuda, c, 1.0), _vec(cuda, c),
            _lin(cuda, 4 * c, c), _vec(cuda, 4 * c), _lin(cuda, c, 4 * c))
    _check_grads("token_mlp_bwd", mk.token_mlp_bwd, mk.mlp_bwd_plain, *args)
    again = mk.token_mlp_bwd(*args)
    assert all(torch.equal(x, y) for x, y in zip(again, mk.token_mlp_bwd(*args)))


def test_backward_through_a_two_stage_model_runs_the_backward_kernels(cuda):
    """One ``backward()`` of a two-stage bf16 model: every parameter gets a
    finite gradient within 1e-1 relative L2 of the fp32 plain model's on the
    CPU (the backward rounds dy, du and dqkv to bf16 on top of the forward's
    roundings), and the two backward kernels run once per block."""
    from diffusesg_torch.models.diffusesg import DiffuseSG
    kw = dict(img_size=16, in_chans=11, embed_dim=96, depths=(2, 1), num_heads=(3, 6),
              window_size=8, out_chans_adj=1, out_chans_node=5, self_condition=False,
              symmetric_noise=False)
    torch.manual_seed(0)
    ref = DiffuseSG(dtype=torch.float32, **kw)
    for p in ref.parameters():
        torch.nn.init.normal_(p, std=0.1)
    model = DiffuseSG(dtype=torch.bfloat16, use_kernels=True, **kw).to(cuda)
    model.load_state_dict(ref.state_dict())
    adj, node = torch.randn(2, 16, 16), torch.randn(2, 16, 5)
    flags = torch.ones(2, 16, dtype=torch.bool)
    flags[1, 9:] = False
    t = torch.tensor([0.1, -0.3])

    def grads(m, dev):
        a, x = m(adj.to(dev), node.to(dev), flags.to(dev), t.to(dev))
        return torch.autograd.grad((a ** 2).mean() + (x ** 2).mean(), list(m.parameters()))

    cuda_build.reset_launches()
    got = grads(model, cuda)
    torch.cuda.synchronize()
    counts = cuda_build.launches_by_kernel()
    assert counts["swin_attn_bwd"] == counts["token_mlp_bwd"] == 6  # blocks: 2+1 down, 1+2 up
    want = grads(ref, "cpu")
    num = sum(float((g.float().cpu() - w).norm()) ** 2 for g, w in zip(got, want))
    den = sum(float(w.norm()) ** 2 for w in want)
    assert all(torch.isfinite(g).all() for g in got)
    assert (num / den) ** 0.5 < 1e-1


# ------------------------------------------------ window 10 (L = 100 padded to 112)

def _attn_args(dev, b, hw, heads, window, shift):
    c, L = 32 * heads, window * window
    mask = (torch.from_numpy(shifted_window_attn_mask(hw, hw, window, shift)).to(dev)
            if shift else None)
    return (_rnd(dev, b, hw, hw, c), _rnd(dev, b, 2 * c, scale=0.5), _vec(dev, c, 1.0),
            _vec(dev, c), _lin(dev, 3 * c, c), _vec(dev, 3 * c), _lin(dev, c, c), _vec(dev, c),
            _rnd(dev, heads, L, L, dtype=torch.float32), mask)


COCO_SHAPES = [(40, 3, 0), (20, 6, 0), (20, 6, 5), (10, 12, 0)]


@pytest.mark.parametrize("hw,heads,shift", COCO_SHAPES)
# an odd batch too: no shape leaves the kernel; batch 16 gives the window core
# runs that are not a multiple of its windows per block (at 40x40)
@pytest.mark.parametrize("b", [2, 3, 16])
def test_swin_attn_kernel_window_10(cuda, hw, heads, shift, b):
    torch.manual_seed(hw + shift)
    args = _attn_args(cuda, b, hw, heads, 10, shift)
    _check("swin_attn", sw.swin_attn, sw.swin_attn_block_plain, *args, heads, 10, shift)
    _bit_equal_again(sw.swin_attn, *args, heads, 10, shift)


def test_swin_attn_window_10_with_a_fully_masked_row_is_finite(cuda):
    torch.manual_seed(3)
    args = list(_attn_args(cuda, 2, 20, 6, 10, 5))
    args[9] = args[9].clone()
    args[9][:, 7, :] = -100.0
    out = sw.swin_attn(*args, 6, 10, 5)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), sw.swin_attn_block_plain(*args, 6, 10, 5).float(),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hw,heads,shift", COCO_SHAPES)
@pytest.mark.parametrize("b", [1, 4])  # b = 1 at 10x10: one window, one core block per head
def test_swin_attn_bwd_kernel_window_10(cuda, hw, heads, shift, b):
    torch.manual_seed(hw + shift)
    a = _attn_args(cuda, b, hw, heads, 10, shift)
    bargs = a[:2] + (_rnd(cuda, b, hw, hw, 32 * heads),) + a[2:7] + a[8:]
    _check_grads("swin_attn_bwd", sw.swin_attn_bwd, sw.swin_attn_bwd_plain, *bargs, heads, 10,
                 shift)
    again = sw.swin_attn_bwd(*bargs, heads, 10, shift)
    assert all(torch.equal(x, y) for x, y in zip(again, sw.swin_attn_bwd(*bargs, heads, 10, shift)))


# Every VG and COCO stage of swin_attn at ragged token counts (batch 1 and 3):
# the qkv and proj GEMMs (csrc/hopper_gemm.cuh) at each C, window 8 and 10,
# shift on and off; at these few rows C384 and C768 take 64-row panels, and
# at C768 the plan splits N across blocks, each redoing its rows' prologue.
MODEL_ATTN_SHAPES = [(64, 3, 8, 0), (32, 6, 8, 0), (16, 12, 8, 0), (16, 12, 8, 4), (8, 24, 8, 0),
                     (40, 3, 10, 0), (20, 6, 10, 0), (20, 6, 10, 5), (10, 12, 10, 0)]


@pytest.mark.parametrize("hw,heads,window,shift", MODEL_ATTN_SHAPES)
@pytest.mark.parametrize("b", [1, 3])
def test_swin_attn_bwd_kernel_model_shapes(cuda, hw, heads, window, shift, b):
    """swin_attn_bwd at every VG and COCO stage, batch 1 and 3 (COCO's token
    counts are ragged: 100, 300, 1200, 4800 rows), bit-equal between two
    launches."""
    torch.manual_seed(hw + heads + b + 1)
    c = 32 * heads
    a = _attn_args(cuda, b, hw, heads, window, shift)
    bargs = a[:2] + (_rnd(cuda, b, hw, hw, c),) + a[2:7] + a[8:]
    _check_grads("swin_attn_bwd", sw.swin_attn_bwd, sw.swin_attn_bwd_plain, *bargs, heads,
                 window, shift)
    again = sw.swin_attn_bwd(*bargs, heads, window, shift)
    assert all(torch.equal(x, y)
               for x, y in zip(again, sw.swin_attn_bwd(*bargs, heads, window, shift)))


@pytest.mark.parametrize("hw,heads,window,shift", MODEL_ATTN_SHAPES)
@pytest.mark.parametrize("b", [1, 3])
def test_swin_attn_kernel_model_shapes(cuda, hw, heads, window, shift, b):
    torch.manual_seed(hw + heads + b)
    c, m = 32 * heads, b * hw * hw
    plan = sw.attn_gemm_plan(m, c, cuda_build.sm_count(cuda))
    assert plan["wide"] or c < 384, plan
    if c == 768:
        assert plan["qkv"] < -(-3 * c // sw.attn_gemm_tile(c, "qkv", True)[1]), plan
    args = _attn_args(cuda, b, hw, heads, window, shift)
    _check("swin_attn", sw.swin_attn, sw.swin_attn_block_plain, *args, heads, window, shift)
    _bit_equal_again(sw.swin_attn, *args, heads, window, shift)


def test_an_uncovered_window_raises_on_the_card(cuda):
    args = list(_attn_args(cuda, 1, 14, 2, 7, 0))
    with pytest.raises(ValueError, match="swin_attn covers windows"):
        sw.swin_attn(*args, 2, 7, 0)


# --------------------------------------------- the kernels with an entry of their own

# nwb 1000 and 100 give the window core runs that are not a multiple of its
# windows per block (the latter within each of 4 mask classes); nwb 1 is one
# window, with and without a mask of one class
@pytest.mark.parametrize("nwb,nh,L,nw,scale", [(8, 3, 64, 0, 32 ** -0.5), (8, 12, 64, 4, 0.3),
                                               (16, 3, 100, 0, 0.25), (8, 6, 100, 4, 32 ** -0.5),
                                               (1000, 3, 64, 0, 32 ** -0.5), (100, 6, 100, 4, 0.3),
                                               (1, 3, 64, 0, 0.25), (1, 2, 100, 1, 32 ** -0.5)])
def test_window_attention_kernel(cuda, nwb, nh, L, nw, scale):
    from diffusesg_torch.ops import window_attention as wa
    torch.manual_seed(L + nw)
    q, k, v = (_rnd(cuda, nwb, nh, L, 32) for _ in range(3))
    rel = _rnd(cuda, nh, L, L, dtype=torch.float32)
    mask = None
    if nw:
        mask = torch.where(torch.rand(nw, L, L, device=cuda) < 0.2, -100.0, 0.0)
        mask[0, 5, :] = -100.0
    _check("window_attention", wa.fused_window_attention_qkhd, wa.attention_plain, q, k, v, rel,
           mask, scale)
    _bit_equal_again(wa.fused_window_attention_qkhd, q, k, v, rel, mask, scale)
    # the backward differentiates the plain version, on the card
    leaves = [t.clone().requires_grad_() for t in (q, k, v, rel)]
    out = wa.fused_window_attention_qkhd(*leaves, mask, scale)
    grads = torch.autograd.grad(out.float().sum(), leaves)
    assert all(torch.isfinite(g).all() and g.shape == t.shape for g, t in zip(grads, leaves))
    with pytest.raises(ValueError, match="window_attention covers"):
        wa.fused_window_attention_qkhd(q[..., :16], k[..., :16], v[..., :16], rel, mask, scale)


@pytest.mark.parametrize("hw,heads,window", [(16, 2, 8), (20, 2, 10)])
def test_pre_rolled_block_entries(cuda, hw, heads, window):
    from diffusesg_torch.ops import swin_block_kernel as sk
    from diffusesg_torch.ops import swin_full_block as sf
    torch.manual_seed(hw)
    c, shift = 32 * heads, window // 2
    a = _attn_args(cuda, 2, hw, heads, window, shift)
    mlp = (_vec(cuda, c, 1.0), _vec(cuda, c), _lin(cuda, 4 * c, c), _vec(cuda, 4 * c),
           _lin(cuda, c, 4 * c), _vec(cuda, c))
    # the entries own no device function: they launch swin_attn (and token_mlp)
    _check("swin_attn", sk.fused_swin_attn_block, sk.swin_attn_block_plain, *a, heads, window)
    _check(("swin_attn", "token_mlp"), sf.fused_swin_block, sf.swin_block_plain, *a, *mlp, heads,
           window)
    # the same device code as the model's block with the roll folded in: bit-equal
    rolled = torch.roll(a[0], (-shift, -shift), dims=(1, 2))
    got = torch.roll(sf.fused_swin_block(rolled, *a[1:], *mlp, heads, window), (shift, shift),
                     dims=(1, 2))
    assert torch.equal(got, sw.fused_swin_block(*a, *mlp, heads, window, shift))
    # and they differentiate through the backward kernels
    x = a[0].clone().requires_grad_()
    before = cuda_build.launches_by_kernel()
    sf.fused_swin_block(x, *a[1:], *mlp, heads, window).float().sum().backward()
    after = cuda_build.launches_by_kernel()
    assert torch.isfinite(x.grad).all()
    assert all(after[k] == before.get(k, 0) + 1 for k in ("swin_attn_bwd", "token_mlp_bwd"))


@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (128, 96, 48), (1024, 96, 288)])
def test_mm_accumulate_kernel(cuda, m, k, n):
    from diffusesg_torch.ops import mm_microbench as mm
    torch.manual_seed(m + n)
    a8 = torch.randint(-127, 127, (m, k), device=cuda, dtype=torch.int8)
    b8 = torch.randint(-127, 127, (k, n), device=cuda, dtype=torch.int8)
    got = mm.mm_accumulate(a8, b8, 64)
    assert got.dtype == torch.int32 and torch.equal(got, mm.mm_accumulate_plain(a8, b8, 64))
    a, b = _rnd(cuda, m, k), _rnd(cuda, k, n)
    got, ref = mm.mm_accumulate(a, b, 64), mm.mm_accumulate_plain(a, b, 64)
    assert got.dtype == torch.float32
    assert float((got - ref).abs().max()) <= 1e-3 * float(ref.abs().max())
    with pytest.raises(ValueError, match="mm_accumulate takes"):
        mm.mm_accumulate(a[:, :24].contiguous(), b[:24].contiguous(), 64)
