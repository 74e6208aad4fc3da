"""Each hand-written CUDA kernel, forward and backward, against its plain
PyTorch version on the card.

These need an NVIDIA GPU with nvcc (sm_90a); without one every test skips
from the ``cuda`` fixture, and counts nothing.  Run them on the card with
``python -m pytest tests/test_torch_cuda_kernels.py``.  Inputs are bf16 at
small shapes the kernels cover (window 8, head_dim 32); the tolerance is
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
    before = cuda_build.launches_by_kernel().get(name, 0)
    out = kern(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert cuda_build.launches_by_kernel()[name] == before + 1
    assert out.shape == ref.shape and out.dtype == ref.dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hw,heads,shift", [(16, 2, 0), (16, 2, 4), (8, 3, 0)])
def test_swin_attn_kernel(cuda, hw, heads, shift):
    torch.manual_seed(hw + shift)
    c = 32 * heads
    mask = (torch.from_numpy(shifted_window_attn_mask(hw, hw, 8, shift)).to(cuda)
            if shift else None)
    _check("swin_attn", sw.swin_attn, sw.swin_attn_block_plain,
           _rnd(cuda, 2, hw, hw, c), _rnd(cuda, 2, 2 * c, scale=0.5), _vec(cuda, c, 1.0),
           _vec(cuda, c), _lin(cuda, 3 * c, c), _vec(cuda, 3 * c), _lin(cuda, c, c),
           _vec(cuda, c), _rnd(cuda, heads, 64, 64, dtype=torch.float32), mask, heads, 8, shift)


@pytest.mark.parametrize("c", [64, 96])
def test_token_mlp_kernel(cuda, c):
    torch.manual_seed(c)
    _check("token_mlp", mk.token_mlp, mk.mlp_block_plain, _rnd(cuda, 2, 100, c),
           _vec(cuda, c, 1.0), _vec(cuda, c), _lin(cuda, 4 * c, c), _vec(cuda, 4 * c),
           _lin(cuda, c, 4 * c), _vec(cuda, c))


def test_patch_merge_kernel(cuda):
    torch.manual_seed(1)
    c = 48
    _check("patch_merge", pr.patch_merge, pr.patch_merge_plain, _rnd(cuda, 2, 16, 16, c),
           _vec(cuda, 4 * c, 1.0), _vec(cuda, 4 * c), _lin(cuda, 2 * c, 4 * c))


@pytest.mark.parametrize("with_skip", [True, False])
def test_patch_breakup_kernel(cuda, with_skip):
    torch.manual_seed(2)
    cout, dim = 32, 128
    c1 = dim // 2 if with_skip else dim
    skip = _rnd(cuda, 2, 8, 8, dim - c1) if with_skip else None
    _check("patch_breakup", pr.patch_breakup, pr.patch_breakup_plain, _rnd(cuda, 2, 8, 8, c1),
           skip, _lin(cuda, dim, dim), _vec(cuda, dim, 1.0), _vec(cuda, dim),
           _vec(cuda, cout, 1.0), _vec(cuda, cout), _lin(cuda, cout, cout))


@pytest.mark.parametrize("n_out", [1, 5, 16])
def test_readout_kernel(cuda, n_out):
    torch.manual_seed(n_out)
    _check("readout", rk.readout_mlp, rk.readout_mlp_plain, _rnd(cuda, 300, 96),
           _lin(cuda, 96, 96), _vec(cuda, 96), _lin(cuda, n_out, 96), _vec(cuda, n_out))


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
    model = DiffuseSG(dtype=torch.bfloat16, **kw).to(cuda)
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
