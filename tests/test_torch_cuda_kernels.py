"""Each hand-written CUDA kernel, forward and backward, against its plain
PyTorch version on the card.

These need an NVIDIA GPU with nvcc (sm_90a); without one every test skips
from the ``cuda`` fixture, and counts nothing.  Run them on the card with
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py``.  Inputs are bf16 at
small shapes the kernels cover (window 8 and 10, head_dim 32); the tolerance is
bf16's: the two versions round their bf16 intermediates at the same points
but sum in different orders, so an intermediate can land one bf16 ulp apart.
"""
import collections

import pytest
import torch

from diffusesg_torch.models.layers import shifted_window_attn_mask
from diffusesg_torch.ops import cuda_build
from diffusesg_torch.ops import mlp_block_kernel as mk
from diffusesg_torch.ops import patch_embed as pe
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
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        assert o.shape == r.shape and o.dtype == r.dtype
        torch.testing.assert_close(o.float(), r.float(), atol=ATOL, rtol=RTOL)


def _bit_equal_again(kern, *args):
    """Two launches on the same inputs give the same bits (no atomics)."""
    a, b = kern(*args), kern(*args)
    assert all(torch.equal(x, y) for x, y in zip(*((a, b) if isinstance(a, tuple)
                                                    else ((a,), (b,)))))


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


# (C, tokens): the ragged counts are no multiple of the row tile; `split`:
# tiles are cut between blocks (fp32 partials and a closing pass), where
# whole tiles would leave the card idle and the cut costs less
# (mlp_fwd_plan); else every block takes a whole tile.  Then the benchmark's
# shapes: every MLP launch of a VG and a COCO evaluation at batch 64
@pytest.mark.parametrize("c,m,split", [(64, 200, False), (96, 300, True), (96, 40000, False),
                                       (96, 16600, False), (192, 1000, True),
                                       (192, 20000, True), (384, 520, True),
                                       (384, 9000, True), (768, 100, True),
                                       (768, 5000, True), (768, 4022, False),
                                       (64, 540 * 128 - 37, False), (96, 540 * 128 - 37, True),
                                       (192, 540 * 128 - 37, True), (384, 540 * 64 - 37, True),
                                       (768, 270 * 64 - 37, True),
                                       (96, 64 * 4096, False), (192, 64 * 1024, False),
                                       (384, 64 * 256, False), (768, 64 * 64, False),
                                       (96, 64 * 1600, True), (192, 64 * 400, False),
                                       (384, 64 * 100, False)])
def test_token_mlp_kernel(cuda, c, m, split):
    torch.manual_seed(c)
    plan = mk.mlp_fwd_plan(m, 4 * c, mk.mlp_tile(cuda, c), cuda_build.sm_count(cuda))
    assert bool(plan["split"]) == split, plan
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
    plan = pr.merge_plan(m, c, 2 * c, cuda)
    assert pr.merge_tile(cuda, c, bool(plan["wide"]))[0] == rows, plan
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
    assert bool(pr.breakup_tile(cuda, cin, dim, "in")[3]) == fused
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


def _graph_batch(dev, b, n, seed):
    """Node flags of ``b`` graphs on an N grid, the first full, the others
    2..N nodes, and the denoiser's inputs: adj [B, N, N, 1], node [B, N, 5]
    and their self-conditioning tensors."""
    g = torch.Generator().manual_seed(seed)
    counts = torch.randint(2, n + 1, (b,), generator=g)
    counts[0] = n
    flags = (torch.arange(n)[None, :] < counts[:, None]).to(dev)
    t = [torch.randn(s, generator=g).to(dev) for s in ((b, n, n, 1), (b, n, 5))]
    return flags, t[0], t[1], t[0] * 0.5 + 0.1, t[1] * 0.5 - 0.1


# patch_embed at VG's and COCO's grids, batch 16 and 64, and a small ragged
# one (N = 8, 3 graphs: tiles that cross graphs), with the self-conditioning
# channels given, zero (None) and absent, over padded node counts; the
# module's tolerance: both versions round the product, the LayerNorm and each
# step of the affine to bf16 at the same points, so an element lands at most
# an ulp or two apart where the sums' order moves a rounding
@pytest.mark.parametrize("n,b", [(64, 16), (64, 64), (40, 16), (40, 64), (8, 3)])
@pytest.mark.parametrize("sc", ["given", "zeros", "off"])
def test_patch_embed_kernel(cuda, n, b, sc):
    torch.manual_seed(n + b)
    flags, adj, node, sc_a, sc_x = _graph_batch(cuda, b, n, seed=n + b)
    if sc != "given":
        sc_a = sc_x = None
    cin = 11 if sc == "off" else 22
    args = (adj, node, flags, sc_a, sc_x, _lin(cuda, 96, cin), _rnd(cuda, 96, scale=0.1),
            _vec(cuda, 96, 1.0), _vec(cuda, 96), _rnd(cuda, b, 192, scale=0.5), sc != "off")
    _check("patch_embed", pe.patch_embed, pe.patch_embed_plain, *args)
    _bit_equal_again(pe.patch_embed, *args)


# the output head (readout_kernel_head) at VG's and COCO's grids, batch 16
# and 64, and ragged ones (N = 8 and 7: many (b, i) groups a tile, groups cut
# between tiles, a last tile part full), the adjacency head with 1 output and
# with 5; the module's tolerance, as readout's: the same rounding points, and
# the pooling's fp32 sums in another order than torch.mean's
@pytest.mark.parametrize("n,b,n_out", [(64, 16, 1), (64, 64, 1), (40, 16, 1), (40, 64, 1),
                                       (8, 3, 1), (7, 5, 5)])
def test_output_head_kernel(cuda, n, b, n_out):
    torch.manual_seed(n + b)
    flags = _graph_batch(cuda, b, n, seed=n * b)[0]
    args = (_rnd(cuda, b, n, n, 96, scale=2.0, offset=0.5), _vec(cuda, 96, 1.0), _vec(cuda, 96),
            _lin(cuda, 96, 96), _rnd(cuda, 96, scale=0.1), _lin(cuda, 96, 96),
            _rnd(cuda, 96, scale=0.1), _lin(cuda, 96, 96), _rnd(cuda, 96, scale=0.1),
            _lin(cuda, 96, 96), _vec(cuda, 96), _lin(cuda, n_out, 96), _vec(cuda, n_out), flags)
    _check("readout", rk.output_head, rk.output_head_plain, *args)
    _bit_equal_again(rk.output_head, *args)


def test_full_resolution_ends_on_the_sampling_path(cuda):
    """The full-width VG model under inference mode runs its two ends as
    the two kernels (one patch_embed, the head and the node head's readout a
    launch) and no PyTorch LayerNorm; with a gradient recorded it runs the
    composition, whose outputs the kernels' match."""
    from torch.profiler import ProfilerActivity, profile

    from diffusesg_torch.config import load_config
    from diffusesg_torch.models import build_model
    cfg = load_config("configs/edm_diffuse_sg_regular_visual_genome.yaml")
    model = build_model(cfg, device=cuda, seed=0)
    flags, adj, node, sc_a, sc_x = _graph_batch(cuda, 4, 64, seed=1)
    x = (adj[..., 0], node, flags, torch.full((4,), 0.3, device=cuda), sc_a[..., 0], sc_x)
    before = cuda_build.launches_by_kernel()
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = model(*x)
        torch.cuda.synchronize()
    after = cuda_build.launches_by_kernel()
    moved = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    assert moved["patch_embed"] == 1 and moved["readout"] == 2, moved
    names = [e.key for e in prof.key_averages()]
    assert not any("layer_norm" in k for k in names), names
    want = [t.detach() for t in model(*x)]
    for g, w in zip(got, want):
        assert float((g - w).norm() / w.norm()) < 2e-2


def test_forward_kernels_launch_on_every_card_of_the_process(cuda):
    """Each kernel opts in to its shared memory once on each card (the
    attribute holds for one device only), and every launch runs under its
    operands' card: the forward kernels on each card this process sees,
    the first launch on each card included, hold against their plain
    versions there, with card 0 last so that it is not the first one
    current.  Needs two cards."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards in the process")
    for i in list(range(1, n)) + [0]:
        dev = torch.device("cuda", i)
        torch.manual_seed(i)
        c, heads, hw = 96, 3, 16
        mask = torch.from_numpy(shifted_window_attn_mask(hw, hw, 8, 4)).to(dev)
        _check("swin_attn", sw.swin_attn, sw.swin_attn_block_plain,
               _rnd(dev, 2, hw, hw, c), _rnd(dev, 2, 2 * c, scale=0.5), _vec(dev, c, 1.0),
               _vec(dev, c), _lin(dev, 3 * c, c), _vec(dev, 3 * c), _lin(dev, c, c),
               _vec(dev, c), _rnd(dev, heads, 64, 64, dtype=torch.float32), mask, heads, 8, 4)
        _check("token_mlp", mk.token_mlp, mk.mlp_block_plain,
               _rnd(dev, 300, c), _vec(dev, c, 1.0), _vec(dev, c), _lin(dev, 4 * c, c),
               _vec(dev, 4 * c), _lin(dev, c, 4 * c), _vec(dev, c))
        _check("patch_merge", pr.patch_merge, pr.patch_merge_plain,
               _rnd(dev, 2, hw, hw, c), _vec(dev, 4 * c, 1.0), _vec(dev, 4 * c),
               _lin(dev, 2 * c, 4 * c))
        _check("readout", rk.readout_mlp, rk.readout_mlp_plain,
               _rnd(dev, 300, 96), _lin(dev, 96, 96), _vec(dev, 96), _lin(dev, 5, 96),
               _vec(dev, 5))
        assert torch.cuda.current_device() == 0  # the launches left the current card alone


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


def _compiled_against_eager(cfg, model, dev, seed=3):
    """(eager outputs, two compiled calls' outputs, eager launches, compiled
    launches of the two calls) of one sampling on ``dev``."""
    from functools import partial

    from diffusesg_torch.models.channels import resolve_sampling_channels
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.sampling.compiled import CompiledSampler
    from diffusesg_torch.serving.generate import make_denoiser
    sampler, info = get_mc_sampler(cfg), resolve_sampling_channels(cfg)
    n = cfg.dataset.max_node_num
    flags = (torch.arange(n)[None, :] < torch.tensor([n, n // 2, 3, 1])[:, None]).to(dev)
    args = (flags, info["num_node_chan"], info["num_adj_chan"])
    runner = CompiledSampler(sampler)
    with torch.inference_mode():
        before = cuda_build.launches_by_kernel()
        want = sampler.sample(make_denoiser(model, cfg, flags), *args, seed=seed)
        torch.cuda.synchronize(dev)
        mid = cuda_build.launches_by_kernel()
        got = [runner.sample(partial(make_denoiser, model, cfg), *args, seed=seed)
               for _ in range(2)]
        torch.cuda.synchronize(dev)
        after = cuda_build.launches_by_kernel()
    eager = {k: v - before.get(k, 0) for k, v in mid.items() if v != before.get(k, 0)}
    compiled = {k: v - mid.get(k, 0) for k, v in after.items() if v != mid.get(k, 0)}
    return want, got, eager, compiled


@pytest.mark.parametrize("which", ["tiny", "vg"])
def test_compiled_sampler_bit_equal_to_eager_on_the_card(cuda, which):
    """The compiled sampler (sampling/compiled.py: each step a CUDA graph
    replay) against the eager sampler at one seed, bit for bit, a first call
    and an all-replay call: configs/vg_small_test.yaml (kernels off,
    float32: the plain path captured) and the full-width VG model (kernels
    on, bf16); 4 Heun steps with churn; the launches of the two compiled
    calls are twice the eager run's (none for the plain path)."""
    from diffusesg_torch.config import load_config
    from diffusesg_torch.models import build_model
    path = ("configs/vg_small_test.yaml" if which == "tiny"
            else "configs/edm_diffuse_sg_regular_visual_genome.yaml")
    cfg = load_config(path)
    with cfg.unlocked():
        cfg.mcmc.num_steps = 4
    model = build_model(cfg, device=cuda, seed=0).eval()
    assert model.use_kernels == (which == "vg")
    want, got, eager, compiled = _compiled_against_eager(cfg, model, cuda)
    for out in got:
        assert all(torch.equal(g, w) for g, w in zip(out, want))
    assert compiled == {k: 2 * v for k, v in eager.items()}
    assert bool(eager) == (which == "vg")


def test_compiled_sampler_on_every_card(cuda):
    """The full-width VG model on each card of the process, card 0 last:
    the compiled sampler's capture and replays under that card and its
    stream, bit-equal to the eager sampler there; and the compiled
    ``shard_map`` function over cards 0 and 1 bit-equal to the eager one,
    block by block.  Needs two cards."""
    import numpy as np

    from diffusesg_torch.config import load_config
    from diffusesg_torch.models import build_model
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.serving.export import make_sharded_serving_fn
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards in the process")
    cfg = load_config("configs/edm_diffuse_sg_regular_visual_genome.yaml")
    with cfg.unlocked():
        cfg.mcmc.num_steps = 4
    for i in list(range(1, n)) + [0]:
        dev = torch.device("cuda", i)
        model = build_model(cfg, device=dev, seed=0).eval()
        want, got, _, _ = _compiled_against_eager(cfg, model, dev)
        for out in got:
            assert all(torch.equal(g, w) for g, w in zip(out, want))
    devices = [torch.device("cuda", 0), torch.device("cuda", 1)]
    flags = np.ones((8, cfg.dataset.max_node_num), bool)
    flags[4:, 20:] = False
    outs = [make_sharded_serving_fn(model, get_mc_sampler(cfg), cfg, devices, "shard_map",
                                    compiled=c)(5, flags) for c in (True, False)]
    for a, b in zip(*outs):
        assert np.array_equal(a[:4], b[:4]) and np.array_equal(a[4:], b[4:])
    assert torch.cuda.current_device() == 0


@pytest.mark.parametrize("which", ["tiny", "vg"])
def test_compiled_train_step_bit_equal_to_eager_on_the_card(cuda, which):
    """The compiled training step (train/compiled.py: a CUDA graph per
    self-conditioning coin) against the eager step from one state on the
    same draws, 4 steps taking both coins (a replay of each), at batch 8:
    configs/vg_small_test.yaml (kernels off, fp32) and the full-width VG
    model (kernels on, bf16).  Metrics, parameters, gradients, Adam's
    moments and steps and every EMA bit-equal, and the launch counts
    equal."""
    from diffusesg_torch.config import load_config
    from diffusesg_torch.models import build_model
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train import (create_train_state, make_optimizer, make_train_step,
                                       train_step_config_from)
    from diffusesg_torch.train.compiled import CompiledTrainStep
    path = ("configs/vg_small_test.yaml" if which == "tiny"
            else "configs/edm_diffuse_sg_regular_visual_genome.yaml")
    cfg = load_config(path)
    coins = [True, False, True, False]

    class Coins(TorchNoise):
        def bernoulli(self, step, kind, p):
            return coins[step]

    n = cfg.dataset.max_node_num
    gen = torch.Generator().manual_seed(0)
    flags = torch.rand(8, n, generator=gen) < 0.7
    pair = flags[:, :, None] & flags[:, None, :]
    batch = ((torch.rand(8, n, n, generator=gen) * 2 - 1) * pair,
             (torch.rand(8, n, 5, generator=gen) * 2 - 1) * flags[..., None], flags)
    batch = tuple(t.to(cuda) for t in batch)
    opt = make_optimizer(1e-3, 0.5, 2, 1e-2)
    states = [create_train_state(build_model(cfg, device=cuda, seed=0), [0.9, 0.999], opt)
              for _ in range(2)]
    step_cfg = train_step_config_from(cfg)
    eager = make_train_step(states[0].model, step_cfg)
    comp = CompiledTrainStep(make_train_step(states[1].model, step_cfg))
    noises = [Coins(3, cuda), Coins(3, cuda)]
    counts = []
    for _ in range(len(coins)):
        out = []
        for i, step in enumerate((eager, comp)):
            before = cuda_build.launches_by_kernel()
            states[i], m = step(states[i], noises[i], *batch)
            after = cuda_build.launches_by_kernel()
            counts.append({k: v - before.get(k, 0) for k, v in after.items()
                           if v != before.get(k, 0)})
            out.append(m)
        assert all(torch.equal(out[0][k], out[1][k]) for k in out[0])
    torch.cuda.synchronize()
    a, b = states
    assert all(torch.equal(p, q) and torch.equal(p.grad, q.grad)
               for p, q in zip(a.params(), b.params()))
    assert all(torch.equal(x, y) for ea, eb in zip(a.ema_params, b.ema_params)
               for x, y in zip(ea, eb))
    assert all(torch.equal(a.opt.state[p][k], b.opt.state[q][k])
               for p, q in zip(a.params(), b.params()) for k in ("step", "exp_avg", "exp_avg_sq"))
    assert counts[0::2] == counts[1::2] and bool(counts[0]) == (which == "vg")
    (program,) = comp._programs.values()
    assert set(program.graphs) == {"cond", "no_cond"}


@pytest.fixture()
def nccl_world(cuda, monkeypatch):
    """An NCCL process group of one rank in this process, as torchrun's
    variables describe it."""
    import socket

    from diffusesg_torch.parallel.distributed import maybe_initialize_distributed, shutdown
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
                     WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    assert maybe_initialize_distributed("cuda")
    try:
        yield
    finally:
        shutdown()


@pytest.mark.parametrize("mode", ["gspmd", "tp"])
def test_compiled_sharded_step_bit_equal_to_eager_on_the_card(nccl_world, mode):
    """The compiled ``gspmd`` + ZeRO-1 step at world 1 and the compiled
    tensor-parallel step at grid (1, 1), through NCCL, against their eager
    runs from one state on the same draws, 4 steps taking both coins, at
    batch 8 on configs/vg_small_test.yaml (kernels off, fp32): metrics,
    parameters, gradients, the gathered Adam state and EMAs bit-equal; the
    ``gspmd`` test-pass step too.  ``gspmd`` captures the backward per coin
    and the update, tensor parallel one graph per coin (its model-group
    collectives inside)."""
    from diffusesg_torch.config import load_config
    from diffusesg_torch.models import build_model
    from diffusesg_torch.parallel.mesh import current_world, make_grid
    from diffusesg_torch.parallel.sharded_step import (make_sharded_eval_step,
                                                       make_sharded_train_step, shard_train_state)
    from diffusesg_torch.parallel.tp import shard_tp_state
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train import (create_train_state, ema_slice, make_optimizer,
                                       train_step_config_from)
    from diffusesg_torch.train.train_state import whole_emas_and_opt
    cfg = load_config("configs/vg_small_test.yaml")
    coins = [True, False, True, False]

    class Coins(TorchNoise):
        def bernoulli(self, step, kind, p):
            return coins[step]

    n = cfg.dataset.max_node_num
    gen = torch.Generator().manual_seed(0)
    flags = torch.rand(8, n, generator=gen) < 0.7
    pair = flags[:, :, None] & flags[:, None, :]
    batch = ((torch.rand(8, n, n, generator=gen) * 2 - 1) * pair,
             (torch.rand(8, n, 5, generator=gen) * 2 - 1) * flags[..., None], flags)
    batch = tuple(t.to("cuda") for t in batch)
    opt = make_optimizer(1e-3, 0.5, 2, 1e-2)
    step_cfg = train_step_config_from(cfg)
    world = make_grid(1, 1) if mode == "tp" else current_world()
    states, steps, tests = [], [], []
    for compiled in (False, True):
        state = create_train_state(build_model(cfg, device="cuda", seed=0), [0.9, 0.999], opt)
        state = shard_tp_state(state, world) if mode == "tp" else shard_train_state(state, world)
        states.append(state)
        steps.append(make_sharded_train_step(state.model, step_cfg, world, tp=mode == "tp",
                                             compiled=compiled))
        tests.append(make_sharded_eval_step(state.model, step_cfg, world, compiled=compiled))
    noises, test_noises = [Coins(3, "cuda") for _ in range(2)], [Coins(4, "cuda") for _ in range(2)]
    for i in range(len(coins)):
        out = []
        for j in range(2):
            states[j], m = steps[j](states[j], noises[j], *batch)
            if mode == "gspmd":
                m = dict(m, **{f"test/{k}": v for k, v in tests[j](
                    ema_slice(states[j], 0), test_noises[j], i, *batch).items()})
            out.append(m)
        assert all(torch.equal(out[0][k], out[1][k]) for k in out[0])
    torch.cuda.synchronize()
    a, b = states
    assert all(torch.equal(p, q) and torch.equal(p.grad, q.grad)
               for p, q in zip(a.params(), b.params()))
    (ea, oa), (eb, ob) = whole_emas_and_opt(a), whole_emas_and_opt(b)
    assert all(torch.equal(x, y) for xs, ys in zip(ea, eb) for x, y in zip(xs, ys))
    assert all(torch.equal(oa["state"][i][k], ob["state"][i][k])
               for i in oa["state"] for k in ("step", "exp_avg", "exp_avg_sq"))
    (program,) = steps[1]._programs.values()
    assert set(program.graphs) == ({"cond", "no_cond"} if mode == "tp" else
                                   {"backward:cond", "backward:no_cond", "update"})


def test_compiled_tp_step_on_two_cards(cuda, tmp_path):
    """The compiled tensor-parallel step at grid (1, 2), one card a rank
    (tests/helpers/torch_dp_child.py ``card_tp``; NCCL refuses two ranks on
    one card): bit-equal to the eager step over 3 steps taking both coins;
    each graph holds one NCCL kernel node for each collective the eager
    step of its coin issues, as many as that step launches NCCL kernels; a
    coin's first use issues its collectives twice (the eager run and the
    capture), a replay none."""
    import os
    import sys

    import numpy as np
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: NCCL refuses two ranks on one card")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
    from torch_parity import start_ranks, wait_ranks
    wait_ranks(start_ranks(["card_tp", str(tmp_path), "2"], str(tmp_path / "logs")),
               timeout=600)
    for r in range(2):
        got = np.load(tmp_path / f"card_tp_rank{r}.npz")
        assert bool(got["equal"]) and list(got["graphs"]) == ["cond", "no_cond"]
        assert list(got["graph_nccl"]) == list(got["eager_calls"]) == list(got["eager_nccl"])
        assert min(got["graph_nccl"]) > 0
        coins = list(got["coins"])
        first = [coins.index(c) for c in coins]
        want = [2 * got["eager_calls"][0 if c else 1] if first[i] == i else 0
                for i, c in enumerate(coins)]
        assert list(got["compiled_calls"]) == want


@pytest.mark.parametrize("world", [2, 4])
def test_compiled_gspmd_step_on_cards(cuda, tmp_path, world):
    """The compiled ``gspmd`` + ZeRO-1 step at world 2 and 4, one card a
    rank (tests/helpers/torch_dp_child.py ``card_gspmd``), at full VG width
    with the kernels on and a global batch of 64: bit-equal to the eager
    step over 3 steps taking both coins and the test pass (metrics,
    parameters, gradients, the owned Adam moments and EMAs).  Each rank's
    Adam moments and EMAs are its 1/world range of the padded flat buffer,
    and the EMAs gathered for the test pass and for sampling share one
    whole copy.  Prints each rank's device memory by part."""
    import os
    import sys

    import numpy as np
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} cards: NCCL refuses two ranks on one card")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
    from torch_parity import start_ranks, wait_ranks
    wait_ranks(start_ranks(["card_gspmd", str(tmp_path)], str(tmp_path / "logs"), world=world),
               timeout=600)
    for r in range(world):
        got = np.load(tmp_path / f"card_gspmd_rank{r}.npz")
        assert bool(got["equal"])
        assert set(got["graphs"]) == {"backward:cond", "backward:no_cond", "update"}
        params, k = int(got["params_bytes"]), int(got["n_emas"])
        assert params % world == 0  # the buffer padded to a multiple of the world
        assert int(got["adam_bytes"]) == 2 * params // world  # two moments of the range
        assert int(got["emas_bytes"]) == k * params // world
        assert int(got["kept_bytes"]) == params  # one whole copy, whichever EMA was gathered
        print(f"world {world} rank {r}: device memory (MiB) " + ", ".join(
            f"{n} {int(got[f'{n}_bytes']) / 2 ** 20:.1f}" for n in (
                "state", "steady", "peak", "params", "grads", "adam", "emas", "kept", "pools")),
            flush=True)


def test_cpu_checkpoint_restores_on_the_cards_capturable_adam(cuda, tmp_path):
    """A state trained and saved on the CPU (plain Adam) restores into the
    card's capturable Adam: moments, EMAs and steps equal, the step counts
    on the card, the learning rate a device tensor that keeps its identity;
    the card's state then takes compiled and eager steps that agree."""
    import numpy as np

    from diffusesg_torch.config import load_config
    from diffusesg_torch.models import build_model
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train import (create_train_state, make_optimizer, make_train_step,
                                       train_step_config_from)
    from diffusesg_torch.train.compiled import CompiledTrainStep
    from diffusesg_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
    cfg = load_config("configs/vg_small_test.yaml")
    n = cfg.dataset.max_node_num
    flags = torch.ones(4, n, dtype=torch.bool)
    batch = (torch.zeros(4, n, n), torch.zeros(4, n, 5), flags)
    opt = make_optimizer(1e-3, 0.5, 2, 1e-2)
    step_cfg = train_step_config_from(cfg)
    cpu = create_train_state(build_model(cfg, device="cpu", seed=0), [0.9, 0.999], opt)
    make_train_step(cpu.model, step_cfg)(cpu, TorchNoise(1, "cpu"), *batch)
    path = save_checkpoint(str(tmp_path / "cpu"), cpu)
    cards = [create_train_state(build_model(cfg, device=cuda, seed=1), [0.9, 0.999], opt)
             for _ in range(2)]
    lr = cards[0].opt.param_groups[0]["lr"]
    for card in cards:
        restore_checkpoint(path, card)
    group = cards[0].opt.param_groups[0]
    assert group["capturable"] and group["lr"] is lr and float(lr) == np.float32(1e-3)
    for p, q in zip(cpu.params(), cards[0].params()):
        assert torch.equal(p, q.cpu())
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert cards[0].opt.state[q][k].is_cuda
            assert torch.equal(cpu.opt.state[p][k], cards[0].opt.state[q][k].cpu())
    batch = tuple(t.to(cuda) for t in batch)
    steps = [make_train_step(cards[0].model, step_cfg),
             CompiledTrainStep(make_train_step(cards[1].model, step_cfg))]
    noises = [TorchNoise(2, cuda), TorchNoise(2, cuda)]
    for _ in range(2):
        out = [step(card, noise, *batch)[1] for step, card, noise in zip(steps, cards, noises)]
        assert all(torch.equal(out[0][k], out[1][k]) for k in out[0])
    assert all(torch.equal(p, q) for p, q in zip(cards[0].params(), cards[1].params()))
    assert cards[0].step == cards[1].step == 3


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


# The resampling layers' backwards (csrc/patch_resample.cu): every VG and
# COCO shape (merges at 64/32/16 and 40/20, breakups 8x8 1536->384, 16x16
# 768->192, 32x32 384->96, 10x10 768->192, 20x20 384->96), a small width,
# ragged token counts, batch 2-8, the breakup with and without its skip.
# Each gradient within a relative L2 of ``plain_vjp``'s (the plain version
# differentiated on the card, fp32 products): both sum in other orders, and
# each rounds its bf16 outputs once
MERGE_BWD_SHAPES = [(64, 96, 2), (32, 192, 4), (16, 384, 8), (40, 96, 3), (20, 192, 5),
                    (16, 48, 2), (62, 96, 3), (6, 384, 7), (8, 16, 3, 24)]
BREAKUP_BWD_SHAPES = [(8, 1536, 384, 2), (16, 768, 192, 4), (32, 384, 96, 2), (10, 768, 192, 8),
                      (20, 384, 96, 3), (8, 128, 32, 5), (6, 1536, 384, 3)]
RESAMPLE_BWD_REL_L2 = 1e-2


def _merge_bwd_args(dev, hw, c, b, c_out=None):
    c_out = c_out or 2 * c
    return (_rnd(dev, b, hw, hw, c), _vec(dev, 4 * c, 1.0), _vec(dev, 4 * c),
            _lin(dev, c_out, 4 * c), _rnd(dev, b, hw // 2, hw // 2, c_out))


def _breakup_bwd_args(dev, hw, cin, cout, b, with_skip):
    dim = 4 * cout
    c1 = cin // 2 if with_skip else cin
    return (_rnd(dev, b, hw, hw, c1), _rnd(dev, b, hw, hw, cin - c1) if with_skip else None,
            _lin(dev, dim, cin), _vec(dev, dim, 1.0), _vec(dev, dim), _vec(dev, cout, 1.0),
            _vec(dev, cout), _lin(dev, cout, cout), _rnd(dev, b, 2 * hw, 2 * hw, cout))


def _check_resample_bwd(name, kern, plain, args):
    """One launch of ``name``, each gradient against ``plain_vjp``'s, two
    launches bit-equal; returns the relative L2 gaps."""
    before = cuda_build.launches_by_kernel().get(name, 0)
    got = kern(*args)
    want = cuda_build.plain_vjp(plain, args[:-1], args[-1])
    torch.cuda.synchronize()
    assert cuda_build.launches_by_kernel()[name] == before + 1
    gaps = []
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), i
        if g is None:
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, i
        gaps.append(float((g.float() - w.float()).norm() / w.float().norm()))
    print(name, [f"{x:.3e}" for x in gaps])
    assert all(x < RESAMPLE_BWD_REL_L2 for x in gaps), (name, gaps)
    again = kern(*args)
    assert all(g is None or torch.equal(g, a) for g, a in zip(got, again))
    return gaps


# (grid, C, batch[, outputs]): 24 outputs, which the forward takes, give dhn
# = dy W a K that is no multiple of 16 (its operands zero-padded)
@pytest.mark.parametrize("shape", MERGE_BWD_SHAPES)
def test_patch_merge_bwd_kernel(cuda, shape):
    torch.manual_seed(sum(shape))
    _check_resample_bwd("patch_merge_bwd", pr.patch_merge_bwd, pr.patch_merge_plain,
                        _merge_bwd_args(cuda, *shape))


@pytest.mark.parametrize("hw,cin,cout,b", BREAKUP_BWD_SHAPES)
@pytest.mark.parametrize("with_skip", [True, False])
def test_patch_breakup_bwd_kernel(cuda, hw, cin, cout, b, with_skip):
    torch.manual_seed(hw + cin + b)
    _check_resample_bwd("patch_breakup_bwd", pr.patch_breakup_bwd, pr.patch_breakup_plain,
                        _breakup_bwd_args(cuda, hw, cin, cout, b, with_skip))


def _straight_through(t):
    """t rounded to bf16, its gradient passed through unrounded (fp64)."""
    return t + (t.to(torch.bfloat16).double() - t).detach()


def _merge_fp64(x, g, b, w):
    """patch_merge_plain in fp64, its roundings straight through."""
    bsz, h, ww, c = x.shape
    x = x.reshape(bsz, h // 2, 2, ww // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
    x = x.reshape(bsz, h // 2, ww // 2, 4 * c)
    hn = _straight_through(torch.nn.functional.layer_norm(x, (4 * c,), g, b, 1e-6))
    return _straight_through(hn @ w.T)


def _breakup_fp64(x, skip, w_in, g1, b1, g2, b2, w_out):
    """patch_breakup_plain in fp64, its roundings straight through."""
    if skip is not None:
        x = torch.cat([x, skip], -1)
    bsz, h, ww, _ = x.shape
    c = w_out.shape[0]
    a = _straight_through(torch.nn.functional.layer_norm(x @ w_in.T, (4 * c,), g1, b1, 1e-6))
    a = a.reshape(bsz, h, ww, 2, 2, c).permute(0, 1, 4, 2, 3, 5).reshape(bsz, 2 * h, 2 * ww, c)
    h2 = _straight_through(torch.nn.functional.layer_norm(a, (c,), g2, b2, 1e-6))
    return _straight_through(h2 @ w_out.T)


@pytest.mark.parametrize("which", ["merge", "breakup"])
def test_resample_bwd_no_less_precise_than_plain_vjp(cuda, which):
    """Against an fp64 vjp of the same forward (its bf16 roundings applied,
    their gradients passed straight through), each gradient of the kernels
    lies no further than ``plain_vjp``'s, within a bf16 ulp's share: the
    kernels take bf16 operands, fp32 sums and fp32 LayerNorm vjps, and keep
    in fp32 what the plain version rounds (the breakup's LN2 vjp)."""
    torch.manual_seed(7)
    if which == "merge":
        args = _merge_bwd_args(cuda, 32, 192, 4)
        kern, plain, f64 = pr.patch_merge_bwd, pr.patch_merge_plain, _merge_fp64
    else:
        args = _breakup_bwd_args(cuda, 16, 768, 192, 4, True)
        kern, plain, f64 = pr.patch_breakup_bwd, pr.patch_breakup_plain, _breakup_fp64
    got = kern(*args)
    want = cuda_build.plain_vjp(plain, args[:-1], args[-1])
    leaves = [None if t is None else t.double().requires_grad_(True) for t in args[:-1]]
    out = f64(*leaves)
    exact = torch.autograd.grad(out, [t for t in leaves if t is not None], args[-1].double())
    gaps = []
    for g, w, e in zip((t for t in got if t is not None), (t for t in want if t is not None),
                       exact):
        gaps.append((float((g.double() - e).norm() / e.norm()),
                     float((w.double() - e).norm() / e.norm())))
    print(which, [f"{a:.3e}/{b:.3e}" for a, b in gaps])
    assert all(a <= b + 2 ** -12 for a, b in gaps), gaps


def test_resample_bwd_replays_in_a_cuda_graph(cuda):
    """Both backwards captured into one CUDA graph (as the compiled training
    step captures its backward) and replayed on new inputs give the eager
    launches' bits, and the replay counts one launch of each."""
    torch.manual_seed(5)
    margs = _merge_bwd_args(cuda, 32, 192, 3)
    bargs = _breakup_bwd_args(cuda, 16, 768, 192, 3, True)

    def run():
        return pr.patch_merge_bwd(*margs), pr.patch_breakup_bwd(*bargs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()  # first use outside the capture, as warm_and_capture takes it
    torch.cuda.current_stream().wait_stream(side)
    graph, record = torch.cuda.CUDAGraph(), collections.Counter()
    with cuda_build.capturing(record, side), torch.cuda.graph(graph, stream=side):
        static = run()
    assert record == {("patch_merge_bwd", "32x32xC192"): 1,
                      ("patch_breakup_bwd", "16x16xC768->192"): 1}
    for t in margs + bargs:
        if t is not None:
            t.copy_(torch.randn_like(t.float()).to(t.dtype) * (0.5 if t.dtype == torch.bfloat16
                                                                 else 0.1))
    graph.replay()
    torch.cuda.synchronize()
    eager = run()
    for got, want in zip(static, eager):
        assert all(g is None or torch.equal(g, w) for g, w in zip(got, want))


def test_resample_bwd_functions_are_charged_to_their_kernels(cuda):
    """Every device function that the two backwards launch maps, through the
    benchmark's kernel tables (benchmark/metrics/torch_ops_pct.train.json and
    swin_bwd_roofline.json, first matching fragment), to ``patch_merge`` or
    ``patch_breakup``: none is charged to the backward rows or to PyTorch."""
    import json
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile
    root = Path(__file__).resolve().parent.parent / "benchmark" / "metrics"
    tables = [json.loads((root / f).read_text())["table"]
              for f in ("torch_ops_pct.train.json", "swin_bwd_roofline.json")]

    def kernel_of(name, table):  # benchmark/yardstick/kernels.py
        return next((k for frag, k in table if frag in name), None)
    torch.manual_seed(6)
    for hw, args, fn, want in (
            (16, _merge_bwd_args(cuda, 16, 384, 2), pr.patch_merge_bwd, "patch_merge"),
            (8, _breakup_bwd_args(cuda, 8, 1536, 384, 2, True), pr.patch_breakup_bwd,
             "patch_breakup"),
            (32, _breakup_bwd_args(cuda, 32, 384, 96, 2, True), pr.patch_breakup_bwd,
             "patch_breakup")):
        fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages() if e.device_type.name == "CUDA"}
        names = {n for n in names if "Memcpy" not in n and "Memset" not in n}
        assert names, "no device function in the profile"
        for table in tables:
            assert {n: kernel_of(n, table) for n in names} == {n: want for n in names}


def test_backward_through_a_two_stage_model_runs_the_backward_kernels(cuda):
    """One ``backward()`` of a two-stage bf16 model: every parameter gets a
    finite gradient within 1e-1 relative L2 of the fp32 plain model's on the
    CPU (the backward rounds dy, du and dqkv to bf16 on top of the forward's
    roundings), the two backward kernels run once per block, and the
    resampling layers' backwards once per layer, never through
    ``plain_vjp``."""
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
    vjps = []
    plain_vjp = cuda_build.plain_vjp

    def recording(fn, *args):
        vjps.append(fn.__name__)
        return plain_vjp(fn, *args)
    cuda_build.plain_vjp = recording
    try:
        got = grads(model, cuda)
    finally:
        cuda_build.plain_vjp = plain_vjp
    torch.cuda.synchronize()
    counts = cuda_build.launches_by_kernel()
    assert counts["swin_attn_bwd"] == counts["token_mlp_bwd"] == 6  # blocks: 2+1 down, 1+2 up
    assert counts["patch_merge_bwd"] == counts["patch_breakup_bwd"] == 1
    assert not {"patch_merge_plain", "patch_breakup_plain"} & set(vjps), vjps
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


# Every VG and COCO stage of swin_attn at ragged token counts (batch 1 and 3)
# and at the sampling cells' batch 64: window 8 and 10, shift on and off; at
# few windows (C768, COCO's 10x10 C384, any stage at batch 1) the plan
# splits the heads into groups whose proj partials a closing pass adds.
MODEL_ATTN_SHAPES = [(64, 3, 8, 0), (32, 6, 8, 0), (16, 12, 8, 0), (16, 12, 8, 4), (8, 24, 8, 0),
                     (40, 3, 10, 0), (20, 6, 10, 0), (20, 6, 10, 5), (10, 12, 10, 0)]


@pytest.mark.parametrize("hw,heads,window,shift", MODEL_ATTN_SHAPES)
@pytest.mark.parametrize("b", [1, 3, 16, 1000])
def test_swin_attn_bwd_kernel_model_shapes(cuda, hw, heads, window, shift, b):
    """swin_attn_bwd at every VG and COCO stage, batch 1, 3, 16 and the
    training batch 1000 (COCO's token counts are ragged: 100, 300, 1200, 4800
    rows at batch 1-3; VG's 64x64 runs the fused kernel, the others the
    chain), all nine gradients against the plain backward in fp32 under
    _check_grads' bf16 tolerance (2e-2 of each element plus 1e-2 of the
    largest: the kernels round hn, qkv, P, dS, attn and dqkv to bf16 at the
    plain version's points and sum in other orders), bit-equal between two
    launches, each counted under its path's key (the fused kernel's ends in
    " fused")."""
    torch.manual_seed(hw + heads + b + 1)
    c = 32 * heads
    a = _attn_args(cuda, b, hw, heads, window, shift)
    bargs = a[:2] + (_rnd(cuda, b, hw, hw, c),) + a[2:7] + a[8:]
    _check_grads("swin_attn_bwd", sw.swin_attn_bwd, sw.swin_attn_bwd_plain, *bargs, heads,
                 window, shift)
    key = ("swin_attn_bwd", sw._shape_key(hw, hw, c, shift) + (" fused" if hw == 64 else ""))
    before = collections.Counter(cuda_build.LAUNCHES)
    again = sw.swin_attn_bwd(*bargs, heads, window, shift)
    assert cuda_build.LAUNCHES[key] == before[key] + 1
    assert all(torch.equal(x, y)
               for x, y in zip(again, sw.swin_attn_bwd(*bargs, heads, window, shift)))


# the shifted stages, and the fused kernel's stage with a shift
SHIFTED_ATTN_SHAPES = [(64, 3, 8, 4), (16, 12, 8, 4), (20, 6, 10, 5)]


@pytest.mark.parametrize("hw,heads,window,shift", SHIFTED_ATTN_SHAPES)
def test_swin_attn_bwd_shifted_matches_the_pre_rolled_grid(cuda, hw, heads, window, shift):
    """The roll is index math: on the pre-rolled grid (shift 0, the same
    mask) the windows, their order and each row's work are the same, so dx
    and d(rel_bias) are bit-equal, and where the fused kernel runs so are its
    per-window sums (d scale_shift, d gamma, d beta, dbqkv, dbproj).  Sums
    over tokens in raster order (the weight gradients; the chain's row-pass
    and column sums) see the tokens in another order: fp32 reassociation,
    within 1e-5 of the largest element, and the weight gradients, returned
    in bf16, may round that to the neighbouring bf16 value (2^-7 of it)."""
    torch.manual_seed(hw + heads + shift)
    c, b = 32 * heads, 3
    a = _attn_args(cuda, b, hw, heads, window, shift)
    dy = _rnd(cuda, b, hw, hw, c)

    def roll(t, s):
        return torch.roll(t, (s, s), dims=(1, 2))

    got = sw.swin_attn_bwd(a[0], a[1], dy, *a[2:7], *a[8:], heads, window, shift)
    pre = sw.swin_attn_bwd(roll(a[0], -shift), a[1], roll(dy, -shift), *a[2:7], *a[8:], heads,
                           window, 0)
    exact = {0, 8} | ({1, 2, 3, 5, 7} if sw.attn_bwd_fused_tile(cuda, c, window ** 2) else set())
    for i, (g, p) in enumerate(zip(got, pre)):
        p = roll(p, shift) if i == 0 else p
        if i in exact:
            assert torch.equal(g, p), i
        else:
            torch.testing.assert_close(g.float(), p.float(),
                                       rtol=2.0 ** -7 if g.dtype == torch.bfloat16 else 0,
                                       atol=1e-5 * float(p.float().abs().max()))


def _attn_plan(dev, b, hw, heads, window, shift):
    n_win = (hw // window) ** 2
    return sw.attn_plan(b * n_win, heads, n_win if shift else 1,
                        sw.attn_tile(dev, 32 * heads, window * window), cuda_build.sm_count(dev))


@pytest.mark.parametrize("hw,heads,window,shift", MODEL_ATTN_SHAPES)
@pytest.mark.parametrize("b", [1, 3, 64])
def test_swin_attn_kernel_model_shapes(cuda, hw, heads, window, shift, b):
    """One launch at every stage (its key names the plan's head groups),
    bit-equal on a relaunch; a shifted stage bit-equal to the same kernel on
    the pre-rolled grid (the roll is index math: a row's sums do not depend
    on where it falls)."""
    torch.manual_seed(hw + heads + b)
    plan = _attn_plan(cuda, b, hw, heads, window, shift)
    if 32 * heads == 768 or b == 1:
        assert plan["groups"] > 1, plan  # few windows: the heads split
    args = _attn_args(cuda, b, hw, heads, window, shift)
    before = collections.Counter(cuda_build.LAUNCHES)
    _check("swin_attn", sw.swin_attn, sw.swin_attn_block_plain, *args, heads, window, shift)
    key = f"{hw}x{hw}xC{32 * heads}" + (f" shift{shift}" if shift else "") + f" g{plan['groups']}"
    assert cuda_build.LAUNCHES[("swin_attn", key)] == before[("swin_attn", key)] + 1
    _bit_equal_again(sw.swin_attn, *args, heads, window, shift)
    if shift:
        rolled = torch.roll(args[0], (-shift, -shift), dims=(1, 2))
        got = torch.roll(sw.swin_attn(rolled, *args[1:], heads, window, 0), (shift, shift),
                         dims=(1, 2))
        assert torch.equal(got, sw.swin_attn(*args, heads, window, shift))


def test_swin_attn_kernel_at_the_training_batch(cuda):
    """VG's 64x64 C96 stage at batch 1000, the training forward's largest
    launch (4.1 M tokens)."""
    torch.manual_seed(1000)
    args = _attn_args(cuda, 1000, 64, 3, 8, 0)
    _check("swin_attn", sw.swin_attn, sw.swin_attn_block_plain, *args, 3, 8, 0)
    _bit_equal_again(sw.swin_attn, *args, 3, 8, 0)


@pytest.mark.parametrize("hw,heads,window,shift,b", [(64, 3, 8, 0, 64), (16, 12, 8, 4, 64),
                                                     (40, 3, 10, 0, 64), (20, 6, 10, 5, 64),
                                                     (8, 24, 8, 0, 64), (10, 12, 10, 0, 16)])
def test_swin_attn_head_groups_match_the_whole_plan(cuda, monkeypatch, hw, heads, window,
                                                    shift, b):
    """The plan follows the SM count: on a card taken for 64 times its SMs
    it splits every stage's heads into more groups, each writing fp32 proj
    partials that the closing pass adds.  The groups round the same bf16
    intermediates and differ from the whole plan only in the order of proj's
    fp32 sum, so y moves by at most about one bf16 ulp (2^-8 relative)."""
    torch.manual_seed(hw + b)
    args = _attn_args(cuda, b, hw, heads, window, shift) + (heads, window, shift)
    whole_plan = _attn_plan(cuda, b, hw, heads, window, shift)
    whole = sw.swin_attn(*args)
    sms = cuda_build.sm_count(cuda)
    monkeypatch.setattr(cuda_build, "sm_count", lambda device: 64 * sms)
    split_plan = _attn_plan(cuda, b, hw, heads, window, shift)
    assert split_plan["groups"] > whole_plan["groups"], (whole_plan, split_plan)
    split = sw.swin_attn(*args)
    _bit_equal_again(sw.swin_attn, *args)
    torch.testing.assert_close(split.float(), whole.float(), atol=1e-2, rtol=2 ** -7)
    torch.testing.assert_close(split.float(), sw.swin_attn_block_plain(*args).float(),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hw,heads,window,shift", [(16, 12, 8, 4), (8, 24, 8, 0),
                                                   (20, 6, 10, 5), (10, 12, 10, 0)])
def test_swin_attn_gradients_through_the_kernels(cuda, hw, heads, window, shift):
    """Autograd through swin_attn: the forward kernel, then the backward
    kernel on what the forward saved, against the plain backward at the
    backward kernel's own tolerance (_check_grads)."""
    torch.manual_seed(hw + heads)
    b, c = 3, 32 * heads
    a = _attn_args(cuda, b, hw, heads, window, shift)
    dy = _rnd(cuda, b, hw, hw, c)
    leaves = [t.clone().requires_grad_() for t in a[:9]]
    before = cuda_build.launches_by_kernel()
    y = sw.swin_attn(*leaves, a[9], heads, window, shift)
    grads = torch.autograd.grad(y, leaves, dy)
    after = cuda_build.launches_by_kernel()
    assert all(after[k] == before.get(k, 0) + 1 for k in ("swin_attn", "swin_attn_bwd"))
    refs = sw.swin_attn_bwd_plain(*a[:2], dy, *a[2:7], *a[8:], heads, window, shift)
    for i, (got, ref) in enumerate(zip(grads, refs)):  # x, ss, g, b, wqkv, bqkv, wproj, bproj, rel
        assert got.shape == ref.shape and got.dtype == ref.dtype, i
        o, r = got.float(), ref.float()
        tol = 2e-2 * r.abs() + 1e-2 * r.abs().max()
        assert bool(((o - r).abs() <= tol).all()), (i, float((o - r).abs().max()))


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


# the four shapes of scripts/microbench_int8.py, a K = 96 case whose rows
# end inside a tile, and the 64- and 16-column tiles
@pytest.mark.parametrize("repeats", [2, 128])
@pytest.mark.parametrize("m,k,n", [(512, 768, 768), (1024, 96, 96), (1024, 96, 288),
                                   (2048, 128, 128), (192, 96, 192), (64, 64, 64),
                                   (128, 96, 48)])
def test_mm_accumulate_kernel(cuda, m, k, n, repeats):
    """int8 exact, bf16 within 1e-3 of the fp32 product's max; the tile the
    library reports divides n and fits the shared memory."""
    from diffusesg_torch.ops import mm_microbench as mm
    torch.manual_seed(m + n)
    a8 = torch.randint(-127, 127, (m, k), device=cuda, dtype=torch.int8)
    b8 = torch.randint(-127, 127, (k, n), device=cuda, dtype=torch.int8)
    got = mm.mm_accumulate(a8, b8, repeats)
    assert got.dtype == torch.int32 and torch.equal(got, mm.mm_accumulate_plain(a8, b8, repeats))
    a, b = _rnd(cuda, m, k), _rnd(cuda, k, n)
    got, ref = mm.mm_accumulate(a, b, repeats), mm.mm_accumulate_plain(a, b, repeats)
    assert got.dtype == torch.float32
    assert float((got - ref).abs().max()) <= 1e-3 * float(ref.abs().max())
    for is_int8 in (False, True):
        rows, cols, per_sm, smem = mm.kernel_tile(cuda, n, k, is_int8)
        assert n % cols == 0 and per_sm >= 1 and smem <= 232_448
    with pytest.raises(ValueError, match="mm_accumulate takes"):
        mm.mm_accumulate(a[:, :24].contiguous(), b[:24].contiguous(), 64)
