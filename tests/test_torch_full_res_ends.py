"""The denoiser's full-resolution ends on the CPU: the one composition of
the entry (``ops.patch_embed``) and of the exit (``ops.readout_kernel``)
against the modules' composition as the seed computed it (frozen here), the
node pooling's fixed-order partial sums, the routing inside the two ops (the
kernel where no gradient is recorded, the composition, with autograd's
gradients, where one is), and patch size 2 against the JAX package."""
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax  # noqa: F401  (the JAX package's model is the reference of the patch-size case)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_parity import ATOL, RTOL, load_pair, model_pair, node_flags  # noqa: E402

from diffusesg_torch.models.layers import Mlp, PatchEmbed, ReadOut, dense  # noqa: E402
from diffusesg_torch.ops import patch_embed as pe  # noqa: E402
from diffusesg_torch.ops import readout_kernel as rk  # noqa: E402
from diffusesg_torch.ops.masking import mask_adjs, mask_nodes, symmetrize  # noqa: E402
from diffusesg_torch.ops.mlp_block_kernel import layer_norm  # noqa: E402
from diffusesg_torch.utils.weights import state_dict_to_flax  # noqa: E402

# (N, node counts of a batch of 2) at VG's and COCO's grids, the second
# graph padded
GRIDS = {"vg": (64, [64, 23]), "coco": (40, [40, 17])}
CA, CX, D = 1, 5, 96  # both configurations: 1 adjacency and 5 node channels, width 96
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _flags(n, counts):
    return torch.arange(n)[None, :] < torch.tensor(counts)[:, None]


def _graph(n, counts, seed):
    g = torch.Generator().manual_seed(seed)
    b = len(counts)
    return dict(adj=torch.randn(b, n, n, CA, generator=g), node=torch.randn(b, n, CX, generator=g),
                sc_a=torch.randn(b, n, n, CA, generator=g) * 0.5,
                sc_x=torch.randn(b, n, CX, generator=g) * 0.5, flags=_flags(n, counts),
                emb=torch.randn(b, 512, generator=g))


def _randomize(module, seed):
    """Weights at std 1/sqrt(fan in), LayerNorm scales near 1, biases std 0.1."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if p.ndim > 1:
                p.copy_(r * p.shape[1] ** -0.5)
            elif isinstance(module.get_submodule(name.rpartition(".")[0]), torch.nn.LayerNorm) \
                    and name.endswith("weight"):
                p.copy_(1.0 + 0.1 * r)
            else:
                p.copy_(0.1 * r)
    return module


def _seed_assembly(adj, node, flags, sc_a, sc_x, self_condition, dt):
    """The denoiser's input assembly as the model wrote it inline before the
    entry became an op."""
    node = node.float()
    if self_condition:
        sc_a = torch.zeros_like(adj) if sc_a is None else sc_a
        sc_x = torch.zeros_like(node) if sc_x is None else sc_x
        adj = torch.cat([sc_a.to(adj.dtype), adj], dim=-1)
        node = torch.cat([sc_x.float(), node], dim=-1)
    b, n = node.shape[:2]
    node_mat = node[:, :, None, :].expand(b, n, n, node.shape[-1])
    node_cat = mask_adjs(torch.cat([node_mat, node_mat.transpose(1, 2)], dim=-1), flags)
    return torch.cat([adj.to(node_cat.dtype), node_cat], dim=-1).to(dt)


def _seed_patch_embed(embed, x, emb):
    """PatchEmbed's forward and its noise affine's as the modules computed
    them before the entry became an op."""
    b, h, w, c = x.shape
    p, dt = embed.patch_size, embed.dtype
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, (h // p) * (w // p), p * p * c)
    weight = embed.proj.weight.permute(0, 2, 3, 1).reshape(embed.proj.out_channels, -1)
    x = F.linear(x.to(dt), weight.to(dt), embed.proj.bias.to(dt))
    if embed.norm is not None:
        x = layer_norm(x, embed.norm.weight, embed.norm.bias).to(dt)
    a = embed.affine
    ss = F.linear(emb.to(dt), a.weight.to(dt), a.bias.to(dt))
    scale, shift = ss[:, None, :].chunk(2, dim=-1)
    return F.silu(shift + x * (scale + 1.0))


def _seed_read_out(read_out, x, ph, pw):
    """ReadOut's forward as the module computed it before the exit became
    an op: [B, L, D] -> [B, pH, pW, D]."""
    b, L, c = x.shape
    p, d = read_out.patch_size, getattr(read_out, "0").out_channels
    (w0, b0), *pointwise = read_out.linears()
    x = F.linear(x.to(read_out.dtype), w0, b0)
    x = x.reshape(b, ph, pw, p, p, d).permute(0, 1, 3, 2, 4, 5).reshape(b, ph * p, pw * p, d)
    for w, bias in pointwise:
        x = F.linear(x, w, bias)
    return x


# self-conditioning: channels and tensors given, channels with None (zeros),
# no channels (a model without it)
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("sc", ["given", "zeros", "off"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_patch_embed_plain_matches_the_module_composition(grid, sc, dtype):
    n, counts = GRIDS[grid]
    dt, self_condition = DTYPES[dtype], sc != "off"
    x = _graph(n, counts, seed=n + len(sc))
    sc_a, sc_x = (x["sc_a"], x["sc_x"]) if sc == "given" else (None, None)
    cin = (2 if self_condition else 1) * (CA + 2 * CX)
    embed = _randomize(PatchEmbed(n, 1, cin, D, True, dt), seed=3)
    args = (x["adj"], x["node"], x["flags"], sc_a, sc_x, *embed.linear(), embed.norm.weight,
            embed.norm.bias, dense(x["emb"], embed.affine, dt), self_condition)
    with torch.no_grad():
        want = _seed_patch_embed(embed, _seed_assembly(x["adj"], x["node"], x["flags"], sc_a,
                                                       sc_x, self_condition, dt), x["emb"])
        got = pe.patch_embed_plain(*args)
        routed = pe.patch_embed(*args)
    assert got.shape == (2, n * n, D) and got.dtype == dt
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(routed, want, atol=0, rtol=0)
    # the padded graph's node channels are masked: its rows past the count
    # see only the adjacency channels
    assert not torch.equal(got[1, -1], got[0, -1])


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_output_head_plain_matches_the_module_composition(grid, dtype):
    n, counts = GRIDS[grid]
    dt = DTYPES[dtype]
    g = torch.Generator().manual_seed(n)
    rows = (torch.randn(2, n * n, D, generator=g) * 2 + 0.5).to(dt)
    flags = _flags(n, counts)
    norm = _randomize(torch.nn.LayerNorm(D, eps=1e-6), seed=1)
    read_out = _randomize(ReadOut(1, D, dt), seed=2)
    head = _randomize(Mlp(D, D, 1, dt), seed=4)
    args = (rows.reshape(2, n, n, D), norm.weight, norm.bias,
            *(t for pair in read_out.linears() for t in pair),
            head.fc1.weight.to(dt), head.fc1.bias, head.fc2.weight.to(dt), head.fc2.bias, flags)
    with torch.no_grad():
        shared = _seed_read_out(read_out, layer_norm(rows, norm.weight, norm.bias).to(dt), n, n)
        want_adj = head(shared).float()
        want_node = torch.mean(mask_adjs(shared, flags), dim=2, dtype=torch.float32)
        got_adj, got_node = rk.output_head_plain(*args)
        routed = rk.output_head(*args)
    assert got_adj.shape == (2, n, n, 1) and got_adj.dtype == torch.float32
    assert got_node.shape == (2, n, D) and got_node.dtype == torch.float32
    for adj, node in ((got_adj, got_node), routed):
        torch.testing.assert_close(adj, want_adj, atol=0, rtol=0)
        torch.testing.assert_close(node, want_node, atol=0, rtol=0)
    # the padded graph's pooled rows of padded nodes are zero
    assert float(got_node[1, counts[1]:].abs().max()) == 0.0


def _kernel_partials(shared_rows, flags, n, tile=64):
    """The output head kernel's pooling, in Python: for each 64-row tile, in
    row order, a masked sum of each group's (b, i) rows into its slot (0
    from the first tile the group reaches, 1 from the second; a group wholly
    in its first tile zeroes slot 1), [B N, 2, C]."""
    m, c = shared_rows.shape
    part = torch.full((m // n, 2, c), float("nan"))
    b_of = torch.arange(m) // (n * n)
    g_of = torch.arange(m) // n
    ok = flags.reshape(-1)[g_of] & flags.reshape(-1)[b_of * n + torch.arange(m) % n]
    for t in range(-(-m // tile)):
        rows = range(t * tile, min(m, (t + 1) * tile))
        for grp in sorted({int(g_of[r]) for r in rows}):
            s = torch.zeros(c)
            for r in rows:
                if g_of[r] == grp and ok[r]:
                    s = s + shared_rows[r].float()
            slot = 0 if grp * n // tile == t else 1
            part[grp, slot] = s
            if slot == 0 and (grp * n + n - 1) // tile == t:
                part[grp, 1] = 0.0
    return part


# N = 64: a tile is one (b, i); N = 40: a tile reaches two or three groups;
# N = 8, 24, 7: many groups a tile, groups cut at both ends, a ragged last tile
@pytest.mark.parametrize("n,counts", [(64, [64, 30]), (40, [40, 9]), (8, [3, 8, 1]),
                                      (24, [24, 20]), (7, [7, 2, 5])])
def test_node_pool_partials_match_the_masked_mean(n, counts):
    g = torch.Generator().manual_seed(n)
    b = len(counts)
    shared = torch.randn(b, n, n, 12, generator=g).to(torch.bfloat16)
    flags = _flags(n, counts)
    part = _kernel_partials(shared.reshape(-1, 12), flags, n)
    assert not torch.isnan(part).any()  # every slot written once
    got = part.sum(1).div_(n).reshape(b, n, 12)
    torch.testing.assert_close(got, rk.node_pool_plain(shared, flags), atol=1e-6, rtol=1e-6)


def _small_model(dtype=torch.float32):
    """A two-stage denoiser at the kernels' width (96) with the kernels on
    (which on the CPU run their plain versions)."""
    from diffusesg_torch.models.diffusesg import DiffuseSG
    torch.manual_seed(0)
    model = DiffuseSG(img_size=16, in_chans=CA + 2 * CX, embed_dim=D, depths=(1, 1),
                      num_heads=(3, 6), window_size=8, out_chans_node=CX, self_condition=True,
                      dtype=dtype, use_kernels=True)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim > 1:
                p.normal_(0, p.shape[1] ** -0.5)
            elif "norm" in name and name.endswith("weight"):
                p.normal_(1.0, 0.1)
            else:
                p.normal_(0, 0.1)
    return model


def _inputs(b=2, n=16):
    g = torch.Generator().manual_seed(7)
    return (torch.randn(b, n, n, generator=g), torch.randn(b, n, CX, generator=g),
            _flags(n, [n, 11]), torch.tensor([0.2, -0.4]),
            torch.randn(b, n, n, generator=g) * 0.5, torch.randn(b, n, CX, generator=g) * 0.5)


def _seed_composition(model, adj, node, flags, c_noise, sc_a, sc_x):
    """The denoiser's forward as the modules composed it before the two ends
    became ops."""
    dt = model.dtype
    emb = model.map_noise(c_noise)
    emb = F.silu(dense(emb, model.map_layer0, dt))
    emb = F.silu(dense(emb, model.map_layer1, dt))
    x = _seed_assembly(adj[..., None], node, flags, sc_a[..., None], sc_x, True, dt)
    x = model.forward_features(_seed_patch_embed(model.patch_embed, x, emb), emb)
    n = node.shape[1]
    shared = _seed_read_out(model.read_out, layer_norm(x, model.norm.weight, model.norm.bias)
                            .to(dt), n, n)
    adj_out = model.readout_adj_mlp(shared).float()[..., 0]
    node_feat = torch.mean(mask_adjs(shared, flags), dim=2, dtype=torch.float32).to(dt)
    node_out = mask_nodes(model.readout_node_mlp(node_feat).float(), flags)
    return symmetrize(mask_adjs(adj_out, flags)), node_out


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "grad"])
def test_the_ends_route_by_the_grad_mode(monkeypatch, mode):
    """The two ops launch their kernel (``*_fwd``, the plain version on the
    CPU) where no gradient is recorded, and never with the kernels off."""
    calls = []

    def spy(name, fn):
        def run(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return run

    monkeypatch.setattr(pe, "patch_embed_fwd", spy("entry", pe.patch_embed_fwd))
    monkeypatch.setattr(rk, "output_head_fwd", spy("exit", rk.output_head_fwd))
    model = _small_model()
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "grad": torch.enable_grad}[mode]
    with ctx():
        model(*_inputs())
    assert calls == ([] if mode == "grad" else ["entry", "exit"])
    # the kernels off: the composition whatever the mode
    calls.clear()
    model.use_kernels = False
    with torch.no_grad():
        model(*_inputs())
    assert calls == []


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_grad_path_runs_the_composition_with_its_gradients(dtype):
    """Where a gradient is recorded the ops run the composition: its outputs
    and autograd's gradients are those of the modules as the seed composed
    them; without one (the kernels' path, plain on the CPU) the outputs are
    the same."""
    model = _small_model(DTYPES[dtype])
    x = _inputs()
    outs = model(*x)
    sum(o.float().square().sum() for o in outs).backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad()
    want = _seed_composition(model, *x)
    sum(o.float().square().sum() for o in want).backward()
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)
    for k, p in model.named_parameters():
        assert torch.equal(grads[k], p.grad), k
    assert all(float(g.abs().max()) > 0 for k, g in grads.items()
               if k.startswith(("patch_embed.", "norm.", "read_out.", "readout_adj_mlp.")))
    with torch.no_grad():
        fused = model(*x)
    for got, ref in zip(fused, want):
        torch.testing.assert_close(got, ref.detach(), atol=0, rtol=0)
    assert np.isfinite(fused[0].numpy()).all()


def test_patch_size_2_matches_the_jax_model():
    """At patch size 2 (``configs/vg_small_test.yaml`` cut as the parity
    tests cut it) the entry's patchify and the exit's depth-to-space run in
    the one composition of each end, with the kernels off and, through the
    ops, on: both match the JAX package's XLA model on shared weights, the
    entry's output (which the model's outputs barely feel at these weights)
    held against the flax PatchEmbed's as well."""
    jcfg, tcfg = load_pair()
    for cfg in (jcfg, tcfg):
        with cfg.unlocked():
            cfg.model.patch_size = 2
    jm, _, tm = model_pair(jcfg, tcfg)
    assert tm.patches_resolution == (8, 8) and not tm.use_kernels
    # shared through the reference's state dict: its ConvTranspose2d has one
    # bias a channel, which flax's up-projection holds tiled p * p times
    params = state_dict_to_flax(tm.state_dict(), 2)
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = dict(adj=f(2, 16, 16), node=f(2, 16, 5), flags=node_flags(2, 16, [16, 9]),
             c_noise=f(2) * 0.3, sc_a=f(2, 16, 16), sc_x=f(2, 16, 5))
    (ja, jx), seen = jm.apply(params, x["adj"], x["node"], x["flags"], x["c_noise"], x["sc_a"],
                              x["sc_x"], mutable=["intermediates"],
                              capture_intermediates=lambda mdl, _: mdl.name == "patch_embed")
    assert float(np.abs(np.asarray(ja)).max()) > 1e-2
    t = [torch.from_numpy(x[k]) for k in ("adj", "node", "flags", "c_noise", "sc_a", "sc_x")]
    embed, dt = tm.patch_embed, tm.dtype
    emb = F.silu(dense(tm.map_noise(t[3]), tm.map_layer0, dt))
    emb = F.silu(dense(emb, tm.map_layer1, dt))
    args = (t[0][..., None], t[1], t[2], t[4][..., None], t[5], *embed.linear(), embed.norm.weight,
            embed.norm.bias, dense(emb, embed.affine, dt), True, 2)
    want = np.asarray(seen["intermediates"]["patch_embed"]["__call__"][0])
    for entry in (pe.patch_embed_plain, pe.patch_embed):
        with torch.no_grad():
            got = entry(*args)
        assert got.shape == (2, 64, 24)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    for use_kernels in (False, True):
        tm.use_kernels = use_kernels
        with torch.no_grad():
            ta, tx = tm(*t)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL, rtol=RTOL)
