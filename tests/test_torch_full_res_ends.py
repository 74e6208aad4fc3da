"""The denoiser's full-resolution ends on the CPU: the plain versions of the
entry (``ops.patch_embed``) and of the exit (``ops.readout_kernel.
output_head``) against the module composition they replace, the node
pooling's fixed-order partial sums, and the routing: the ops where no
gradient is recorded, the composition, with autograd's gradients, where one
is."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffusesg_torch.models import diffusesg as dsg_mod
from diffusesg_torch.models.layers import Mlp, PatchEmbed, ReadOut, dense
from diffusesg_torch.ops import patch_embed as pe
from diffusesg_torch.ops import readout_kernel as rk
from diffusesg_torch.ops.masking import mask_adjs, mask_nodes, symmetrize
from diffusesg_torch.ops.mlp_block_kernel import layer_norm

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
    with torch.no_grad():
        want = embed(_seed_assembly(x["adj"], x["node"], x["flags"], sc_a, sc_x, self_condition,
                                    dt), x["emb"])
        got = pe.patch_embed(x["adj"], x["node"], x["flags"], sc_a, sc_x,
                             embed.proj.weight[:, :, 0, 0].to(dt), embed.proj.bias.to(dt),
                             embed.norm.weight, embed.norm.bias, dense(x["emb"], embed.affine, dt),
                             self_condition)
    assert got.shape == (2, n * n, D) and got.dtype == dt
    torch.testing.assert_close(got, want, atol=0, rtol=0)
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
    with torch.no_grad():
        shared = read_out(layer_norm(rows, norm.weight, norm.bias).to(dt), n, n)
        want_adj = head(shared).float()
        want_node = torch.mean(mask_adjs(shared, flags), dim=2, dtype=torch.float32)
        got_adj, got_node = rk.output_head(
            rows.reshape(2, n, n, D), norm.weight, norm.bias,
            *(t for pair in read_out.linears() for t in pair),
            head.fc1.weight.to(dt), head.fc1.bias, head.fc2.weight.to(dt), head.fc2.bias, flags)
    assert got_adj.shape == (2, n, n, 1) and got_adj.dtype == torch.float32
    assert got_node.shape == (2, n, D) and got_node.dtype == torch.float32
    torch.testing.assert_close(got_adj, want_adj, atol=0, rtol=0)
    torch.testing.assert_close(got_node, want_node, atol=0, rtol=0)
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
    x = model.forward_features(model.patch_embed(x, emb), emb)
    n = node.shape[1]
    shared = model.read_out(layer_norm(x, model.norm.weight, model.norm.bias).to(dt), n, n)
    adj_out = model.readout_adj_mlp(shared).float()[..., 0]
    node_feat = torch.mean(mask_adjs(shared, flags), dim=2, dtype=torch.float32).to(dt)
    node_out = mask_nodes(model.readout_node_mlp(node_feat).float(), flags)
    return symmetrize(mask_adjs(adj_out, flags)), node_out


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "grad"])
def test_the_ends_route_by_the_grad_mode(monkeypatch, mode):
    calls = []
    real_embed, real_head = pe.patch_embed, dsg_mod.output_head

    def spy(name, fn):
        def run(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return run

    monkeypatch.setattr(pe, "patch_embed", spy("entry", real_embed))
    monkeypatch.setattr(dsg_mod, "output_head", spy("exit", real_head))
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
    """Where a gradient is recorded the model runs the composition: its
    outputs and autograd's gradients are those of the modules as they were
    composed before; without one (the ops, plain on the CPU) the outputs are
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
