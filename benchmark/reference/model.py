"""Plain float32 reference of the DiffuseSG denoiser, over a state dict.

The Swin U-Net of DiffuseSG (arXiv:2401.01130; ubc-vision/DiffuseSG,
model/diffusesg/diffusesg.py) written as plain ``torch`` operations on a
name -> tensor dict in the reference checkpoint's schema
(``down_layers.0.blocks.0.attn.qkv.weight``, ...).  It imports nothing of the
measured program.  Every product runs in float32; TF32 is switched off by
``fp32_matmul()`` around each use.

``quant``, when given, is applied to both operands of every matrix product
(the Linear layers and the two products of window attention): the control
of the benchmark's correctness check passes a float8 quantizer there.

Shapes are channels-last: adj [B, N, N] (one edge channel, ddpm encoding),
node [B, N, Cx], node_flags [B, N] bool, sigmas [B].
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6
HEADS = (3, 6, 12, 24)  # fixed per stage in the reference factory
SIGMA_DATA = 0.5
# dataset name fragment -> (node types, edge types incl. null)
DATASETS = {"visual_genome": (150, 51), "coco_stuff": (171, 7)}


@contextlib.contextmanager
def fp32_matmul():
    """float32 products without TF32 (the reference's precision)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@dataclasses.dataclass(frozen=True)
class Shape:
    """The model's sizes, read from the configuration as run."""
    n: int                 # max nodes: the grid is n x n
    embed: int
    depths: tuple
    window: int
    node_types: int
    edge_types: int
    self_cond: bool

    @staticmethod
    def of(model_config: dict) -> "Shape":
        name = model_config["dataset"]["name"]
        types = next(v for k, v in DATASETS.items() if k in name)
        tr = model_config["train"]
        if tr["node_encoding"] != "ddpm" or tr["edge_encoding"] != "ddpm":
            raise ValueError("the reference covers the ddpm encodings of the published configs")
        m = model_config["model"]
        if m["patch_size"] != 1:
            raise ValueError("the reference covers patch size 1")
        return Shape(n=model_config["dataset"]["max_node_num"], embed=m["feature_dims"][-1],
                     depths=tuple(m["depths"]), window=m["window_size"], node_types=types[0],
                     edge_types=types[1], self_cond=bool(tr["self_cond"]))

    @property
    def node_chans(self) -> int:
        return 1 + 4  # the ddpm type, then the box

    def blocks(self):
        """Every Swin block of one forward, in order: (stage, res, C, heads,
        window, shift); the down path, then the mirrored up path."""
        out = []
        stages = len(self.depths)
        order = list(range(stages)) + list(range(stages - 1, -1, -1))
        for s in order:
            res, c = self.n // 2 ** s, self.embed * 2 ** s
            for i in range(self.depths[s]):
                w, shift = self.window, (0 if i % 2 == 0 else self.window // 2)
                if res <= w:
                    w, shift = res, 0
                out.append((s, res, c, HEADS[s], w, shift))
        return out


def _q(quant, t):
    return t if quant is None else quant(t)


def linear(x, w, b=None, quant=None):
    y = _q(quant, x) @ _q(quant, w).t()
    return y if b is None else y + b


def layer_norm(x, g, b):
    return F.layer_norm(x, (x.shape[-1],), g, b, LN_EPS)


def mask_adjs(a, flags):
    m = flags[:, :, None] & flags[:, None, :]
    if a.ndim == 4:
        m = m[..., None]
    return torch.where(m, a, torch.zeros((), dtype=a.dtype, device=a.device))


def mask_nodes(x, flags):
    m = flags if x.ndim == 2 else flags[..., None]
    return torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device))


def _rel_index(w: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1).reshape(-1)


def _shift_mask(res: int, w: int, shift: int) -> np.ndarray:
    img = np.zeros((res, res), dtype=np.float32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    mw = img.reshape(res // w, w, res // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _windows(t, w):
    b, h, ww, k = t.shape
    t = t.reshape(b, h // w, w, ww // w, w, k).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(-1, w * w, k)


def _unwindows(t, b, h, ww, w):
    k = t.shape[-1]
    t = t.reshape(b, h // w, ww // w, w, w, k).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, h, ww, k)


def swin_block(P, pre, x, emb, heads, w, shift, quant=None):
    """One Swin block with noise conditioning on x [B, H, W, C]."""
    b, h, ww, c = x.shape
    ss = linear(emb, P[pre + "affine.weight"], P[pre + "affine.bias"], quant)
    scale, sh = ss[:, None, None, :].chunk(2, dim=-1)
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    a = F.silu(sh + x * (scale + 1.0))
    hn = layer_norm(a, P[pre + "norm1.weight"], P[pre + "norm1.bias"])
    qkv = linear(_windows(hn, w), P[pre + "attn.qkv.weight"], P[pre + "attn.qkv.bias"], quant)
    L, hd = w * w, c // heads
    q, k, v = (t.reshape(-1, L, heads, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    table = P[pre + "attn.relative_position_bias_table"]
    idx = torch.from_numpy(_rel_index(w)).to(x.device)
    bias = table[idx].reshape(L, L, heads).permute(2, 0, 1)
    scores = (_q(quant, q) @ _q(quant, k).transpose(-1, -2)) * hd ** -0.5 + bias[None]
    if shift:
        mask = torch.from_numpy(_shift_mask(h, w, shift)).to(x.device)
        scores = scores + mask[:, None].repeat(scores.shape[0] // mask.shape[0], 1, 1, 1)
    probs = torch.softmax(scores, dim=-1)
    out = (_q(quant, probs) @ _q(quant, v)).transpose(1, 2).reshape(-1, L, c)
    out = linear(out, P[pre + "attn.proj.weight"], P[pre + "attn.proj.bias"], quant)
    y = a + _unwindows(out, b, h, ww, w)
    if shift:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    m = layer_norm(y, P[pre + "norm2.weight"], P[pre + "norm2.bias"])
    m = F.gelu(linear(m, P[pre + "mlp.fc1.weight"], P[pre + "mlp.fc1.bias"], quant))
    return y + linear(m, P[pre + "mlp.fc2.weight"], P[pre + "mlp.fc2.bias"], quant)


def patch_merge(P, pre, x, quant=None):
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5).reshape(
        b, h // 2, w // 2, 4 * c)
    x = layer_norm(x, P[pre + "norm.weight"], P[pre + "norm.bias"])
    return linear(x, P[pre + "reduction.weight"], None, quant)


def patch_breakup(P, pre, x, skip, quant=None):
    x = torch.cat([x, skip], dim=-1)
    b, h, w, _ = x.shape
    y = linear(x, P[pre + "pre_linear.weight"], None, quant)
    y = layer_norm(y, P[pre + "norm.weight"], P[pre + "norm.bias"])
    c = y.shape[-1] // 4
    y = y.reshape(b, h, w, 2, 2, c).permute(0, 1, 4, 2, 3, 5).reshape(b, 2 * h, 2 * w, c)
    y = layer_norm(y, P[pre + "post_norm.weight"], P[pre + "post_norm.bias"])
    return linear(y, P[pre + "post_linear.weight"], None, quant)


def _stage(P, pre, shape: Shape, s: int, x, emb, quant):
    res = shape.n // 2 ** s
    for i in range(shape.depths[s]):
        w, shift = shape.window, (0 if i % 2 == 0 else shape.window // 2)
        if res <= w:
            w, shift = res, 0
        x = swin_block(P, f"{pre}blocks.{i}.", x, emb, HEADS[s], w, shift, quant)
    return x


def network(P, shape: Shape, adj, node, flags, c_noise, sc_a, sc_x, quant=None):
    """The raw denoiser F: (adj [B,N,N], node [B,N,Cx]) -> (F_adj, F_node)."""
    half = shape.embed // 2
    freqs = torch.pow(1.0 / 10000, torch.arange(half, dtype=torch.float32,
                                                 device=adj.device) / half)
    args = c_noise[:, None].float() * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    emb = F.silu(linear(emb, P["map_layer0.weight"], P["map_layer0.bias"], quant))
    emb = F.silu(linear(emb, P["map_layer1.weight"], P["map_layer1.bias"], quant))

    a, x = adj[..., None], node
    if shape.self_cond:
        a = torch.cat([sc_a[..., None], a], dim=-1)
        x = torch.cat([sc_x, x], dim=-1)
    b, n = x.shape[:2]
    mat = x[:, :, None, :].expand(b, n, n, x.shape[-1])
    grid = torch.cat([a, mask_adjs(torch.cat([mat, mat.transpose(1, 2)], dim=-1), flags)], -1)

    w0 = P["patch_embed.proj.weight"][:, :, 0, 0]
    h = linear(grid, w0, P["patch_embed.proj.bias"], quant)
    h = layer_norm(h, P["patch_embed.norm.weight"], P["patch_embed.norm.bias"])
    ss = linear(emb, P["patch_embed.affine.weight"], P["patch_embed.affine.bias"], quant)
    scale, sh = ss[:, None, None, :].chunk(2, dim=-1)
    h = F.silu(sh + h * (scale + 1.0))

    stages = len(shape.depths)
    skips = []
    for s in range(stages):
        h = _stage(P, f"down_layers.{s}.", shape, s, h, emb, quant)
        if s < stages - 1:
            h = patch_merge(P, f"down_layers.{s}.downsample.", h, quant)
        skips.append(h)
    for i in range(stages):
        rest = stages - 1 - i
        skip = skips.pop()  # the deepest stage's skip is discarded
        if i > 0:
            h = patch_breakup(P, f"up_layers.{i}.upsample.", h, skip, quant)
        h = _stage(P, f"up_layers.{i}.", shape, rest, h, emb, quant)
    h = layer_norm(h, P["norm.weight"], P["norm.bias"])
    # read-out: the 1x1 transposed convolution and two 1x1 convolutions
    h = linear(h, P["read_out.0.weight"][:, :, 0, 0].t(), P["read_out.0.bias"], quant)
    h = linear(h, P["read_out.1.weight"][:, :, 0, 0], P["read_out.1.bias"], quant)
    h = linear(h, P["read_out.2.weight"][:, :, 0, 0], P["read_out.2.bias"], quant)

    def head(t, pre):
        t = F.gelu(linear(t, P[pre + "fc1.weight"], P[pre + "fc1.bias"], quant))
        return linear(t, P[pre + "fc2.weight"], P[pre + "fc2.bias"], quant)

    out_a = head(h, "readout_adj_mlp.")[..., 0]
    feat = mask_adjs(h, flags).mean(dim=2)
    out_x = head(feat, "readout_node_mlp.")
    return mask_adjs(out_a, flags), mask_nodes(out_x, flags)


def precond(sigmas):
    """EDM preconditioning (Karras et al. 2022): c_skip, c_out, c_in, c_noise."""
    sd = SIGMA_DATA
    c_skip = sd ** 2 / (sigmas ** 2 + sd ** 2)
    c_out = sigmas * sd / torch.sqrt(sigmas ** 2 + sd ** 2)
    c_in = 1.0 / torch.sqrt(sd ** 2 + sigmas ** 2)
    return c_skip, c_out, c_in, torch.log(sigmas) / 4.0


def denoise(P, shape: Shape, adj, node, flags, sigmas, sc_a=None, sc_x=None, quant=None):
    """The preconditioned denoiser D(adj, node; sigma) -> (D_adj, D_node)."""
    c_skip, c_out, c_in, c_noise = precond(sigmas)
    sc_a = torch.zeros_like(adj) if sc_a is None else sc_a
    sc_x = torch.zeros_like(node) if sc_x is None else sc_x
    f_a, f_x = network(P, shape, c_in[:, None, None] * adj, c_in[:, None, None] * node, flags,
                       c_noise, sc_a, sc_x, quant)
    d_a = c_skip[:, None, None] * adj + c_out[:, None, None] * f_a
    d_x = c_skip[:, None, None] * node + c_out[:, None, None] * f_x
    return mask_adjs(d_a, flags), mask_nodes(d_x, flags)


def fp8_quant(t):
    """float8 e4m3 with one scale per tensor (its largest magnitude to 448),
    back in float32: the precision one step below bfloat16."""
    scale = t.detach().abs().amax().clamp(min=1e-12) / 448.0
    q = (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    # the rounding acts as identity under differentiation (straight-through)
    return t + (q - t).detach()
