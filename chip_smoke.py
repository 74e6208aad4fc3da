"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py            # every phase, as a CI check
    python3 chip_smoke.py --no-slice # build + kernels vs plain only
    python3 chip_smoke.py --no-train # phases 1-3 only

Phases, each printed on its own line:
  1. the card (nvidia-smi name and power limit) and the kernels' nvcc build;
  2. every hand-written kernel at every Visual Genome shape of the main path
     (batch 16, bf16) against its plain PyTorch version on the same card and
     inputs, with the tolerance stated per kernel, and bit-equal between two
     launches; kernel and plain times, and the roofline bound from the shapes;
  3. the slice: the full-width VG model (35,808,848 parameters, seeded
     weights, bf16) answers requests through ``serving.generate`` with 16 Heun
     steps; every kernel's launch count must move, the decoded graphs must be
     in range with zero padding, and the card's denoiser must agree with the
     fp32 plain model on the CPU on a small input; then ms per denoiser eval
     at batch 16 and 64;
  4. the training slice: the same model takes 8 training steps at batch 64
     through ``go_training`` on synthetic scene graphs (seed 0): finite losses,
     12 launches of each backward kernel per step, parameters, Adam moments
     and the 5 EMAs move and the EMAs follow their warm-up ramp, a checkpoint
     restores bit-equal state; the gradients of the card's bf16 kernel model
     are held against the fp32 plain model on the CPU at batch 4; then ms per
     training step at batch 64, its peak memory, the largest power-of-two
     batch that fits, and the profile of one step.
The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import torch

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3 bandwidth, H100 SXM data sheet
BATCH = 16
SRC = "diffusesg_torch/csrc/"
K1 = "diffusesg_tpu/ops/swin_block_v3.py:153"
K8 = "diffusesg_tpu/ops/mlp_block_kernel.py:52"
K2 = "diffusesg_tpu/ops/patch_resample.py:55"
K3 = "diffusesg_tpu/ops/patch_resample.py:162"
K4 = "diffusesg_tpu/ops/readout_kernel.py:41"
K5 = "diffusesg_tpu/ops/swin_block_v3.py:413"
K6 = "diffusesg_tpu/ops/mlp_block_kernel.py:145"
K7 = "diffusesg_tpu/ops/mlp_block_kernel.py:215"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median time of one eager call of ``fn`` (CUDA events around each
    call): device time plus whatever host time the call leaves the device
    idle for."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def graph_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: the call captured once in a CUDA
    graph, replayed ``reps`` times back to back between two events, so the
    host's launch overhead is not in the number."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------------ phase 2

def kernel_cases(dev):
    """(name, source, replaces, kernel fn, plain fn, args, flops, bytes, tol) at
    every VG shape the main path runs, batch 16, bf16.  ``tol`` = (atol, rtol,
    rel_max): an output agrees when |err| <= atol + rtol * |ref| + rel_max *
    max|ref| everywhere.  The forward kernels use the first two; the backward
    kernels' outputs are gradients whose scale grows with the token count, so
    theirs is relative: 2e-2 of the element plus 1e-2 of the tensor's max
    (bf16's 2^-8 ulp on the element, and cancellation near zero)."""
    from diffusesg_torch.models.layers import shifted_window_attn_mask
    from diffusesg_torch.ops import mlp_block_kernel as mk
    from diffusesg_torch.ops import patch_resample as pr
    from diffusesg_torch.ops import readout_kernel as rk
    from diffusesg_torch.ops import swin_block_v3 as sw

    gen = torch.Generator(device=dev).manual_seed(0)
    bf, f32, b = torch.bfloat16, torch.float32, BATCH

    def rnd(*shape, scale=1.0, dtype=bf, offset=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + offset).to(dtype)

    def lin(n_out, n_in):  # weight [out, in] at a scale that keeps outputs O(1)
        return rnd(n_out, n_in, scale=n_in ** -0.5)

    cases = []
    fwd_tol, bwd_tol = (3e-2, 2e-2, 0.0), (0.0, 2e-2, 1e-2)
    # swin_attn: (grid, C, heads, shift) of the 12 blocks of one eval
    for hw, c, heads, shift in ((64, 96, 3, 0), (32, 192, 6, 0), (16, 384, 12, 0),
                                (16, 384, 12, 4), (8, 768, 24, 0)):
        m, L = b * hw * hw, 64
        mask = (torch.from_numpy(shifted_window_attn_mask(hw, hw, 8, shift)).to(dev)
                if shift else None)
        args = (rnd(b, hw, hw, c), rnd(b, 2 * c, scale=0.5), rnd(c, dtype=f32, scale=0.1,
                offset=1.0), rnd(c, dtype=f32, scale=0.1), lin(3 * c, c),
                rnd(3 * c, dtype=f32, scale=0.1), lin(c, c), rnd(c, dtype=f32, scale=0.1),
                rnd(heads, L, L, dtype=f32), mask, heads, 8, shift)
        flops = 2 * m * c * 4 * c + 4 * m * L * c
        nbytes = (2 * m * c * 2 + b * 2 * c * 2 + 4 * c * c * 2 + heads * L * L * 4
                  + (mask.numel() * 4 if shift else 0) + 6 * c * 4)
        cases.append(("swin_attn", "swin_attn.cu", K1, sw.swin_attn, sw.swin_attn_block_plain,
                      args, flops, nbytes, fwd_tol))
        # its backward: x, scale_shift and dy in; nine gradients out
        bargs = args[:2] + (rnd(b, hw, hw, c),) + args[2:7] + args[8:]
        cases.append(("swin_attn_bwd", "swin_attn_bwd.cu", K5, sw.swin_attn_bwd,
                      sw.swin_attn_bwd_plain, bargs, 22 * m * c * c + 12 * m * L * c,
                      3 * m * c * 2 + 2 * b * 2 * c * 2 + 2 * 4 * c * c * 2
                      + 2 * heads * L * L * 4 + (mask.numel() * 4 if shift else 0)
                      + 2 * 6 * c * 4, bwd_tol))
    # token_mlp: the MLP half of every block (K8 at C=768)
    for hw, c in ((64, 96), (32, 192), (16, 384), (8, 768)):
        m = b * hw * hw
        args = (rnd(b, hw * hw, c), rnd(c, dtype=f32, scale=0.1, offset=1.0),
                rnd(c, dtype=f32, scale=0.1), lin(4 * c, c), rnd(4 * c, dtype=f32, scale=0.1),
                lin(c, 4 * c), rnd(c, dtype=f32, scale=0.1))
        cases.append(("token_mlp", "token_mlp.cu", K8 if c == 768 else K1, mk.token_mlp,
                      mk.mlp_block_plain, args, 16 * m * c * c,
                      2 * m * c * 2 + 8 * c * c * 2 + 6 * c * 4, fwd_tol))
        # its backward: x and dout in; seven gradients out (K7 is the C=768 case)
        bargs = (args[0].reshape(m, c), rnd(m, c)) + args[1:6]
        cases.append(("token_mlp_bwd", "token_mlp_bwd.cu", K7 if c == 768 else K6,
                      mk.token_mlp_bwd, mk.mlp_bwd_plain, bargs, 40 * m * c * c,
                      3 * m * c * 2 + 2 * 8 * c * c * 2 + 2 * 7 * c * 4, bwd_tol))
    # patch_merge: 64->32, 32->16, 16->8
    for hw, c in ((64, 96), (32, 192), (16, 384)):
        mo = b * (hw // 2) ** 2
        args = (rnd(b, hw, hw, c), rnd(4 * c, dtype=f32, scale=0.1, offset=1.0),
                rnd(4 * c, dtype=f32, scale=0.1), lin(2 * c, 4 * c))
        cases.append(("patch_merge", "patch_resample.cu", K2, pr.patch_merge,
                      pr.patch_merge_plain, args, 2 * mo * 4 * c * 2 * c,
                      b * hw * hw * c * 2 + 8 * c * c * 2 + mo * 2 * c * 2 + 8 * c * 4,
                      fwd_tol))
    # patch_breakup: [x | skip] 8->16, 16->32, 32->64
    for hw, cin, cout in ((8, 1536, 384), (16, 768, 192), (32, 384, 96)):
        mi, mo, dim = b * hw * hw, 4 * b * hw * hw, 4 * cout
        args = (rnd(b, hw, hw, cin // 2), rnd(b, hw, hw, cin // 2), lin(dim, cin),
                rnd(dim, dtype=f32, scale=0.1, offset=1.0), rnd(dim, dtype=f32, scale=0.1),
                rnd(cout, dtype=f32, scale=0.1, offset=1.0), rnd(cout, dtype=f32, scale=0.1),
                lin(cout, cout))
        cases.append(("patch_breakup", "patch_resample.cu", K3, pr.patch_breakup,
                      pr.patch_breakup_plain, args, 2 * mi * cin * dim + 2 * mo * cout * cout,
                      mi * cin * 2 + (cin * dim + cout * cout) * 2 + mo * cout * 2
                      + (2 * dim + 2 * cout) * 4, fwd_tol))
    # readout: the adjacency head over B*4096 tokens, the node head over B*64
    for m, n_out in ((b * 4096, 1), (b * 64, 5)):
        args = (rnd(m, 96), lin(96, 96), rnd(96, dtype=f32, scale=0.1), lin(n_out, 96),
                rnd(n_out, dtype=f32, scale=0.1))
        cases.append(("readout", "readout.cu", K4, rk.readout_mlp, rk.readout_mlp_plain,
                      args, 2 * m * 96 * (96 + n_out),
                      m * 96 * 2 + m * n_out * 4 + (96 + n_out) * 96 * 2 + (96 + n_out) * 4,
                      (2e-2, 2e-2, 0.0)))
    return cases


def check_kernels(dev, reps: int = 20):
    from diffusesg_torch.ops import cuda_build

    results = []
    for (name, src, replaces, kern, plain, args, flops, nbytes, tol) in kernel_cases(dev):
        atol, rtol, rel_max = tol
        before = dict(cuda_build.LAUNCHES)
        outs = kern(*args)
        torch.cuda.synchronize()
        keys = [k for k, v in cuda_build.LAUNCHES.items() if v != before.get(k, 0)]
        if len(keys) != 1 or keys[0][0] != name:
            fail(f"{name}: expected one launch of its kernel, saw {keys}")
        refs = plain(*args)
        torch.cuda.synchronize()
        if isinstance(outs, torch.Tensor):
            outs, refs = (outs,), (refs,)
        ok, max_abs, max_rel, max_of_max = len(outs) == len(refs), 0.0, 0.0, 0.0
        for i, (out, ref) in enumerate(zip(outs, refs)):
            if out.shape != ref.shape or out.dtype != ref.dtype or not torch.isfinite(out).all():
                fail(f"{name} {keys[0][1]} output {i}: shape {tuple(out.shape)} vs "
                     f"{tuple(ref.shape)}, dtype {out.dtype} vs {ref.dtype}, or non-finite")
            o, r = out.float(), ref.float()
            err = (o - r).abs()
            top = float(r.abs().max())
            max_abs = max(max_abs, float(err.max()))
            max_rel = max(max_rel, float((err / r.abs().clamp_min(1e-3)).max()))
            max_of_max = max(max_of_max, float(err.max()) / max(top, 1e-30))
            ok = ok and bool((err <= atol + rtol * r.abs() + rel_max * top).all())
        # no atomics anywhere: a second launch must give the same bits
        again = kern(*args)
        again = (again,) if isinstance(again, torch.Tensor) else again
        if not all(torch.equal(a, b) for a, b in zip(outs, again)):
            fail(f"{name} {keys[0][1]} is not bit-equal from launch to launch")
        ms = graph_ms(lambda: kern(*args), reps)
        eager_ms = time_ms(lambda: kern(*args), reps)
        plain_ms = graph_ms(lambda: plain(*args), max(3, reps // 4))
        bound_ms, bound_by = bound(flops, nbytes)
        results.append(dict(name=f"{name}@{keys[0][1]}", route="cuda", source=SRC + src,
                            replaces=replaces, kernel=name, key=keys[0], max_abs_err=max_abs,
                            max_err_over_max=max_of_max, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        log(f"kernel {name:13s} {keys[0][1]:22s} outputs={len(outs)} max_abs_err={max_abs:.3e} "
            f"max_rel_err={max_rel:.3e} max_err/max|ref|={max_of_max:.3e} "
            f"tol=atol {atol}+rtol {rtol}+{rel_max}*max ms={ms:.4f} "
            f"eager_ms={eager_ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
            f"({bound_by}, {bound_ms / ms:.1%} of it) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{name} {keys[0][1]} disagrees with its plain version")
    return results


# ------------------------------------------------------------------ phase 3

def check_decoded(adj, node, bbox, counts, n):
    b = len(counts)
    if adj.shape != (b, n, n) or node.shape != (b, n) or bbox.shape != (b, n, 4):
        fail(f"decoded shapes {tuple(adj.shape)} {tuple(node.shape)} {tuple(bbox.shape)}")
    if not torch.isfinite(bbox).all():
        fail("non-finite boxes")
    if int(node.min()) < 0 or int(node.max()) >= 150:
        fail("node types outside [0, 150)")
    if int(adj.min()) < 0 or int(adj.max()) >= 51:
        fail("edge types outside [0, 51)")
    for i, c in enumerate(counts):
        if (node[i, c:].any() or adj[i, c:].any() or adj[i, :, c:].any()
                or bbox[i, c:].any()):
            fail(f"request {i} ({c} nodes): padded slots are not zero")
    # boxes are 0.5 * x + 0.5 of the sample's last four node channels, not
    # clamped (as in the JAX decode, sampling/decode.py:30-35): with untrained
    # weights the samples end near N(0, 0.5^2), so some boxes leave [0, 1];
    # the share inside is reported, finiteness and zero padding are checked
    valid = torch.zeros_like(node, dtype=torch.bool)
    for i, c in enumerate(counts):
        valid[i, :c] = True
    vb = bbox[valid]
    return float(((vb >= 0) & (vb <= 1)).float().mean())


def check_slice(dev, smi: str):
    from diffusesg_torch.config import load_config
    from diffusesg_torch.models import build_model, count_params, make_model
    from diffusesg_torch.models.precond import precond_forward
    from diffusesg_torch.ops import cuda_build
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.serving import generate

    cfg = load_config("configs/edm_diffuse_sg_regular_visual_genome.yaml")
    with cfg.unlocked():
        cfg.mcmc.num_steps = 16
    model = build_model(cfg, device=dev, seed=0)
    n_params = count_params(model)
    if n_params != 35_808_848 or model.dtype != torch.bfloat16:
        fail(f"VG model has {n_params} parameters in {model.dtype}")
    sampler = get_mc_sampler(cfg)
    n = cfg.dataset.max_node_num
    requests = [[64, 40, 12, 5], [64] * 16]

    cuda_build.reset_launches()
    t0 = time.perf_counter()
    outs = [generate(model, sampler, cfg, counts, seed=i, device=dev)
            for i, counts in enumerate(requests)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_build.LAUNCHES)
    by_kernel = cuda_build.launches_by_kernel()
    in_box = [check_decoded(adj, node, bbox, counts, n)
              for (adj, node, bbox), counts in zip(outs, requests)]
    evals = 2 * (sampler.num_steps - 1) + 1
    log(f"slice: generate {requests[0]} and {len(requests[1])}x64 nodes, "
        f"{sampler.num_steps} Heun steps ({evals} denoiser evals each) in {wall:.2f} s; "
        f"launches {json.dumps(by_kernel, sort_keys=True)}; box coordinates in [0, 1]: "
        f"{in_box[0]:.1%} and {in_box[1]:.1%}")
    for name in ("swin_attn", "token_mlp", "patch_merge", "patch_breakup", "readout"):
        if by_kernel.get(name, 0) == 0:
            fail(f"the main path never launched {name}")
    edges = int((outs[1][0] > 0).sum())
    log(f"slice: decoded 16 full graphs with {edges} directed edges, node types "
        f"{int(outs[1][1].min())}..{int(outs[1][1].max())}")

    # the card's bf16 denoiser (kernels) vs the fp32 plain model on the CPU
    with cfg.unlocked():
        cfg.tpu.compute_dtype = "float32"
    ref = make_model(cfg)
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    gen = torch.Generator().manual_seed(5)
    flags = torch.zeros(2, n, dtype=torch.bool)
    flags[0, :64], flags[1, :23] = True, True
    x = dict(a=torch.randn(2, n, n, generator=gen), x=torch.randn(2, n, 5, generator=gen),
             s=torch.tensor([0.3, 4.0]), sa=torch.randn(2, n, n, generator=gen) * 0.5,
             sx=torch.randn(2, n, 5, generator=gen) * 0.5)
    with torch.inference_mode():
        c_noise = torch.log(x["s"]) / 4.0
        got = model(*(t.to(dev) for t in (x["a"], x["x"], flags, c_noise, x["sa"], x["sx"])))
        want = ref(x["a"], x["x"], flags, c_noise, x["sa"], x["sx"])
    for g, w, what in zip(got, want, ("adj", "node")):
        rel = float((g.float().cpu() - w).norm() / w.norm())
        log(f"slice: card bf16 denoiser vs CPU fp32 plain model, {what} output "
            f"relative L2 error {rel:.3e} (limit 5e-2)")
        if not rel < 5e-2:
            fail(f"{what} output disagrees with the fp32 plain model")

    # ms per denoiser eval
    timings = {}
    for b in (16, 64):
        f = torch.ones(b, n, dtype=torch.bool, device=dev)
        a = torch.randn(b, n, n, device=dev)
        nd = torch.randn(b, n, 5, device=dev)
        s = torch.full((b,), 2.0, device=dev)
        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats()
            ev = lambda: precond_forward(model, "edm", a, nd, f, s, a, nd)  # noqa: E731
            timings[b] = time_ms(ev, 5)
            dev_ms = graph_ms(ev, 5)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"slice: {timings[b]:.3f} ms per denoiser eval at batch {b} eager "
            f"({dev_ms:.3f} ms replayed as a CUDA graph; bf16, {timings[b] / b:.4f} ms per "
            f"graph, peak {peak:.2f} GiB) on {smi}")
    profile_eval(ev, timings[64])
    return launches


# ------------------------------------------------------------------ phase 4

TRAIN_BATCH = 64
# card bf16 kernels vs CPU fp32 plain, relative L2: the first run measured
# 9.4e-3 over the whole gradient and 4.0e-2 on the worst leaf (a
# relative-position bias table); the limits are about three times that
GRAD_REL_L2_LIMIT = 3e-2
GRAD_WORST_LEAF_LIMIT = 1.5e-1


def _forced(noise_cls, self_cond: bool):
    """A noise source whose self-conditioning draw is fixed."""
    class Forced(noise_cls):
        def bernoulli(self, step, kind, p):
            return self_cond
    return Forced


def check_gradients(cfg, model, dev):
    """One loss at batch 4 with the same draws on both sides: gradients of
    the card's bf16 model (kernels) vs the fp32 plain model on the CPU."""
    from diffusesg_torch.models import make_model
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train import make_loss_fn, train_step_config_from

    class CpuDraws(_forced(TorchNoise, True)):
        """Draws made on the CPU generator, handed over on ``target``."""
        def __init__(self, seed, target):
            super().__init__(seed, "cpu")
            self.target = target

        def normal(self, step, kind, shape):
            return super().normal(step, kind, shape).to(self.target)

    n = cfg.dataset.max_node_num
    gen = torch.Generator().manual_seed(11)
    flags = torch.zeros(4, n, dtype=torch.bool)
    for i, c in enumerate((64, 37, 12, 5)):
        flags[i, :c] = True
    pair = flags[:, :, None] & flags[:, None, :]
    adjs = (torch.rand(4, n, n, generator=gen) * 2 - 1) * pair
    nodes = torch.rand(4, n, 5, generator=gen) * 2 - 1
    nodes[..., -2:] = nodes[..., -2:] * 0.3 - 0.5  # box sizes 0.1 .. 0.4 of the image
    nodes = nodes * flags[:, :, None]

    step_cfg = train_step_config_from(cfg)
    with cfg.unlocked():
        dtype_name, cfg.tpu.compute_dtype = cfg.tpu.compute_dtype, "float32"
    ref = make_model(cfg)
    with cfg.unlocked():
        cfg.tpu.compute_dtype = dtype_name
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})

    def grads_of(m, device):
        loss, _ = make_loss_fn(m, step_cfg)(None, CpuDraws(3, device), 0, adjs.to(device),
                                            nodes.to(device), flags.to(device))
        return float(loss.detach()), torch.autograd.grad(loss, list(m.parameters()))

    from diffusesg_torch.ops import cuda_build
    cuda_build.reset_launches()
    loss_card, g_card = grads_of(model, dev)
    torch.cuda.synchronize()
    by_kernel = cuda_build.launches_by_kernel()
    t0 = time.perf_counter()
    loss_cpu, g_cpu = grads_of(ref, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    num = den = 0.0
    worst, worst_name = 0.0, ""
    for (name, _), gc, gr in zip(model.named_parameters(), g_card, g_cpu):
        gc = gc.float().cpu()
        if not torch.isfinite(gc).all():
            fail(f"gradient of {name} is not finite")
        ref_norm = float(gr.norm())
        if ref_norm > 0 and float(gc.norm()) == 0:
            fail(f"gradient of {name} is identically zero on the card, {ref_norm:.3e} on the CPU")
        err = float((gc - gr).norm())
        num, den = num + err ** 2, den + ref_norm ** 2
        if ref_norm > 0 and err / ref_norm > worst:
            worst, worst_name = err / ref_norm, name
    rel = (num / den) ** 0.5
    log(f"train: gradient check at batch 4 (self-conditioning pass on): loss {loss_card:.6f} "
        f"on the card, {loss_cpu:.6f} on the CPU ({cpu_s:.1f} s); whole-gradient relative L2 "
        f"{rel:.3e} (limit {GRAD_REL_L2_LIMIT}), worst leaf {worst:.3e} at {worst_name} "
        f"(limit {GRAD_WORST_LEAF_LIMIT}); {len(g_card)} leaves finite, none zero where the "
        f"CPU's is not; backward launches {by_kernel.get('swin_attn_bwd', 0)} + "
        f"{by_kernel.get('token_mlp_bwd', 0)}")
    if not (rel < GRAD_REL_L2_LIMIT and worst < GRAD_WORST_LEAF_LIMIT):
        fail("the card's gradients disagree with the fp32 plain model")
    if abs(loss_card - loss_cpu) > 5e-2 * abs(loss_cpu):
        fail("the card's loss disagrees with the fp32 plain model")


def check_training(dev, smi: str):
    from diffusesg_torch.config import load_config
    from diffusesg_torch.data import load_data
    from diffusesg_torch.models import build_model
    from diffusesg_torch.ops import cuda_build
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train import (create_train_state, ema_effective_decay, go_training,
                                       make_eval_step, make_optimizer, make_train_step,
                                       train_step_config_from)
    from diffusesg_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
    from diffusesg_torch.utils.logging_utils import set_seed_and_logger

    exp_dir = os.path.join("build", "smoke_runs")
    shutil.rmtree(exp_dir, ignore_errors=True)
    cfg = load_config("configs/edm_diffuse_sg_regular_visual_genome.yaml")
    with cfg.unlocked():
        cfg.seed = 0
        cfg.exp_dir = exp_dir
        cfg.train.batch_size = TRAIN_BATCH   # the config's 1000 is a multi-GPU global batch
        cfg.test.batch_size = TRAIN_BATCH
        cfg.train.max_epoch = 2              # 256 synthetic graphs: 4 steps per epoch
        cfg.dataset.synthetic_num_train = 4 * TRAIN_BATCH
        cfg.dataset.synthetic_num_test = TRAIN_BATCH
    set_seed_and_logger(cfg, mode="train", comment="smoke", log_level="WARNING")
    t0 = time.perf_counter()
    bundle = load_data(cfg, data_root="/nonexistent")
    log(f"train: {len(bundle.train)} + {len(bundle.test)} synthetic scene graphs in "
        f"{time.perf_counter() - t0:.1f} s")
    model = build_model(cfg, device=dev, seed=0)
    check_gradients(cfg, model, dev)

    betas = list(cfg.train.ema_coef)
    steps_per_epoch = len(bundle.train) // TRAIN_BATCH
    optimizer = make_optimizer(cfg.train.lr_init, cfg.train.lr_dacey, steps_per_epoch,
                               cfg.train.weight_decay)
    state = create_train_state(model, betas, optimizer)
    step_cfg = train_step_config_from(cfg)
    inner = make_train_step(model, step_cfg)
    p0 = [p.detach().clone() for p in state.params()]
    record = dict(losses=[], bwd=[], prev=None)

    @torch.no_grad()
    def max_diff(xs, ys):
        return float(torch.stack([d.abs().max() for d in torch._foreach_sub(xs, ys)]).max())

    def watched_step(st, noise, *batch):
        before = cuda_build.launches_by_kernel()
        done = st.step
        st, metrics = inner(st, noise, *batch)
        after = cuda_build.launches_by_kernel()
        record["losses"].append(metrics["loss"])
        record["bwd"].append(tuple(after.get(k, 0) - before.get(k, 0)
                                   for k in ("swin_attn_bwd", "token_mlp_bwd")))
        if done < 3:  # the EMA warm-up ramp: copy, copy, then min(beta, 1 - 1/3)
            params = [p.detach() for p in st.params()]
            for beta, ema in zip(st.ema_betas, st.ema_params):
                d = ema_effective_decay(beta, done)
                want = params if d == 0.0 else torch._foreach_add(
                    torch._foreach_mul(record["prev"], d), torch._foreach_mul(params, 1.0 - d))
                if max_diff(ema, want) > 1e-6:
                    fail(f"EMA {beta} is off its warm-up ramp after update {done + 1}")
            record["prev"] = [p.clone() for p in params]
        return st, metrics

    cuda_build.reset_launches()
    t0 = time.perf_counter()
    state = go_training(model, state, watched_step, make_eval_step(model, step_cfg), cfg, bundle,
                        mc_sampler=None, noise=TorchNoise(0, dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_build.LAUNCHES)
    losses = [float(x) for x in record["losses"]]
    log(f"train: {state.step} steps at batch {TRAIN_BATCH} through go_training in {wall:.2f} s "
        f"(first step and the epoch-0 test pass included); losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}; backward launches per step "
        f"(swin_attn_bwd, token_mlp_bwd) {sorted(set(record['bwd']))}")
    if state.step != 2 * steps_per_epoch or len(losses) != state.step:
        fail(f"expected {2 * steps_per_epoch} steps, ran {state.step}")
    if not all(x == x and abs(x) != float("inf") for x in losses):
        fail("a training loss is not finite")
    if set(record["bwd"]) != {(12, 12)}:
        fail(f"each backward must launch each backward kernel 12 times, saw {record['bwd']}")
    moved = max_diff(state.params(), p0)
    moments = [state.opt.state[p] for p in state.params()]
    if not (moved > 0 and all(float(m["exp_avg"].abs().max()) > 0 for m in moments[:8])
            and all(int(m["step"]) == state.step for m in moments)):
        fail("parameters or Adam moments did not move")
    ema_gaps = [max_diff(ema, state.params()) for ema in state.ema_params]
    if not (all(g > 0 for g in ema_gaps) and all(max_diff(ema, p0) > 0
                                                 for ema in state.ema_params)):
        fail(f"EMAs did not follow the parameters: {ema_gaps}")
    ckpts = sorted(os.listdir(cfg.model_ckpt_dir))
    log(f"train: parameters moved by up to {moved:.3e}; EMA-to-parameter gaps "
        f"{' '.join(f'{g:.2e}' for g in ema_gaps)} for betas {state.ema_betas}; EMAs on their "
        f"warm-up ramp for updates 1-3; checkpoints {ckpts}")
    if ckpts != ["00000.pt"]:
        fail(f"go_training wrote checkpoints {ckpts}")

    # checkpoint round trip: a second state restored from disk is bit-equal
    path = save_checkpoint(os.path.join(cfg.model_ckpt_dir, "roundtrip"), state, {"epoch": 1})
    other = create_train_state(build_model(cfg, device=dev, seed=1), betas, optimizer)
    extra = restore_checkpoint(path, other)
    same = (extra == {"epoch": 1} and other.step == state.step
            and max_diff(other.params(), state.params()) == 0
            and all(max_diff(a, b) == 0 for a, b in zip(other.ema_params, state.ema_params))
            and all(torch.equal(other.opt.state[q][k], state.opt.state[p][k])
                    for q, p in zip(other.params(), state.params())
                    for k in ("step", "exp_avg", "exp_avg_sq")))
    log(f"train: checkpoint {os.path.getsize(path) / 2 ** 20:.0f} MiB written and read back, "
        f"state bit-equal: {same}")
    if not same:
        fail("a restored checkpoint differs from the state that was saved")
    del other
    torch.cuda.empty_cache()

    # ms per training step, with and without the self-conditioning pass
    n = cfg.dataset.max_node_num
    sel = slice(0, TRAIN_BATCH)
    batch = tuple(torch.from_numpy(a[sel]).to(dev) for a in
                  (bundle.train.adjs, bundle.train.nodes, bundle.train.node_flags))
    step_ms = {}
    for sc in (False, True):
        noise = _forced(TorchNoise, sc)(1, dev)
        step_ms[sc] = time_ms(lambda: inner(state, noise, *batch), 5)
    torch.cuda.reset_peak_memory_stats()
    inner(state, noise, *batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train: {step_ms[False]:.3f} ms per training step at batch {TRAIN_BATCH} without the "
        f"self-conditioning pass, {step_ms[True]:.3f} ms with it (mean of the two "
        f"{(step_ms[False] + step_ms[True]) / 2:.3f} ms, {TRAIN_BATCH * 2e3 / (step_ms[False] + step_ms[True]):.1f} "
        f"graphs/s; bf16, eager), peak {peak:.2f} GiB on {smi}")
    profile_call(lambda: inner(state, noise, *batch),
                 f"one batch-{TRAIN_BATCH} training step with the self-conditioning pass",
                 step_ms[True])

    # the largest power-of-two batch whose step fits the card's memory
    fits, b = TRAIN_BATCH, 2 * TRAIN_BATCH
    while b <= 4096:
        big = (torch.zeros(b, n, n, device=dev), torch.zeros(b, n, 5, device=dev),
               torch.ones(b, n, dtype=torch.bool, device=dev))
        try:
            torch.cuda.reset_peak_memory_stats()
            inner(state, noise, *big)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            log(f"train: batch {b} does not fit (out of memory)")
            break
        finally:
            state.opt.zero_grad(set_to_none=True)
        fits = b
        log(f"train: batch {b} fits, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        b *= 2
    del big
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    log(f"train: largest power-of-two batch of a training step in {total:.0f} GiB: {fits}")
    return launches


# which kernel each device function belongs to (demangled-name fragments);
# the row pass before a block's first GEMM (AffineSrc, RowSrc) is the same
# function in a kernel's forward and in its backward's recompute: it is
# counted under the forward kernel's name
OTHER = "other PyTorch ops"
KERNEL_OF = (("window_attn_bwd_kernel", "swin_attn_bwd"), ("SwinBwd", "swin_attn_bwd"),
             ("MlpBwd", "token_mlp_bwd"), ("GeluAndGradEpi", "token_mlp_bwd"),
             ("ln_bwd_rows_kernel", "backward row pass + reductions (both backward kernels)"),
             ("reduce_partials_kernel", "backward row pass + reductions (both backward kernels)"),
             ("col_sums_kernel", "backward row pass + reductions (both backward kernels)"),
             ("window_attn_kernel", "swin_attn"), ("AffineSrc", "swin_attn"),
             ("SwinQkv", "swin_attn"), ("SwinProj", "swin_attn"),
             ("RowSrc", "token_mlp"), ("MlpFc", "token_mlp"),
             ("MergeSrc", "patch_merge"), ("MergeProj", "patch_merge"),
             ("BreakupIn", "patch_breakup"), ("F32RowSrc", "patch_breakup"),
             ("ScatterSrc", "patch_breakup"), ("BreakupOut", "patch_breakup"),
             ("ReadoutFc", "readout"))


def profile_eval(ev, eager_ms: float) -> None:
    """Device time of one batch-64 denoiser eval by kernel (torch.profiler),
    and the launches of each kernel in that eval."""
    with torch.inference_mode():
        profile_call(ev, "one batch-64 eval", eager_ms)


def profile_call(fn, what: str, eager_ms: float) -> None:
    """Device time of one call of ``fn`` by kernel (torch.profiler), and the
    launches of each kernel in that call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diffusesg_torch.ops import cuda_build

    cuda_build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_call = cuda_build.launches_by_kernel()
    groups: dict[str, float] = {}
    funcs, others = [], []
    for e in prof.key_averages():
        # a user annotation (Optimizer.step#...) repeats its kernels' time
        if e.device_type != DeviceType.CUDA or "#" in e.key:
            continue
        name = next((k for frag, k in KERNEL_OF if frag in e.key), OTHER)
        groups[name] = groups.get(name, 0.0) + e.device_time_total / 1e3
        short = e.key.rsplit("(", 1)[0] if e.key.endswith(")") else e.key
        row = (e.device_time_total / 1e3, e.count, short.removeprefix("void ")[:90])
        funcs.append(row)
        if name == OTHER:
            others.append(row)
    for label, rows in ((what, funcs), (f"{what}, {OTHER} only", others)):
        rows.sort(reverse=True)
        log(f"profile functions ({label}): "
            + "; ".join(f"{k} x{n} {t:.3f} ms" for t, n, k in rows[:16]))
    total = sum(groups.values())
    if total == 0:
        log("profile: torch.profiler recorded no device time")
        return
    parts = ", ".join(f"{k} {v:.3f} ms ({v / total:.1%}, {per_call.get(k, '-')} launches)"
                      for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))
    log(f"profile: {what}, device time {total:.3f} ms of {eager_ms:.3f} ms eager "
        f"(device busy {min(total / eager_ms, 1.0):.1%}): {parts}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-slice", action="store_true", help="skip phases 3 and 4")
    ap.add_argument("--no-train", action="store_true", help="skip phase 4")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = smi_line()
    log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from diffusesg_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.build(verbose=True)
    cuda_build.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {cuda_build.build_dir()}")

    results = check_kernels(dev)
    launches, train_launches = {}, {}
    if not args.no_slice:
        launches = check_slice(dev, smi)
        if not args.no_train:
            train_launches = check_training(dev, smi)
    # launches: of the sampling path for the forward kernels, of the training
    # path for the backward kernels; launches_train: of the training path
    for r in results:
        key, kernel = r.pop("key"), r.pop("kernel")
        r["launches_train"] = train_launches.get(key, 0)
        r["launches"] = r["launches_train"] if kernel.endswith("_bwd") else launches.get(key, 0)
        if r["launches"] == 0 and not (args.no_slice or (args.no_train and
                                                         kernel.endswith("_bwd"))):
            fail(f"{r['name']} was never launched on its main path")
    log(smi)
    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
