"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py            # every phase, as a CI check
    python3 chip_smoke.py --no-slice # build + kernels vs plain only

Phases, each printed on its own line:
  1. the card (nvidia-smi name and power limit) and the kernels' nvcc build;
  2. every hand-written kernel at every Visual Genome shape of the main path
     (batch 16, bf16) against its plain PyTorch version on the same card and
     inputs, with the tolerance stated per kernel; median kernel and plain
     times, and the roofline bound from the shapes;
  3. the slice: the full-width VG model (35,808,848 parameters, seeded
     weights, bf16) answers requests through ``serving.generate`` with 16 Heun
     steps; every kernel's launch count must move, the decoded graphs must be
     in range with zero padding, and the card's denoiser must agree with the
     fp32 plain model on the CPU on a small input; then ms per denoiser eval
     at batch 16 and 64.
The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import json
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
    """(name, source, replaces, kernel fn, plain fn, args, flops, bytes, atol, rtol)
    at every VG shape the main path runs, batch 16, bf16."""
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
                      args, flops, nbytes, 3e-2, 2e-2))
    # token_mlp: the MLP half of every block (K8 at C=768)
    for hw, c in ((64, 96), (32, 192), (16, 384), (8, 768)):
        m = b * hw * hw
        args = (rnd(b, hw * hw, c), rnd(c, dtype=f32, scale=0.1, offset=1.0),
                rnd(c, dtype=f32, scale=0.1), lin(4 * c, c), rnd(4 * c, dtype=f32, scale=0.1),
                lin(c, 4 * c), rnd(c, dtype=f32, scale=0.1))
        cases.append(("token_mlp", "token_mlp.cu", K8 if c == 768 else K1, mk.token_mlp,
                      mk.mlp_block_plain, args, 16 * m * c * c,
                      2 * m * c * 2 + 8 * c * c * 2 + 6 * c * 4, 3e-2, 2e-2))
    # patch_merge: 64->32, 32->16, 16->8
    for hw, c in ((64, 96), (32, 192), (16, 384)):
        mo = b * (hw // 2) ** 2
        args = (rnd(b, hw, hw, c), rnd(4 * c, dtype=f32, scale=0.1, offset=1.0),
                rnd(4 * c, dtype=f32, scale=0.1), lin(2 * c, 4 * c))
        cases.append(("patch_merge", "patch_resample.cu", K2, pr.patch_merge,
                      pr.patch_merge_plain, args, 2 * mo * 4 * c * 2 * c,
                      b * hw * hw * c * 2 + 8 * c * c * 2 + mo * 2 * c * 2 + 8 * c * 4,
                      3e-2, 2e-2))
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
                      + (2 * dim + 2 * cout) * 4, 3e-2, 2e-2))
    # readout: the adjacency head over B*4096 tokens, the node head over B*64
    for m, n_out in ((b * 4096, 1), (b * 64, 5)):
        args = (rnd(m, 96), lin(96, 96), rnd(96, dtype=f32, scale=0.1), lin(n_out, 96),
                rnd(n_out, dtype=f32, scale=0.1))
        cases.append(("readout", "readout.cu", K4, rk.readout_mlp, rk.readout_mlp_plain,
                      args, 2 * m * 96 * (96 + n_out),
                      m * 96 * 2 + m * n_out * 4 + (96 + n_out) * 96 * 2 + (96 + n_out) * 4,
                      2e-2, 2e-2))
    return cases


def check_kernels(dev, reps: int = 20):
    from diffusesg_torch.ops import cuda_build

    results = []
    for (name, src, replaces, kern, plain, args, flops, nbytes, atol, rtol) in kernel_cases(dev):
        before = dict(cuda_build.LAUNCHES)
        out = kern(*args)
        torch.cuda.synchronize()
        keys = [k for k, v in cuda_build.LAUNCHES.items() if v != before.get(k, 0)]
        if len(keys) != 1 or keys[0][0] != name:
            fail(f"{name}: expected one launch of its kernel, saw {keys}")
        ref = plain(*args)
        torch.cuda.synchronize()
        if out.shape != ref.shape or not torch.isfinite(out).all():
            fail(f"{name} {keys[0][1]}: shape {tuple(out.shape)} vs {tuple(ref.shape)} "
                 "or non-finite output")
        o, r = out.float(), ref.float()
        err = (o - r).abs()
        max_abs = float(err.max())
        max_rel = float((err / r.abs().clamp_min(1e-3)).max())
        ok = bool((err <= atol + rtol * r.abs()).all())
        ms = graph_ms(lambda: kern(*args), reps)
        eager_ms = time_ms(lambda: kern(*args), reps)
        plain_ms = graph_ms(lambda: plain(*args), max(3, reps // 4))
        bound_ms, bound_by = bound(flops, nbytes)
        results.append(dict(name=f"{name}@{keys[0][1]}", route="cuda", source=SRC + src,
                            replaces=replaces, kernel=name, key=keys[0], max_abs_err=max_abs,
                            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=None))
        log(f"kernel {name:13s} {keys[0][1]:22s} max_abs_err={max_abs:.3e} "
            f"max_rel_err={max_rel:.3e} tol=atol {atol}+rtol {rtol} ms={ms:.4f} "
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


# which kernel each device function belongs to (demangled-name fragments)
KERNEL_OF = (("window_attn_kernel", "swin_attn"), ("AffineSrc", "swin_attn"),
             ("SwinQkv", "swin_attn"), ("SwinProj", "swin_attn"),
             ("RowSrc", "token_mlp"), ("MlpFc", "token_mlp"),
             ("MergeSrc", "patch_merge"), ("MergeProj", "patch_merge"),
             ("BreakupIn", "patch_breakup"), ("F32RowSrc", "patch_breakup"),
             ("ScatterSrc", "patch_breakup"), ("BreakupOut", "patch_breakup"),
             ("ReadoutFc", "readout"))


def profile_eval(ev, eager_ms: float) -> None:
    """Device time of one batch-64 denoiser eval by kernel (torch.profiler),
    and the launches of each kernel in that eval."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diffusesg_torch.ops import cuda_build

    cuda_build.reset_launches()
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        ev()
        torch.cuda.synchronize()
    per_eval = cuda_build.launches_by_kernel()
    groups: dict[str, float] = {}
    funcs = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        name = next((k for frag, k in KERNEL_OF if frag in e.key), "other PyTorch ops")
        groups[name] = groups.get(name, 0.0) + e.device_time_total / 1e3
        short = e.key.rsplit("(", 1)[0] if e.key.endswith(")") else e.key
        funcs.append((e.device_time_total / 1e3, e.count, short.removeprefix("void ")[:90]))
    funcs.sort(reverse=True)
    log("profile functions: " + "; ".join(f"{k} x{n} {t:.3f} ms" for t, n, k in funcs[:12]))
    total = sum(groups.values())
    if total == 0:
        log("profile: torch.profiler recorded no device time")
        return
    parts = ", ".join(f"{k} {v:.3f} ms ({v / total:.1%}, {per_eval.get(k, '-')} launches)"
                      for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))
    log(f"profile: one batch-64 eval, device time {total:.3f} ms of {eager_ms:.3f} ms eager "
        f"(device busy {min(total / eager_ms, 1.0):.1%}): {parts}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-slice", action="store_true", help="skip phase 3")
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
    launches = {}
    if not args.no_slice:
        launches = check_slice(dev, smi)
    for r in results:
        r["launches"] = launches.get(r.pop("key"), 0)
        r.pop("kernel")
    log(smi)
    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
