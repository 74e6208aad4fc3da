"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py            # every phase, as a CI check
    python3 chip_smoke.py --no-slice # build + kernels vs plain only
    python3 chip_smoke.py --no-train # phases 1-3, 5 and 7-9 (8 from a seeded checkpoint)

Phases, each printed on its own line:
  1. the card (nvidia-smi name and power limit), the kernels' nvcc build, and
     the built library's SASS: every wgmma kernel (each hgemm_kernel, the
     readout_kernel and the fused MLP backward mlp_bwd_kernel) must issue
     HGMMA instructions, and no other GEMM kernel may be in the library;
     the micro-benchmark's mm_accumulate_wgmma must issue HGMMA (bf16) and
     IGMMA (int8) and no WMMA-era HMMA / IMMA;
  2. every hand-written kernel at every Visual Genome and COCO-Stuff shape of
     the main paths (batch 16, bf16) and the four TPU kernels with an entry of
     their own (window_attention, mm_accumulate, and the pre-rolled block
     entries swin_attn_block and swin_full_block, which own no device
     function and launch swin_attn and token_mlp) against its plain PyTorch
     version on the same card and inputs, with the tolerance stated per
     kernel, and bit-equal between two launches; one call must move exactly
     the launch counters of the kernels it launches; kernel and plain times,
     the roofline bound from the shapes and, where a PyTorch library call
     computes the same function, the time of that library doing the same work;
     for swin_attn, patch_merge, patch_breakup, readout, swin_attn_bwd and
     token_mlp_bwd also the device time and count of each of their launches
     (torch.profiler) beside a yardstick of the same products in PyTorch
     (bf16, timed only): F.layer_norm + F.linear for qkv, merge and the qkv
     recompute, F.linear for the others, F.linear, F.gelu, F.linear for
     readout, torch.mm for the backward's products with an untransposed
     weight and for its weight gradients (a^T b over the tokens); for
     mm_accumulate one torch.bmm over stride-0 batches and torch.matmul
     looped (bf16), torch._int_mm looped (int8), each doing as many products
     as the kernel, and its time at 128 products, which must be at least
     1.6x its time at 64;
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
     are held against the fp32 plain model on the CPU at batch 4 (a leaf that
     the plain model in bf16 cannot hold under the limit either is held at
     the kernel instead, against its plain backward on the same inputs, on 8
     batches, beside its window core alone, its recomputed operands in bf16
     ulps and two controls without the kernel); then ms per training step at
     batch 64, its peak memory, the largest power-of-two batch that fits, and
     the profile of one step (the window core and the fused MLP under their
     own names);
  5. the COCO-Stuff slice: the full-width COCO model (30,690,020 parameters,
     window 10, bf16) answers requests of 40, 33, 12 and 5 nodes and then 16
     full graphs through ``serving.generate``, checked as phase 3 (node types
     < 171, edge types < 7); then the kernels with an entry of their own are
     driven through those entries: ``WindowAttention.forward`` of the model's
     shifted block against the fp32 CPU module, ``fused_swin_attn_block`` and
     ``fused_swin_block`` on a pre-rolled grid against the model's own block,
     and ``scripts/microbench_int8_torch.py``;
  6. the COCO-Stuff training slice: 8 steps at batch 64 through
     ``go_training`` as phase 4, 18 launches of each backward kernel per step;
  7. ``configs/vg_small_test.yaml``, whose ``tpu`` block switches the kernels
     off (float32, head_dim 16, which no kernel covers): its denoiser on the
     card against the same fp32 plain model on the CPU (relative L2 1e-4),
     then two training steps through ``cli.train`` with its default device;
     no kernel may launch;
  8. the eval slice on the full-width VG model (kernels on, bf16; 16 Heun
     steps, an eval set of 64 synthetic graphs at batch 64): ``go_training``
     with the sampler for epochs 0 and 1 (epoch 0's sanity check reads every
     MMD 0.0; the training state bit-equal around each pass; under
     ``--no-train`` a checkpoint of the seeded model instead), then
     ``cli.eval`` on the checkpoint with its default device, plain and with
     ``--inpaint_frac 0.5``: every metric of the JAX package's block present
     and finite, the artifacts written, the known entries of the inpainted
     graphs equal to the ground truth's decode, the native VOC F1 built and
     equal to numpy, every forward kernel launched; the first denoised output
     of the inpainted sample, and the network's output inside it, against
     the fp32 plain model on the card (relative L2 5e-2), the final samples'
     distance as a reading; seconds of
     sampling + decode and of metrics + artifacts, graphs/s, peak memory and
     whether plots were written (the card's machine has no matplotlib);
  9. the serving slice on the full-width VG model (seeded weights, bf16,
     kernels on; 16 Heun steps, a served batch of 16): a reference-schema
     ``.pth`` of it (``module.model.`` prefixes, the two buffers the
     reference saves, 5 EMA sets) through ``cli.import_ckpt``, bit-equal in
     the run dir; ``cli.serve``'s loader, ``BatchingSampler`` and ``serve``
     in this process: warm-up, a burst of 8 unseeded ``/v1/generate``
     requests packed into fewer batches with every answer in range, a
     seeded request twice identical and equal to the serving core at that
     seed (its all-False padding rows zero, the other rows bit-equal with
     them filled instead), ``/v1/complete`` with its pinned parts verbatim,
     ``/healthz``; every forward kernel launched and no backward kernel;
     ``chunk_steps=4`` equal to the unchunked run; ``cli.serve
     --export_to`` and ``load_artifact`` equal to the live server, an
     artifact for the CPU refused; ``python -m diffusesg_torch.cli.serve``
     as a process from the run dir and from the artifact (``/v1/complete``
     501 there) answering the seeded request as this process did; readings:
     graphs/s through HTTP at batch 16 and 64, batch latency p50 / p95, the
     warm-up seconds, the served FLOP/s and its share of the bf16 peak
     (``utils/perf.py``), peak memory.
Launch counts are set to 0 before each of phases 3-9 and read after it.
The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import torch

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak, H100 SXM data sheet
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
K9 = "diffusesg_tpu/ops/swin_full_block.py:123"
K10 = "diffusesg_tpu/ops/swin_block_kernel.py:81"
K11 = "diffusesg_tpu/ops/window_attention.py:47"
K12 = "scripts/microbench_int8.py:17"
VG = dict(tag="VG", path="vg", config="configs/edm_diffuse_sg_regular_visual_genome.yaml",
          params=35_808_848, node_types=150, edge_types=51, requests=[64, 40, 12, 5],
          small=(64, 23), blocks=12)
COCO = dict(tag="COCO", path="coco", config="configs/edm_diffuse_sg_regular_coco.yaml",
            params=30_690_020, node_types=171, edge_types=7, requests=[40, 33, 12, 5],
            small=(40, 17), blocks=18)


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


def bound(flops: float, nbytes: float, peak: float = H100_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


WGMMA_KERNELS = ("hgemm_kernel", "readout_kernel", "mlp_bwd_kernel")
MM_KERNEL = "mm_accumulate_wgmma"  # K12: an instantiation per type, tile and K tail
# the warpgroup MMA of each K12 instantiation: HGMMA for bf16 operands,
# IGMMA for int8 ones; WMMA-era mma.sync (HMMA, IMMA) in none
MM_SASS = {"bf16": "HGMMA", "int8": "IGMMA"}


def check_sass(lib_path) -> None:
    """The wgmma kernels of the built library issue wgmma: count the HGMMA
    instructions of every hgemm_kernel instantiation (the forward and
    backward GEMM sites), of readout_kernel and of the fused MLP backward
    mlp_bwd_kernel (cuobjdump -sass); and the port has one GEMM: no other
    *gemm_kernel is left in the library.  K12's mm_accumulate_wgmma: every
    bf16 instantiation issues HGMMA and every int8 one IGMMA, none issues a
    WMMA-era HMMA or IMMA, and no mm_accumulate_kernel is left."""
    import re

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump: {out.stderr.strip()[:200]}")
    counts, func, others, mm_ops, old_mm = {}, None, [], {}, []
    for line in out.stdout.splitlines():
        if "Function :" in line:
            func = line.split("Function :", 1)[1].strip()
            if any(k in func for k in WGMMA_KERNELS):
                counts[func] = 0
            if re.search(r"(?<!h)gemm_kernel", func):
                others.append(func)
            if MM_KERNEL in func:
                mm_ops[func] = collections.Counter()
            if "mm_accumulate_kernel" in func:
                old_mm.append(func)
        elif func in counts and "HGMMA" in line:
            counts[func] += 1
        elif func in mm_ops:
            mm_ops[func].update(re.findall(r"\b([A-Z]*MMA)\b", line))
    for k in WGMMA_KERNELS:
        mine = sorted(n for f, n in counts.items() if k in f)
        log(f"sass: {len(mine)} {k} instantiations, HGMMA instructions in each: {mine}")
        if not mine or min(mine) == 0:
            fail(f"a {k} issues no HGMMA instruction")
    if others:
        fail(f"a GEMM other than hgemm_kernel is in the library: {others[:3]}")
    if old_mm:
        fail(f"the WMMA-era mm_accumulate_kernel is still in the library: {old_mm[:2]}")
    by_type = {t: [ops for f, ops in mm_ops.items() if ("bfloat16" in f) == (t == "bf16")]
               for t in MM_SASS}
    for t, want in MM_SASS.items():
        log(f"sass: {len(by_type[t])} {MM_KERNEL} {t} instantiations (tile x K tail), {want} "
            f"instructions in each: {sorted(ops[want] for ops in by_type[t])}, HMMA or IMMA in "
            f"any: {sum(ops['HMMA'] + ops['IMMA'] for ops in by_type[t])}")
        if not by_type[t] or any(ops[want] == 0 or ops["HMMA"] or ops["IMMA"]
                                 for ops in by_type[t]):
            fail(f"a {t} {MM_KERNEL} does not issue {want}, or issues HMMA / IMMA")


# ------------------------------------------------------------------ phase 2

@dataclasses.dataclass
class Case:
    """One kernel at one shape: the wrapper, its plain version, the inputs,
    the work (operations and bytes) and the tolerance.  ``path`` names the
    phase whose launch count the case reports: "vg" (phases 3 and 4), "coco"
    (phases 5 and 6) or "entries" (the kernels' own entries, phase 5).
    ``tol`` = (atol, rtol, rel_max): an output agrees when |err| <= atol +
    rtol * |ref| + rel_max * max|ref| everywhere.  ``counts`` names the
    kernels whose launch counters one call must move, each by one and no
    other: the case's own name unless the entry launches other kernels (the
    pre-rolled block entries own no device function: they launch
    ``swin_attn`` and ``token_mlp``).  ``library`` is a PyTorch library's
    kernels doing the same work (a yardstick, timed only); ``gemms`` names a
    kernel's launches to time one by one, each with a yardstick of its
    products in PyTorch (cuBLAS; timed only); ``graph_plain`` is False for a plain version that
    leaves the card and cannot be captured.  ``yardsticks`` are further
    library calls doing the same work (name -> callable; timed only);
    ``more_work`` are arguments with twice the work, whose time must be at
    least 1.6x the case's (a kernel that skips work fails it)."""
    name: str
    src: str
    replaces: str
    kern: object
    plain: object
    args: tuple
    flops: float
    nbytes: float
    tol: tuple
    path: str
    counts: tuple = ()
    library: object = None
    gemms: tuple = ()  # (label, device-function name fragment, yardstick or None)
    products: dict = None
    peak: float = H100_BF16_FLOPS
    graph_plain: bool = True
    yardsticks: dict = None
    more_work: tuple = None


def kernel_cases(dev):
    """Every kernel case, batch 16, bf16.  The forward kernels' tolerance is
    absolute plus relative; the backward kernels' outputs are gradients whose
    scale grows with the token count, so theirs is relative: 2e-2 of the
    element plus 1e-2 of the tensor's max (bf16's 2^-8 ulp on the element,
    and cancellation near zero)."""
    import torch.nn.functional as F

    from diffusesg_torch.models.layers import shifted_window_attn_mask
    from diffusesg_torch.ops import mlp_block_kernel as mk
    from diffusesg_torch.ops import mm_microbench as mm
    from diffusesg_torch.ops import patch_resample as pr
    from diffusesg_torch.ops import readout_kernel as rk
    from diffusesg_torch.ops import swin_block_kernel as sk
    from diffusesg_torch.ops import swin_block_v3 as sw
    from diffusesg_torch.ops import swin_full_block as sf
    from diffusesg_torch.ops import window_attention as wa

    gen = torch.Generator(device=dev).manual_seed(0)
    bf, f32, b = torch.bfloat16, torch.float32, BATCH

    def rnd(*shape, scale=1.0, dtype=bf, offset=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + offset).to(dtype)

    def lin(n_out, n_in):  # weight [out, in] at a scale that keeps outputs O(1)
        return rnd(n_out, n_in, scale=n_in ** -0.5)

    def shift_mask(hw, window, shift):
        return torch.from_numpy(shifted_window_attn_mask(hw, hw, window, shift)).to(dev)

    def attn_args(hw, c, heads, window, shift):
        L = window * window
        return (rnd(b, hw, hw, c), rnd(b, 2 * c, scale=0.5),
                rnd(c, dtype=f32, scale=0.1, offset=1.0), rnd(c, dtype=f32, scale=0.1),
                lin(3 * c, c), rnd(3 * c, dtype=f32, scale=0.1), lin(c, c),
                rnd(c, dtype=f32, scale=0.1), rnd(heads, L, L, dtype=f32),
                shift_mask(hw, window, shift) if shift else None)

    def attn_work(hw, c, heads, window, mask):
        m, L = b * hw * hw, window * window
        flops = 2 * m * c * 4 * c + 4 * m * L * c
        nbytes = (2 * m * c * 2 + b * 2 * c * 2 + 4 * c * c * 2 + heads * L * L * 4
                  + (mask.numel() * 4 if mask is not None else 0) + 6 * c * 4)
        return flops, nbytes

    def linear(m, n_in, n_out, bias=True):
        """cuBLAS doing one product of a kernel (bf16 Linear): the yardstick."""
        a, w = rnd(m, n_in), lin(n_out, n_in)
        bias = rnd(n_out, scale=0.1) if bias else None
        return lambda: F.linear(a, w, bias)

    def ln_linear(m, c, n_out, bias=True):
        """The same with the LayerNorm before it (swin_attn's qkv prologue,
        patch_merge's on rows already gathered)."""
        a, g, bt, w = rnd(m, c), rnd(c), rnd(c), lin(n_out, c)
        bias = rnd(n_out, scale=0.1) if bias else None
        return lambda: F.linear(F.layer_norm(a, (c,), g, bt, 1e-6), w, bias)

    def mm_nn(m, k, n):
        """cuBLAS doing a product that takes a Linear weight untransposed:
        [m, k] x [k, n] (dout W2, dy Wproj, du W1, dqkv Wqkv)."""
        a, w = rnd(m, k), lin(k, n)
        return lambda: torch.mm(a, w)

    def mm_tn(m, i, j):
        """cuBLAS doing a weight gradient: the contraction over m tokens of
        [m, i] and [m, j] into [i, j]."""
        a, b_ = rnd(m, i), rnd(m, j)
        return lambda: torch.mm(a.t(), b_)

    def mlp_bwd_products(m, c):
        """The three row-tile products of token_mlp_bwd in cuBLAS: fc1
        recomputed, dout W2 and du W1."""
        hn, w1, do, w2, du = rnd(m, c), lin(4 * c, c), rnd(m, c), lin(c, 4 * c), rnd(m, 4 * c)
        return lambda: (F.linear(hn, w1), torch.mm(do, w2), torch.mm(du, w1))

    # the launches of the backward kernels by their call-site tags (the fused
    # MLP path and the chain launch different ones; a fragment that matches
    # no launch is not printed)
    def mlp_bwd_launches(m, c):
        return (("fused row tile", "MlpBwdFused", mlp_bwd_products(m, c)),
                ("fc1 recompute", "MlpBwdFc1", linear(m, c, 4 * c)),
                ("dm = dout W2", "MlpBwdDm", mm_nn(m, c, 4 * c)),
                ("dW2", "MlpBwdDw2", mm_tn(m, c, 4 * c)),
                ("dW1", "MlpBwdDw1", mm_tn(m, 4 * c, c)),
                ("column sums", "col_sums_kernel", None),
                ("dhn = du W1", "MlpBwdDhn", mm_nn(m, 4 * c, c)),
                ("LN2 vjp row pass", "ln_bwd_rows_kernel", None),
                ("reductions", "reduce_partials_kernel", None))

    def attn_bwd_launches(m, c):
        return (("qkv recompute", "SwinBwdQkv", ln_linear(m, c, 3 * c)),
                ("dattn = dy Wproj", "SwinBwdDattn", mm_nn(m, c, c)),
                ("window core", "window_attn_bwd_kernel", None),
                ("dWproj", "SwinBwdDwproj", mm_tn(m, c, c)),
                ("dWqkv", "SwinBwdDwqkv", mm_tn(m, 3 * c, c)),
                ("column sums", "col_sums_kernel", None),
                ("dhn = dqkv Wqkv", "SwinBwdDhn", mm_nn(m, 3 * c, c)),
                ("LN1 vjp row pass", "ln_bwd_rows_kernel", None),
                ("reductions", "reduce_partials_kernel", None))

    def two_linear(m, c, hidden, n_out):
        """readout's two products and the GELU between them, in PyTorch."""
        a, w1, b1 = rnd(m, c), lin(hidden, c), rnd(hidden, scale=0.1)
        w2, b2 = lin(n_out, hidden), rnd(n_out, scale=0.1)
        return lambda: F.linear(F.gelu(F.linear(a, w1, b1)), w2, b2)

    def mlp_args(c):
        return (rnd(c, dtype=f32, scale=0.1, offset=1.0), rnd(c, dtype=f32, scale=0.1),
                lin(4 * c, c), rnd(4 * c, dtype=f32, scale=0.1), lin(c, 4 * c),
                rnd(c, dtype=f32, scale=0.1))

    cases = []
    fwd_tol, bwd_tol = (3e-2, 2e-2, 0.0), BWD_TOL
    models = (("vg", 8, ((64, 96, 3, 0), (32, 192, 6, 0), (16, 384, 12, 0), (16, 384, 12, 4),
                         (8, 768, 24, 0))),
              ("coco", 10, ((40, 96, 3, 0), (20, 192, 6, 0), (20, 192, 6, 5), (10, 384, 12, 0))))
    for path, window, blocks in models:
        # swin_attn: (grid, C, heads, shift) of the Swin blocks of one eval
        for hw, c, heads, shift in blocks:
            m, L = b * hw * hw, window * window
            args = attn_args(hw, c, heads, window, shift) + (heads, window, shift)
            mask = args[9]
            flops, nbytes = attn_work(hw, c, heads, window, mask)
            cases.append(Case("swin_attn", "swin_attn.cu", K1, sw.swin_attn,
                              sw.swin_attn_block_plain, args, flops, nbytes, fwd_tol, path,
                              gemms=(("qkv GEMM", "SwinQkv", ln_linear(m, c, 3 * c)),
                                     ("window core", "window_attn_kernel<", None),
                                     ("proj GEMM", "SwinProj", linear(m, c, c)))))
            # its backward: x, scale_shift and dy in; nine gradients out
            bargs = args[:2] + (rnd(b, hw, hw, c),) + args[2:7] + args[8:]
            cases.append(Case(
                "swin_attn_bwd", "swin_attn_bwd.cu", K5, sw.swin_attn_bwd, sw.swin_attn_bwd_plain,
                bargs, 22 * m * c * c + 12 * m * L * c,
                3 * m * c * 2 + 2 * b * 2 * c * 2 + 2 * 4 * c * c * 2 + 2 * heads * L * L * 4
                + (mask.numel() * 4 if shift else 0) + 2 * 6 * c * 4, bwd_tol, path,
                gemms=attn_bwd_launches(m, c)))
        # token_mlp: the MLP half of every block (K8 at C=768)
        for hw, c in sorted({(hw, c) for hw, c, _, _ in blocks}, reverse=True):
            m = b * hw * hw
            args = (rnd(b, hw * hw, c),) + mlp_args(c)
            cases.append(Case("token_mlp", "token_mlp.cu", K8 if c == 768 else K1, mk.token_mlp,
                              mk.mlp_block_plain, args, 16 * m * c * c,
                              2 * m * c * 2 + 8 * c * c * 2 + 6 * c * 4, fwd_tol, path))
            # its backward: x and dout in; seven gradients out (K7 is the C=768 case)
            bargs = (args[0].reshape(m, c), rnd(m, c)) + args[1:6]
            cases.append(Case("token_mlp_bwd", "token_mlp_bwd.cu", K7 if c == 768 else K6,
                              mk.token_mlp_bwd, mk.mlp_bwd_plain, bargs, 40 * m * c * c,
                              3 * m * c * 2 + 2 * 8 * c * c * 2 + 2 * 7 * c * 4, bwd_tol, path,
                              gemms=mlp_bwd_launches(m, c)))
        grids = sorted({(hw, c) for hw, c, _, _ in blocks}, reverse=True)
        # patch_merge: every stage but the last halves its grid
        for hw, c in grids[:-1]:
            mo = b * (hw // 2) ** 2
            args = (rnd(b, hw, hw, c), rnd(4 * c, dtype=f32, scale=0.1, offset=1.0),
                    rnd(4 * c, dtype=f32, scale=0.1), lin(2 * c, 4 * c))
            cases.append(Case("patch_merge", "patch_resample.cu", K2, pr.patch_merge,
                              pr.patch_merge_plain, args, 2 * mo * 4 * c * 2 * c,
                              b * hw * hw * c * 2 + 8 * c * c * 2 + mo * 2 * c * 2 + 8 * c * 4,
                              fwd_tol, path,
                              gemms=(("merge GEMM", "MergeProj",
                                      ln_linear(mo, 4 * c, 2 * c, bias=False)),)))
        # patch_breakup: [x | skip] back up the same grids
        for hw, c in grids[:0:-1]:
            cin, cout = 2 * c, c // 2
            mi, mo, dim = b * hw * hw, 4 * b * hw * hw, 4 * cout
            args = (rnd(b, hw, hw, cin // 2), rnd(b, hw, hw, cin // 2), lin(dim, cin),
                    rnd(dim, dtype=f32, scale=0.1, offset=1.0), rnd(dim, dtype=f32, scale=0.1),
                    rnd(cout, dtype=f32, scale=0.1, offset=1.0), rnd(cout, dtype=f32, scale=0.1),
                    lin(cout, cout))
            cases.append(Case("patch_breakup", "patch_resample.cu", K3, pr.patch_breakup,
                              pr.patch_breakup_plain, args,
                              2 * mi * cin * dim + 2 * mo * cout * cout,
                              mi * cin * 2 + (cin * dim + cout * cout) * 2 + mo * cout * 2
                              + (2 * dim + 2 * cout) * 4, fwd_tol, path,
                              gemms=(("first GEMM", "BreakupIn", linear(mi, cin, dim, False)),
                                     ("row pass", "breakup_rows_kernel", None),
                                     ("second GEMM", "BreakupOut",
                                      linear(mo, cout, cout, False)))))
        # readout: the adjacency head over B*N*N tokens, the node head over B*N
        n = grids[0][0]
        for m, n_out in ((b * n * n, 1), (b * n, 5)):
            args = (rnd(m, 96), lin(96, 96), rnd(96, dtype=f32, scale=0.1), lin(n_out, 96),
                    rnd(n_out, dtype=f32, scale=0.1))
            cases.append(Case("readout", "readout.cu", K4, rk.readout_mlp, rk.readout_mlp_plain,
                              args, 2 * m * 96 * (96 + n_out),
                              m * 96 * 2 + m * n_out * 4 + (96 + n_out) * 96 * 2
                              + (96 + n_out) * 4, (2e-2, 2e-2, 0.0), path,
                              gemms=(("readout", "readout_kernel",
                                      two_linear(m, 96, 96, n_out)),)))

    # window_attention (K11): [B * nW, nH, L, 32] at a VG and a COCO stage each,
    # with and without the shift mask, one with a scale that is not hd^-0.5
    for hw, heads, window, shift, scale in ((64, 3, 8, 0, 32 ** -0.5), (16, 12, 8, 4, 32 ** -0.5),
                                            (40, 3, 10, 0, 0.25), (20, 6, 10, 5, 32 ** -0.5)):
        L, nwb = window * window, b * (hw // window) ** 2
        q, k, v = (rnd(nwb, heads, L, 32) for _ in range(3))
        rel = rnd(heads, L, L, dtype=f32)
        mask = shift_mask(hw, window, shift) if shift else None
        bias = rel[None].expand(nwb, -1, -1, -1)
        if mask is not None:
            bias = bias + mask.repeat(nwb // mask.shape[0], 1, 1)[:, None]
        bias = bias.to(bf).contiguous()
        cases.append(Case(
            "window_attention", "window_attention.cu", K11, wa.fused_window_attention_qkhd,
            wa.attention_plain, (q, k, v, rel, mask, scale), 4 * nwb * heads * L * L * 32,
            4 * q.numel() * 2 + rel.numel() * 4 + (mask.numel() * 4 if shift else 0), fwd_tol,
            "entries",
            library=lambda q=q, k=k, v=v, bias=bias, scale=scale: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, scale=scale)))
    # swin_attn_block (K10) and swin_full_block (K9): a pre-rolled grid with the
    # shift mask, one VG and one COCO stage each; their launches are those of
    # swin_attn (and token_mlp), whose counters they move
    for hw, c, heads, window, shift in ((16, 384, 12, 8, 4), (20, 192, 6, 10, 5)):
        args = attn_args(hw, c, heads, window, shift)
        flops, nbytes = attn_work(hw, c, heads, window, args[9])
        cases.append(Case("swin_attn_block", "swin_attn.cu", K10, sk.fused_swin_attn_block,
                          sk.swin_attn_block_plain, args + (heads, window), flops, nbytes,
                          fwd_tol, "entries", counts=("swin_attn",)))
        m = b * hw * hw
        cases.append(Case("swin_full_block", "swin_attn.cu", K9,
                          sf.fused_swin_block, sf.swin_block_plain,
                          args + mlp_args(c) + (heads, window), flops + 16 * m * c * c,
                          nbytes + 8 * c * c * 2 + 6 * c * 4, fwd_tol, "entries",
                          counts=("swin_attn", "token_mlp")))
    # mm_accumulate (K12): 64 accumulated products at the four shapes, bf16
    # (relative to the fp32 product) and int8 (exact).  The kernel computes
    # 64 * copies products, so each library yardstick does as many library
    # products: for bf16 one torch.bmm over operands expanded to a batch of
    # 64 * copies with stride 0 (library_ms), and torch.matmul called that
    # many times back to back in one graph (yardstick_ms); for int8
    # torch._int_mm that many times (no batched form).  The plain version is
    # one fp32 product scaled by 64 (``products`` in the kernels line).  Each
    # case is timed again at 128 products (``more_work``).
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def looped(product, a, b_, n):
        def run():
            for _ in range(n):
                product(a, b_)
        return run

    def batched(a, b_, n):
        """torch.bmm over a and b_ expanded to a batch of n (stride 0); where
        bmm copies such operands (its peak memory passes its output by at
        least half an operand), the copy is made here, outside the timed
        call, and said."""
        ea, eb = a.expand(n, *a.shape), b_.expand(n, *b_.shape)
        torch.bmm(ea, eb)  # cuBLAS's workspace, once
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out_bytes = torch.bmm(ea, eb).nbytes
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base - out_bytes
        copied = extra >= min(ea.numel(), eb.numel()) * a.element_size() // 2
        log(f"kernel mm_accumulate: torch.bmm over a{tuple(ea.shape)} b{tuple(eb.shape)} with "
            f"stride-0 batches allocates {extra} bytes beyond its output: "
            + ("it copies them, so the yardstick runs on contiguous copies made before timing"
               if copied else "no copy"))
        if copied:
            ea, eb = ea.contiguous(), eb.contiguous()
        return lambda: torch.bmm(ea, eb)

    for m, k, n in mm.SHAPES:
        _, copies = mm.grid_plan(m, n, sms)
        a8 = torch.randint(-127, 127, (m, k), generator=gen, device=dev, dtype=torch.int8)
        b8 = torch.randint(-127, 127, (k, n), generator=gen, device=dev, dtype=torch.int8)
        abf, bbf = rnd(m, k), rnd(k, n)
        cases.append(Case("mm_accumulate", "mm_microbench.cu", K12, mm.mm_accumulate,
                          mm.mm_accumulate_plain, (abf, bbf, 64), mm.operations(m, k, n, 64, copies),
                          (m * k + k * n) * 2 + m * n * 4, (0.0, 1e-3, 1e-4), "entries",
                          library=batched(abf, bbf, 64 * copies),
                          yardsticks={"torch.matmul looped": looped(torch.matmul, abf, bbf,
                                                                    64 * copies)},
                          products=dict(kernel=64 * copies, plain=1, library=64 * copies,
                                        yardsticks=64 * copies),
                          more_work=(abf, bbf, 128)))
        int_mm = getattr(torch, "_int_mm", None)
        cases.append(Case("mm_accumulate", "mm_microbench.cu", K12, mm.mm_accumulate,
                          mm.mm_accumulate_plain, (a8, b8, 64), mm.operations(m, k, n, 64, copies),
                          (m * k + k * n) + m * n * 4, (0.0, 0.0, 0.0), "entries",
                          library=looped(int_mm, a8, b8, 64 * copies) if int_mm else None,
                          products=dict(kernel=64 * copies, plain=1, library=64 * copies),
                          peak=H100_INT8_OPS, graph_plain=False, more_work=(a8, b8, 128)))
    return cases


def device_ms_by(fn, frags, reps: int) -> dict:
    """Device time of one call of ``fn`` by device function (torch.profiler
    over ``reps`` calls), summed over the functions whose name holds each of
    ``frags``, and the launches of those functions in one call:
    {frag: (ms, launches)}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {f: (0.0, 0.0) for f in frags}
    for e in prof.key_averages():
        for f in frags:
            if f in e.key:
                ms, n = out[f]
                out[f] = (ms + e.device_time_total / 1e3 / reps, n + e.count / reps)
    return out


def check_kernels(dev, reps: int = 20):
    from diffusesg_torch.ops import cuda_build

    results, cases = [], kernel_cases(dev)
    for case in cases:
        name, kern, plain, args = case.name, case.kern, case.plain, case.args
        atol, rtol, rel_max = case.tol
        before = dict(cuda_build.LAUNCHES)
        outs = kern(*args)
        torch.cuda.synchronize()
        expect = sorted(case.counts or (name,))
        keys = sorted(k for k, v in cuda_build.LAUNCHES.items() if v != before.get(k, 0))
        if [k[0] for k in keys] != expect or any(
                cuda_build.LAUNCHES[k] != before.get(k, 0) + 1 for k in keys):
            fail(f"{name}: expected one launch each of {expect} and of nothing else, saw {keys}")
        refs = plain(*args)
        torch.cuda.synchronize()
        if isinstance(outs, torch.Tensor):
            outs, refs = (outs,), (refs,)
        ok, max_abs, max_rel, max_of_max, max_l2 = len(outs) == len(refs), 0.0, 0.0, 0.0, 0.0
        for i, (out, ref) in enumerate(zip(outs, refs)):
            if out.shape != ref.shape or out.dtype != ref.dtype or not (
                    out.dtype == torch.int32 or torch.isfinite(out).all()):
                fail(f"{name} {keys[0][1]} output {i}: shape {tuple(out.shape)} vs "
                     f"{tuple(ref.shape)}, dtype {out.dtype} vs {ref.dtype}, or non-finite")
            o, r = out.double(), ref.double()
            err = (o - r).abs()
            top = float(r.abs().max())
            max_abs = max(max_abs, float(err.max()))
            max_rel = max(max_rel, float((err / r.abs().clamp_min(1e-3)).max()))
            max_of_max = max(max_of_max, float(err.max()) / max(top, 1e-30))
            max_l2 = max(max_l2, float(err.norm()) / max(float(r.norm()), 1e-30))
            ok = ok and bool((err <= atol + rtol * r.abs() + rel_max * top).all())
        # no atomics anywhere: a second launch must give the same bits
        again = kern(*args)
        again = (again,) if isinstance(again, torch.Tensor) else again
        if not all(torch.equal(a, b) for a, b in zip(outs, again)):
            fail(f"{name} {keys[0][1]} is not bit-equal from launch to launch")
        ms = graph_ms(lambda: kern(*args), reps)
        eager_ms = time_ms(lambda: kern(*args), reps)
        plain_reps = max(3, reps // 4)
        plain_ms = (graph_ms if case.graph_plain else time_ms)(lambda: plain(*args), plain_reps)
        library_ms = None
        if case.library is not None:
            try:
                case.library()
            except (RuntimeError, TypeError) as exc:  # the yardstick only: no such call here
                log(f"kernel {name} {keys[0][1]}: no library call ({str(exc)[:80]})")
            else:
                library_ms = graph_ms(case.library, reps)
        extra = {}
        if case.yardsticks:
            extra["yardstick_ms"] = {k: graph_ms(f, reps) for k, f in case.yardsticks.items()}
        if case.more_work is not None:
            more_ms = graph_ms(lambda: kern(*case.more_work), reps)
            extra["more_work_ms"] = more_ms
            log(f"kernel {name:16s} {case.path:7s} {keys[0][1]:22s} 2x the work: {more_ms:.4f} "
                f"ms, {more_ms / ms:.3f}x the time (at least 1.6x)")
            if not more_ms >= 1.6 * ms:
                fail(f"{name} {keys[0][1]}: 2x the work took only {more_ms / ms:.3f}x the time")
        bound_ms, bound_by = bound(case.flops, case.nbytes, case.peak)
        label = f"{name}@{case.path} {keys[0][1]}"
        if case.gemms:
            parts = device_ms_by(lambda: kern(*args), [f for _, f, _ in case.gemms], reps)
            log(f"kernel {name:16s} {case.path:7s} {keys[0][1]:22s} launches: " + "; ".join(
                f"{lbl} {parts[frag][0]:.4f} ms" + (
                    f" x{parts[frag][1]:g}" if parts[frag][1] != 1 else "")
                + ("" if lib is None else f" (yardstick, bf16: {graph_ms(lib, reps):.4f} ms)")
                for lbl, frag, lib in case.gemms if parts[frag][1] > 0))
        results.append(dict(name=label, route="cuda", source=SRC + case.src,
                            replaces=case.replaces, kernel=name, keys=keys, path=case.path,
                            max_abs_err=max_abs, max_err_over_max=max_of_max, max_rel_l2=max_l2, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=library_ms,
                            **({"products": case.products} if case.products else {}), **extra))
        lib = "-" if library_ms is None else f"{library_ms:.4f}"
        lib += "".join(f" {k}={v:.4f}" for k, v in extra.get("yardstick_ms", {}).items())
        log(f"kernel {name:16s} {case.path:7s} {keys[0][1]:22s} outputs={len(outs)} "
            f"max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
            f"max_err/max|ref|={max_of_max:.3e} max_rel_l2={max_l2:.3e} tol=atol {atol}+rtol {rtol}+{rel_max}*max "
            f"ms={ms:.4f} eager_ms={eager_ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib} "
            f"bound_ms={bound_ms:.4f} ({bound_by}, {bound_ms / ms:.1%} of it) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{name} {keys[0][1]} disagrees with its plain version")
    return results, [c for c in cases if c.path == "entries"]


# ------------------------------------------------------------------ phase 3

def check_decoded(adj, node, bbox, counts, n, spec):
    b = len(counts)
    if adj.shape != (b, n, n) or node.shape != (b, n) or bbox.shape != (b, n, 4):
        fail(f"decoded shapes {tuple(adj.shape)} {tuple(node.shape)} {tuple(bbox.shape)}")
    if not torch.isfinite(bbox).all():
        fail("non-finite boxes")
    if int(node.min()) < 0 or int(node.max()) >= spec["node_types"]:
        fail(f"node types outside [0, {spec['node_types']})")
    if int(adj.min()) < 0 or int(adj.max()) >= spec["edge_types"]:
        fail(f"edge types outside [0, {spec['edge_types']})")
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


def check_slice(dev, smi: str, spec=VG):
    """The sampling slice of one model (``spec``: VG or COCO); returns the
    launch counts of the ``generate`` calls and the model."""
    from diffusesg_torch.config import load_config
    from diffusesg_torch.models import build_model, count_params, make_model
    from diffusesg_torch.models.precond import precond_forward
    from diffusesg_torch.ops import cuda_build
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.serving import generate

    tag = spec["tag"]
    cfg = load_config(spec["config"])
    with cfg.unlocked():
        cfg.mcmc.num_steps = 16
    model = build_model(cfg, device=dev, seed=0)
    n_params = count_params(model)
    if n_params != spec["params"] or model.dtype != torch.bfloat16:
        fail(f"{tag} model has {n_params} parameters in {model.dtype}")
    sampler = get_mc_sampler(cfg)
    n = cfg.dataset.max_node_num
    requests = [spec["requests"], [n] * 16]

    cuda_build.reset_launches()
    t0 = time.perf_counter()
    outs = [generate(model, sampler, cfg, counts, seed=i, device=dev)
            for i, counts in enumerate(requests)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_build.LAUNCHES)
    by_kernel = cuda_build.launches_by_kernel()
    in_box = [check_decoded(adj, node, bbox, counts, n, spec)
              for (adj, node, bbox), counts in zip(outs, requests)]
    evals = 2 * (sampler.num_steps - 1) + 1
    log(f"slice {tag}: {n_params} parameters; generate {requests[0]} and "
        f"{len(requests[1])}x{n} nodes, "
        f"{sampler.num_steps} Heun steps ({evals} denoiser evals each) in {wall:.2f} s; "
        f"launches {json.dumps(by_kernel, sort_keys=True)}; box coordinates in [0, 1]: "
        f"{in_box[0]:.1%} and {in_box[1]:.1%}")
    for name in ("swin_attn", "token_mlp", "patch_merge", "patch_breakup", "readout"):
        if by_kernel.get(name, 0) == 0:
            fail(f"the main path never launched {name}")
    edges = int((outs[1][0] > 0).sum())
    log(f"slice {tag}: decoded 16 full graphs with {edges} directed edges, node types "
        f"{int(outs[1][1].min())}..{int(outs[1][1].max())}")

    # the card's bf16 denoiser (kernels) vs the fp32 plain model on the CPU
    with cfg.unlocked():
        cfg.tpu.compute_dtype = "float32"
    ref = make_model(cfg)
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    gen = torch.Generator().manual_seed(5)
    flags = torch.zeros(2, n, dtype=torch.bool)
    flags[0, :spec["small"][0]], flags[1, :spec["small"][1]] = True, True
    x = dict(a=torch.randn(2, n, n, generator=gen), x=torch.randn(2, n, 5, generator=gen),
             s=torch.tensor([0.3, 4.0]), sa=torch.randn(2, n, n, generator=gen) * 0.5,
             sx=torch.randn(2, n, 5, generator=gen) * 0.5)
    with torch.inference_mode():
        c_noise = torch.log(x["s"]) / 4.0
        got = model(*(t.to(dev) for t in (x["a"], x["x"], flags, c_noise, x["sa"], x["sx"])))
        want = ref(x["a"], x["x"], flags, c_noise, x["sa"], x["sx"])
    for g, w, what in zip(got, want, ("adj", "node")):
        rel = float((g.float().cpu() - w).norm() / w.norm())
        log(f"slice {tag}: card bf16 denoiser vs CPU fp32 plain model, {what} output "
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
        log(f"slice {tag}: {timings[b]:.3f} ms per denoiser eval at batch {b} eager "
            f"({dev_ms:.3f} ms replayed as a CUDA graph; bf16, {timings[b] / b:.4f} ms per "
            f"graph, peak {peak:.2f} GiB) on {smi}")
    profile_eval(ev, timings[64], tag)
    return launches, model


# ------------------------------------------------- phase 5, the own entries

def check_entries(dev, model, entry_cases):
    """Drive the kernels that no model path reaches through their public
    entries, on the card: every "entries" case once more (its count is read
    after this run, not from the comparison of phase 2), then
    ``WindowAttention.forward`` of the COCO model's shifted block against the
    same module in fp32 on the CPU, ``fused_swin_attn_block`` and
    ``fused_swin_block`` on a pre-rolled grid against the model's own block
    (the same kernels with the roll folded in: bit-equal), and the int8
    micro-benchmark script.  Returns the launch counts."""
    import importlib.util

    from diffusesg_torch.models.layers import WindowAttention, dense
    from diffusesg_torch.ops import cuda_build
    from diffusesg_torch.ops import swin_block_kernel as sk
    from diffusesg_torch.ops import swin_block_v3 as sw
    from diffusesg_torch.ops import swin_full_block as sf

    cuda_build.reset_launches()
    with torch.inference_mode():
        for case in entry_cases:
            case.kern(*case.args)
        torch.cuda.synchronize()

        blk = model.down_layers[1].blocks[1]  # 20x20, C192, 6 heads, window 10, shift 5
        (h, w), c, dt = blk.input_resolution, blk.attn.dim, blk.dtype
        if (h, w, c, blk.window, blk.shift) != (20, 20, 192, 10, 5):
            fail(f"unexpected geometry of the COCO model's shifted block: {h}x{w} C{c}")
        gen = torch.Generator(device=dev).manual_seed(7)
        tokens = torch.randn(BATCH * 4, 100, c, generator=gen, device=dev)
        got = blk.attn(tokens.to(dt), blk.attn_mask).float().cpu()
        ref = WindowAttention(c, blk.window, blk.num_heads, torch.float32)
        ref.load_state_dict({k: v.float().cpu() for k, v in blk.attn.state_dict().items()})
        want = ref(tokens.cpu(), blk.attn_mask.cpu())
        rel = float((got - want).norm() / want.norm())
        log(f"entries: WindowAttention.forward [{BATCH * 4}, 100, {c}] with the shift mask, card "
            f"bf16 vs CPU fp32 module: relative L2 error {rel:.3e} (limit 2e-2)")
        if not rel < 2e-2:
            fail("WindowAttention.forward disagrees with the fp32 module")

        x = torch.randn(BATCH, h, w, c, generator=gen, device=dev).to(dt)
        emb = torch.randn(BATCH, 512, generator=gen, device=dev)
        a, m = blk.attn, blk.mlp
        ss = dense(emb, blk.affine, dt)
        attn_p = (ss, blk.norm1.weight, blk.norm1.bias, a.qkv.weight.to(dt), a.qkv.bias,
                  a.proj.weight.to(dt), a.proj.bias, a.rel_bias(), blk.attn_mask)
        mlp_p = (blk.norm2.weight, blk.norm2.bias, m.fc1.weight.to(dt), m.fc1.bias,
                 m.fc2.weight.to(dt), m.fc2.bias)
        geom = (blk.num_heads, blk.window)
        rolled = torch.roll(x, (-blk.shift, -blk.shift), dims=(1, 2))
        unroll = lambda t: torch.roll(t, (blk.shift, blk.shift), dims=(1, 2))  # noqa: E731
        half = unroll(sk.fused_swin_attn_block(rolled, *attn_p, *geom))
        whole = unroll(sf.fused_swin_block(rolled, *attn_p, *mlp_p, *geom))
        half_ref = sw.swin_attn(x, *attn_p, *geom, blk.shift)
        whole_ref = blk(x.reshape(BATCH, h * w, c), emb).reshape(BATCH, h, w, c)
        torch.cuda.synchronize()
        same = torch.equal(half, half_ref), torch.equal(whole, whole_ref)
        log(f"entries: fused_swin_attn_block and fused_swin_block on the pre-rolled 20x20 C192 "
            f"grid vs the model's shifted block (roll folded into the kernel): bit-equal {same}")
        if not all(same):
            fail("a pre-rolled entry disagrees with the model's own block")

    spec = importlib.util.spec_from_file_location(
        "microbench_int8_torch", os.path.join("scripts", "microbench_int8_torch.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    if bench.main() != 0:
        fail("scripts/microbench_int8_torch.py failed")
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    log(f"entries: launches {json.dumps(cuda_build.launches_by_kernel(), sort_keys=True)}")
    return launches


# ------------------------------------------------------------------ phase 4

TRAIN_BATCH = 64
# card bf16 kernels vs CPU fp32 plain, relative L2: the first VG run measured
# 9.4e-3 over the whole gradient and 4.0e-2 on the worst leaf (a
# relative-position bias table); the limits are about three times that, and
# every leaf that the plain model holds under the leaf limit when it runs in
# bf16 on the CPU is held to it.  Where bf16 itself is further than that from
# fp32 (COCO's deepest 10x10 bias tables, whose gradient is a small difference
# of large sums over 4 windows), the comparison with fp32 measures the
# activations' rounding, not the kernel: such a leaf must be a bias table, and
# the d(rel_bias) that ``swin_attn_bwd`` wrote for it is held, under
# NOISY_LEAF_TOL, against ``swin_attn_bwd_plain`` on the same inputs (the
# model's activations), on NOISY_SEEDS batches.  Beside it: the window core
# alone against the plain core backward on the very bf16 operands it read
# (phase 2's tolerance), and how far the kernel's recomputed hn, qkv and
# d(attn) are from the plain version's, in bf16 ulps.  Two controls on the
# plain operands show what the comparison reads without the kernel: the
# same number of elements moved one ulp (sound rounding noise), and qkv and
# d(attn) rounded to one mantissa bit fewer than bf16 (a recompute that is
# less precise than it should be, which the gate must refuse).
GRAD_REL_L2_LIMIT = 3e-2
GRAD_WORST_LEAF_LIMIT = 1.5e-1
BWD_TOL = (0.0, 2e-2, 1e-2)  # phase 2's: |err| <= 2e-2 |ref| + 1e-2 max|ref|
# The noisy tables' gate, from 8 batches on the H100: the kernel against the
# plain backward read 4.0e-3 to 1.8e-2 of max, and the plain backward on the
# CPU against itself on the card (no kernel) up to 1.5e-2, so phase 2's bound
# could not hold sound code here.  Moving that many operand elements one ulp
# read up to 2.9e-2, and operands one mantissa bit coarser at least 4.4e-2:
# the bound lies between, and the gate must refuse the coarser control on
# every batch.
NOISY_LEAF_TOL = (0.0, 0.0, 3e-2)
NOISY_SEEDS = 8
# the recomputed hn, qkv and d(attn) against the plain version's: at most this
# share of elements apart, none by more than two ulps of the tensor's largest
OPERANDS_APART = 1e-2
OPERANDS_MAX_ERR = 2.0 ** -6


def _forced(noise_cls, self_cond: bool):
    """A noise source whose self-conditioning draw is fixed."""
    class Forced(noise_cls):
        def bernoulli(self, step, kind, p):
            return self_cond
    return Forced


def bf16_ulps(a, b):
    """Elementwise distance of two bf16 tensors in bf16 steps (ulps)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def nudged(t, n: int, gen):
    """bf16 ``t`` with ``n`` of its nonzero elements, drawn with ``gen`` (a
    CPU generator), moved one ulp towards or away from zero."""
    bits = t.contiguous().view(torch.int16).flatten().cpu().clone()
    nz = (bits & 0x7FFF).nonzero().flatten()
    pick = nz[torch.randperm(len(nz), generator=gen)[:n]]
    bits[pick] += (torch.randint(0, 2, (len(pick),), generator=gen) * 2 - 1).to(torch.int16)
    return bits.view(t.dtype).reshape(t.shape).to(t.device)


def coarser(t):
    """bf16 ``t`` rounded to one mantissa bit fewer (6 instead of 7)."""
    i = t.float().contiguous().view(torch.int32)
    return ((i + (1 << 16)) & ~((1 << 17) - 1)).view(torch.float32).to(t.dtype)


def rel_max_err(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def held(got, want, tol) -> bool:
    atol, rtol, rel_max = tol
    got, want = got.double().cpu(), want.double().cpu()
    return bool(((got - want).abs() <= atol + rtol * want.abs()
                 + rel_max * float(want.abs().max())).all())


def noisy_leaf_readings(args, outs, ops, gen) -> dict:
    """What the check of a noisy bias table reads on one ``swin_attn_bwd``
    call: ``args``, its nine gradients ``outs`` and its recomputed bf16 (hn,
    qkv, d(attn)) ``ops``."""
    from diffusesg_torch.ops import swin_block_v3 as sw

    got, core_args = outs[8], args[8:]
    want = sw.swin_attn_bwd_plain(*args)[8]
    plain_ops = sw.swin_attn_bwd_operands_plain(*args[:8], *args[11:13])
    core = sw.window_core_drel_plain(ops[1], ops[2], *core_args)
    cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    ulps = [bf16_ulps(k, p) for k, p in zip(ops, plain_ops)]
    moved = [int((u > 0).sum()) for u in ulps]
    op_err = [rel_max_err(k, p) for k, p in zip(ops, plain_ops)]
    nudge = sw.window_core_drel_plain(nudged(plain_ops[1], moved[1], gen),
                                      nudged(plain_ops[2], moved[2], gen), *core_args)
    coarse = sw.window_core_drel_plain(coarser(plain_ops[1]), coarser(plain_ops[2]), *core_args)
    return dict(
        old=rel_max_err(got, want), old_ok=held(got, want, NOISY_LEAF_TOL),
        core=rel_max_err(got, core), core_ok=held(got, core, BWD_TOL),
        witness=rel_max_err(sw.swin_attn_bwd_plain(*cpu_args)[8], want),
        nudge=rel_max_err(nudge, want), coarse=rel_max_err(coarse, want),
        coarse_refused=not held(coarse, want, NOISY_LEAF_TOL),
        moved=[m / u.numel() for m, u in zip(moved, ulps)],
        max_ulps=[int(u.max()) for u in ulps], op_err=op_err,
        ops_ok=all(m <= OPERANDS_APART * u.numel() for m, u in zip(moved, ulps))
        and max(op_err) <= OPERANDS_MAX_ERR)


def check_gradients(cfg, model, dev, spec):
    """One loss at batch 4 with the same draws on every side: gradients of
    the card's bf16 model (kernels) vs the fp32 plain model on the CPU.  The
    plain model in bf16 on the CPU measures bf16's own noise: a leaf it cannot
    hold under the leaf limit is checked at the kernel instead, on
    NOISY_SEEDS batches (see GRAD_WORST_LEAF_LIMIT)."""
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
    flags = torch.zeros(4, n, dtype=torch.bool)
    for i, c in enumerate(spec["requests"]):
        flags[i, :c] = True
    pair = flags[:, :, None] & flags[:, None, :]

    def batch(seed):
        gen = torch.Generator().manual_seed(11 + seed)
        adjs = (torch.rand(4, n, n, generator=gen) * 2 - 1) * pair
        nodes = torch.rand(4, n, 5, generator=gen) * 2 - 1
        nodes[..., -2:] = nodes[..., -2:] * 0.3 - 0.5  # box sizes 0.1 .. 0.4 of the image
        return adjs, nodes * flags[:, :, None]

    step_cfg = train_step_config_from(cfg)
    weights = {k: v.cpu() for k, v in model.state_dict().items()}
    plain_bf16 = make_model(cfg)
    plain_bf16.load_state_dict(weights)
    with cfg.unlocked():
        dtype_name, cfg.tpu.compute_dtype = cfg.tpu.compute_dtype, "float32"
    ref = make_model(cfg)
    with cfg.unlocked():
        cfg.tpu.compute_dtype = dtype_name
    ref.load_state_dict(weights)

    def grads_of(m, device, seed=0):
        adjs, nodes = batch(seed)
        loss, _ = make_loss_fn(m, step_cfg)(None, CpuDraws(3 + seed, device), 0,
                                            adjs.to(device), nodes.to(device), flags.to(device))
        return float(loss.detach()), torch.autograd.grad(loss, list(m.parameters()))

    from diffusesg_torch.ops import cuda_build
    from diffusesg_torch.ops import swin_block_v3 as sw

    def card_grads(seed):
        """The card's loss and gradients, and every swin_attn_bwd call of its
        backward with what it returned and the bf16 operands it recomputed."""
        calls, kernel_bwd = [], sw.swin_attn_bwd

        def recorded(*args):
            outs, ops = sw._swin_attn_bwd_kernel(*args)
            calls.append((args, outs, ops))
            return outs

        sw.swin_attn_bwd = recorded
        try:
            loss, grads = grads_of(model, dev, seed)
        finally:
            sw.swin_attn_bwd = kernel_bwd
        torch.cuda.synchronize()
        return loss, grads, calls

    cuda_build.reset_launches()
    loss_card, g_card, calls = card_grads(0)
    by_kernel = cuda_build.launches_by_kernel()
    t0 = time.perf_counter()
    loss_cpu, g_cpu = grads_of(ref, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    _, g_bf16 = grads_of(plain_bf16, torch.device("cpu"))
    num = den = 0.0
    worst, worst_name, worst_plain, over, noisy = 0.0, "", 0.0, [], []
    for (name, _), gc, gr, gb in zip(model.named_parameters(), g_card, g_cpu, g_bf16):
        gc = gc.float().cpu()
        if not torch.isfinite(gc).all():
            fail(f"gradient of {name} is not finite")
        ref_norm = float(gr.norm())
        if ref_norm > 0 and float(gc.norm()) == 0:
            fail(f"gradient of {name} is identically zero on the card, {ref_norm:.3e} on the CPU")
        err = float((gc - gr).norm())
        num, den = num + err ** 2, den + ref_norm ** 2
        if ref_norm > 0:
            leaf, plain = err / ref_norm, float((gb.float() - gr).norm()) / ref_norm
            if plain > GRAD_WORST_LEAF_LIMIT:
                noisy.append((name, leaf, plain))
            elif leaf > worst:
                worst, worst_name, worst_plain = leaf, name, plain
            if plain <= GRAD_WORST_LEAF_LIMIT < leaf:
                over.append(f"{name} {leaf:.3e} (plain bf16 {plain:.3e})")
    rel = (num / den) ** 0.5
    log(f"train {spec['tag']}: gradient check at batch 4 (self-conditioning pass on): loss {loss_card:.6f} "
        f"on the card, {loss_cpu:.6f} on the CPU ({cpu_s:.1f} s); whole-gradient relative L2 "
        f"{rel:.3e} (limit {GRAD_REL_L2_LIMIT}), worst leaf {worst:.3e} at {worst_name} "
        f"(the plain model in bf16 on the CPU: {worst_plain:.3e} on that leaf; limit "
        f"{GRAD_WORST_LEAF_LIMIT}); {len(noisy)} leaves on which plain bf16 is itself over that limit, "
        f"checked at the kernel; {len(g_card)} leaves finite, none zero where the "
        f"CPU's is not; backward launches {by_kernel.get('swin_attn_bwd', 0)} + "
        f"{by_kernel.get('token_mlp_bwd', 0)}")
    if not rel < GRAD_REL_L2_LIMIT or over:
        fail(f"the card's gradients disagree with the fp32 plain model: {over[:4]}")
    if abs(loss_card - loss_cpu) > 5e-2 * abs(loss_cpu):
        fail("the card's loss disagrees with the fp32 plain model")
    if not noisy:
        return
    blocks = []
    for name, leaf, plain in noisy:
        block, _, param = name.rpartition(".attn.")
        if param != "relative_position_bias_table":
            fail(f"plain bf16 is {plain:.3e} from fp32 on {name}, which no kernel check covers")
        log(f"train {spec['tag']}: {name}: card vs CPU fp32 {leaf:.3e}, plain bf16 on the CPU "
            f"vs fp32 {plain:.3e} (over {GRAD_WORST_LEAF_LIMIT}: bf16's noise): checked at "
            f"swin_attn_bwd on {NOISY_SEEDS} batches")
        blocks.append((name, model.get_submodule(block).norm1.weight.data_ptr()))
    gen, failed = torch.Generator().manual_seed(5), []
    readings = {name: [] for name, _ in blocks}
    for seed in range(NOISY_SEEDS):
        seed_calls = calls if seed == 0 else card_grads(seed)[2]
        for name, gamma in blocks:
            mine = [c for c in seed_calls if c[0][3].data_ptr() == gamma]
            if len(mine) != 1:
                fail(f"{len(mine)} swin_attn_bwd calls recorded for {name}")
            r = noisy_leaf_readings(*mine[0], gen)
            readings[name].append(r)
            log(f"train {spec['tag']}: {name} batch {seed}: d(rel_bias) of swin_attn_bwd vs "
                f"swin_attn_bwd_plain on the model's activations max_err/max|ref|="
                f"{r['old']:.3e} {'ok' if r['old_ok'] else 'MISMATCH'} (tol {NOISY_LEAF_TOL}); "
                f"its window core vs the plain core backward on the operands it read "
                f"{r['core']:.3e} {'ok' if r['core_ok'] else 'MISMATCH'} (tol {BWD_TOL}); "
                f"recomputed hn / qkv / d(attn) vs the plain version's: "
                + " / ".join(f"{f:.3%} of elements apart, at most {u} ulp, max_err/max|ref|="
                             f"{e:.3e}" for f, u, e in zip(r["moved"], r["max_ulps"], r["op_err"]))
                + f" {'ok' if r['ops_ok'] else 'MISMATCH'} (at most {OPERANDS_APART:.0%} apart, "
                f"{OPERANDS_MAX_ERR:.3e} of max); without the kernel: plain on the CPU vs on "
                f"the card {r['witness']:.3e}, that many elements moved 1 ulp {r['nudge']:.3e}, "
                f"qkv and d(attn) one mantissa bit coarser {r['coarse']:.3e} "
                f"{'refused' if r['coarse_refused'] else 'PASSED THE GATE'}")
            if not (r["old_ok"] and r["core_ok"] and r["ops_ok"] and r["coarse_refused"]):
                failed.append(f"{name} batch {seed}")
    for name, rs in readings.items():
        summary = {k: f"{min(r[k] for r in rs):.3e}..{max(r[k] for r in rs):.3e}"
                   for k in ("old", "core", "witness", "nudge", "coarse")}
        log(f"train {spec['tag']}: {name} over {len(rs)} batches, max_err/max|ref| of d(rel_bias) "
            f"(least..most): " + ", ".join(f"{k} {v}" for k, v in summary.items()))
    if failed:
        fail(f"d(rel_bias) disagrees with the plain backward: {failed}")


def check_training(dev, smi: str, spec=VG, find_largest_batch: bool = True):
    """The training slice of one model (``spec``: VG or COCO); returns the
    launch counts of the ``go_training`` run."""
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

    tag, n_blocks = spec["tag"], spec["blocks"]
    exp_dir = os.path.join("build", "smoke_runs", spec["path"])
    shutil.rmtree(exp_dir, ignore_errors=True)
    cfg = load_config(spec["config"])
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
    log(f"train {tag}: {len(bundle.train)} + {len(bundle.test)} synthetic scene graphs in "
        f"{time.perf_counter() - t0:.1f} s")
    model = build_model(cfg, device=dev, seed=0)
    check_gradients(cfg, model, dev, spec)

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
    log(f"train {tag}: {state.step} steps at batch {TRAIN_BATCH} through go_training in {wall:.2f} s "
        f"(first step and the epoch-0 test pass included); losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}; backward launches per step "
        f"(swin_attn_bwd, token_mlp_bwd) {sorted(set(record['bwd']))}")
    if state.step != 2 * steps_per_epoch or len(losses) != state.step:
        fail(f"expected {2 * steps_per_epoch} steps, ran {state.step}")
    if not all(x == x and abs(x) != float("inf") for x in losses):
        fail("a training loss is not finite")
    if set(record["bwd"]) != {(n_blocks, n_blocks)}:
        fail(f"each backward must launch each backward kernel {n_blocks} times, saw "
             f"{record['bwd']}")
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
    log(f"train {tag}: parameters moved by up to {moved:.3e}; EMA-to-parameter gaps "
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
    log(f"train {tag}: checkpoint {os.path.getsize(path) / 2 ** 20:.0f} MiB written and read back, "
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
    log(f"train {tag}: {step_ms[False]:.3f} ms per training step at batch {TRAIN_BATCH} without the "
        f"self-conditioning pass, {step_ms[True]:.3f} ms with it (mean of the two "
        f"{(step_ms[False] + step_ms[True]) / 2:.3f} ms, {TRAIN_BATCH * 2e3 / (step_ms[False] + step_ms[True]):.1f} "
        f"graphs/s; bf16, eager), peak {peak:.2f} GiB on {smi}")
    profile_call(lambda: inner(state, noise, *batch),
                 f"one batch-{TRAIN_BATCH} {tag} training step with the self-conditioning pass",
                 step_ms[True])

    if not find_largest_batch:
        return launches
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
            log(f"train {tag}: batch {b} does not fit (out of memory)")
            break
        finally:
            state.opt.zero_grad(set_to_none=True)
        fits = b
        log(f"train {tag}: batch {b} fits, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        b *= 2
    del big
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    log(f"train {tag}: largest power-of-two batch of a training step in {total:.0f} GiB: {fits}")
    return launches


# ------------------------------------------------------------------ phase 7

SMALL_CFG = "configs/vg_small_test.yaml"
SMALL_REL_L2 = 1e-4  # fp32 on the card vs fp32 on the CPU, the same plain code


def check_small_config(dev) -> None:
    """``configs/vg_small_test.yaml`` on the card: its ``tpu`` block sets
    float32 and ``use_pallas_attention: false``, so every layer runs its plain
    version (head_dim 16 and float32, which no kernel covers, as the JAX
    package runs its XLA composition there).  The denoiser on the card
    against the same model on the CPU, then two training steps through
    ``cli.train`` with its default device on 8 synthetic graphs; no kernel
    may launch."""
    import glob

    from diffusesg_torch.cli import train as train_cli
    from diffusesg_torch.config import load_config
    from diffusesg_torch.models import build_model, make_model
    from diffusesg_torch.ops import cuda_build

    cfg = load_config(SMALL_CFG)
    cuda_build.reset_launches()
    model = build_model(cfg, device=dev, seed=0)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():  # weights at a scale that makes every path of the network matter
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.15)
    if model.use_kernels or model.dtype != torch.float32:
        fail(f"{SMALL_CFG}: kernels {model.use_kernels}, {model.dtype}; the config asks for "
             "neither")
    ref = make_model(cfg).eval()
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    n = cfg.dataset.max_node_num
    flags = torch.zeros(2, n, dtype=torch.bool)
    flags[0, :n], flags[1, :7] = True, True
    x = (torch.randn(2, n, n, generator=gen), torch.randn(2, n, 5, generator=gen), flags,
         torch.log(torch.tensor([0.3, 4.0])) / 4.0, torch.randn(2, n, n, generator=gen) * 0.5,
         torch.randn(2, n, 5, generator=gen) * 0.5)
    with torch.inference_mode():
        got = model(*(t.to(dev) for t in x))
        want = ref(*x)
    for g, w, what in zip(got, want, ("adj", "node")):
        rel = float((g.cpu() - w).norm() / w.norm())
        log(f"small: {SMALL_CFG} denoiser (float32, kernels off) on the card vs the CPU, {what} "
            f"output {tuple(g.shape)} relative L2 {rel:.3e} (limit {SMALL_REL_L2})")
        if not (g.device.type == "cuda" and g.dtype == torch.float32 and rel < SMALL_REL_L2):
            fail(f"{SMALL_CFG}: the card's {what} output disagrees with the CPU's")

    exp_dir = os.path.join("build", "smoke_runs", "small")
    shutil.rmtree(exp_dir, ignore_errors=True)
    t0 = time.perf_counter()
    state = train_cli.main(["-c", SMALL_CFG, "--data_root", "/nonexistent", "--subset", "8",
                            "--max_epoch", "1", "--save_interval", "1", "-l", "WARNING",
                            "-o", f"exp_dir={exp_dir}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = []
    for path in glob.glob(os.path.join(exp_dir, "**", "scalars.jsonl"), recursive=True):
        with open(path) as f:
            losses += [json.loads(line)["value"] for line in f if "regression_loss" in line]
    params = list(state.params())
    init = list(build_model(cfg, device=dev, seed=int(cfg.seed)).parameters())
    with torch.no_grad():
        moved = max(float((p - q).abs().max()) for p, q in zip(params, init))
    launches = cuda_build.launches_by_kernel()
    log(f"small: cli.train on {SMALL_CFG} (default device) took {state.step} steps at batch "
        f"{cfg.train.batch_size} in {wall:.1f} s on {params[0].device}; epoch losses "
        f"{' '.join(f'{v:.4f}' for v in losses)}; parameters moved by up to {moved:.3e}; "
        f"kernel launches in this phase {json.dumps(launches, sort_keys=True)}")
    if state.step != 2 or params[0].device.type != "cuda":
        fail(f"{SMALL_CFG}: expected 2 training steps on the card, ran {state.step} on "
             f"{params[0].device}")
    if not losses or not all(v == v and abs(v) != float("inf") for v in losses) or not moved > 0:
        fail(f"{SMALL_CFG}: losses {losses} not finite, or the parameters did not move")
    if launches:
        fail(f"{SMALL_CFG} switches the kernels off, yet {launches} launched")


# ------------------------------------------------------------------ phase 8

EVAL_GRAPHS = 64
EVAL_STEPS = 16
FORWARD_KERNELS = ("swin_attn", "token_mlp", "patch_merge", "patch_breakup", "readout")
MMD_KEYS = ("node_degree_mmd_gaussian", "node_average_mmd_gaussian", "node_type_mmd_gaussian",
            "edge_type_mmd_gaussian")
# the JAX package's metric block (diffusesg_tpu/sampling/orchestrator.py:433-505)
METRIC_KEYS = (
    ["gen_data_size", "test_data_size", *MMD_KEYS]
    + [f"triplet_{m}_{t}" for t in ("val", "train")
       for m in ("tv_dist_rej", "tv_dist_all", "tv_dist_full", "novelty")]
    + [f"{p}_{m}_blt" for p in ("pred", "gt") for m in ("iou", "iou_percp", "overlap", "alignment")]
    + [f"{w}_f1_avg_{s}" for w in ("vanilla", "area", "freq", "no_node_type")
       for s in ("max", "mean", "median")])
# one denoiser eval, bf16 kernels vs the fp32 plain model (phase 3's bar)
EVAL_REL_L2 = 5e-2
# the native VOC F1 against its numpy version (tests/test_eval.py)
F1_TOL = 1e-12


def _eval_config(exp_dir):
    """The full-width VG config (kernels on, bf16) at PERF.md section 4's cuts:
    16 Heun steps, synthetic data, an eval set of 64 graphs at test batch 64,
    two epochs of one training step, sampling and a checkpoint every epoch."""
    from diffusesg_torch.config import load_config
    cfg = load_config(VG["config"])
    with cfg.unlocked():
        cfg.seed = 0
        cfg.exp_dir = exp_dir
        cfg.mcmc.num_steps = EVAL_STEPS
        cfg.train.batch_size = TRAIN_BATCH
        cfg.test.batch_size = EVAL_GRAPHS
        cfg.test.eval_size = EVAL_GRAPHS
        cfg.train.max_epoch = 2
        cfg.train.sample_interval = 1
        cfg.train.save_interval = 1
        cfg.dataset.synthetic_num_train = TRAIN_BATCH
        cfg.dataset.synthetic_num_test = EVAL_GRAPHS
    return cfg


def _in_training_sampling(cfg, dev, bundle):
    """``go_training`` with ``get_mc_sampler(cfg)`` for epochs 0 and 1: the
    largest-beta EMA samples the eval set after each epoch, the model's
    parameters, Adam's state and the training noise stream bit-equal around
    each pass, and epoch 0's sanity-check row reads every MMD 0.0."""
    import csv

    from diffusesg_torch.models import build_model
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train import (create_train_state, go_training, make_eval_step,
                                       make_optimizer, make_train_step, train_step_config_from)
    from diffusesg_torch.train import trainer

    model = build_model(cfg, device=dev, seed=0)
    state = create_train_state(model, list(cfg.train.ema_coef),
                               make_optimizer(cfg.train.lr_init, cfg.train.lr_dacey, 1,
                                              cfg.train.weight_decay))
    noise = TorchNoise(0, dev)

    def snapshot():
        return ([p.detach().clone() for p in state.params()],
                [t.clone() for st in state.opt.state.values() for t in st.values()],
                noise.gen.get_state(), noise.host_gen.get_state(), state.step)

    real, passes = trainer.sg_go_sampling, []

    def watched(model_, params, *args, **kw):
        before = snapshot()
        out = real(model_, params, *args, **kw)
        torch.cuda.synchronize()
        after = snapshot()
        same = (all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
                and 0 < len(before[1]) == len(after[1])
                and all(torch.equal(a, b) for a, b in zip(before[1], after[1]))
                and all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(before[2:4], after[2:4]))
                and before[4] == after[4])
        passes.append((kw["epoch"], kw["sanity_check"], same, out["_seconds"]))
        return out

    step_cfg = train_step_config_from(cfg)
    trainer.sg_go_sampling = watched
    t0 = time.perf_counter()
    try:
        go_training(model, state, make_train_step(model, step_cfg), make_eval_step(model, step_cfg),
                    cfg, bundle, mc_sampler=get_mc_sampler(cfg), noise=noise)
    finally:
        trainer.sg_go_sampling = real
    torch.cuda.synchronize()
    with open(os.path.join(cfg.logdir, "eval_results.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    log(f"eval: go_training with the sampler, {state.step} steps at batch {TRAIN_BATCH} and "
        f"{len(passes)} sampling passes of {EVAL_GRAPHS} graphs in "
        f"{time.perf_counter() - t0:.1f} s; "
        "per pass (epoch, sanity check, training state bit-equal, seconds): "
        + "; ".join(f"({e}, {sc}, {same}, {sec['sampling_decode']:.2f} + "
                    f"{sec['metrics_artifacts']:.2f})" for e, sc, same, sec in passes)
        + f"; epoch-0 MMDs {[float(rows[0][k]) for k in MMD_KEYS] if rows else None}")
    if [(e, sc, same) for e, sc, same, _ in passes] != [(0, True, True), (1, False, True)]:
        fail(f"in-training sampling passes {passes}: expected epochs 0 (sanity check) and 1, "
             "each leaving the training state bit-equal")
    if [r["model_nm"] for r in rows] != ["training_e00000", "training_e00001"] or \
            any(float(rows[0][k]) != 0.0 for k in MMD_KEYS):
        fail("epoch 0's sanity-check row must read every MMD 0.0")


def _run_dirs(root):
    import glob
    return {r.rsplit("_", 1)[1]: r for r in glob.glob(os.path.join(root, "*", "*"))}


def check_eval_slice(dev, smi: str, run_training: bool = True) -> dict:
    """Phase 8, the eval slice on the card; returns its launch counts."""
    import glob

    import numpy as np

    from diffusesg_torch.cli import eval as eval_cli
    from diffusesg_torch.config import load_config
    from diffusesg_torch.data import load_data
    from diffusesg_torch.data.loader import split_eval_set
    from diffusesg_torch.eval import compute_bbox_f1
    from diffusesg_torch.eval.native import compute_bbox_f1_native, get_lib
    from diffusesg_torch.models import build_model
    from diffusesg_torch.models.precond import precond_forward
    from diffusesg_torch.ops import cuda_build
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.sampling.decode import decode_samples
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.sampling.orchestrator import inpaint_masks, xyxy_in_unit
    from diffusesg_torch.train import create_train_state, make_optimizer
    from diffusesg_torch.utils.checkpoint import load_weights, read_checkpoint, save_checkpoint
    from diffusesg_torch.utils.logging_utils import set_seed_and_logger

    exp_dir = os.path.join("build", "smoke_runs", "eval")
    shutil.rmtree(exp_dir, ignore_errors=True)
    cfg = _eval_config(exp_dir)
    set_seed_and_logger(cfg, mode="train", comment="smoke", log_level="WARNING")
    t0 = time.perf_counter()
    bundle = load_data(cfg, data_root="/nonexistent")
    log(f"eval: {len(bundle.train)} + {len(bundle.test)} synthetic scene graphs in "
        f"{time.perf_counter() - t0:.1f} s")
    cuda_build.reset_launches()
    if run_training:
        _in_training_sampling(cfg, dev, bundle)
        epoch = 1
    else:  # a checkpoint of the seeded model
        state = create_train_state(build_model(cfg, device=dev, seed=0), list(cfg.train.ema_coef),
                                   make_optimizer(cfg.train.lr_init, cfg.train.lr_dacey, 1))
        save_checkpoint(os.path.join(cfg.model_ckpt_dir, "00000"), state, {"epoch": 0})
        epoch = 0
    ckpt = os.path.join(cfg.model_ckpt_dir, f"{epoch:05d}.pt")
    beta = max(cfg.train.ema_coef)

    # cli.eval on that checkpoint, default device: plain, then inpainted
    eval_root = os.path.join(exp_dir, "cli")
    args = ["-p", cfg.logdir, "--specify_epoch", str(epoch), "--use_ema", str(beta),
            "--data_root", "/nonexistent", "-l", "WARNING", "-o", f"exp_dir={eval_root}"]
    torch.cuda.reset_peak_memory_stats()
    results = {}
    for tag, extra in (("plain", []), ("inpaint", ["--inpaint_frac", "0.5"])):
        t0 = time.perf_counter()
        (results[tag],) = eval_cli.main(args + ["-m", tag] + extra)
        torch.cuda.synchronize()
        results[tag]["_wall"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = dict(cuda_build.LAUNCHES)
    by_kernel = cuda_build.launches_by_kernel()
    log(f"eval: launches of phase 8 (go_training with the sampler and both cli.eval runs) "
        f"{json.dumps(by_kernel, sort_keys=True)}")
    for name in FORWARD_KERNELS:
        if by_kernel.get(name, 0) == 0:
            fail(f"the eval slice never launched {name}")

    runs = _run_dirs(eval_root)
    outs = {}
    for tag, metrics in results.items():
        keys = [k for k in metrics if not k.startswith("_")]
        bad = [k for k in METRIC_KEYS if not (k in metrics and np.isfinite(metrics[k]))]
        if keys != METRIC_KEYS or bad:
            fail(f"cli.eval {tag}: metric keys {keys}; missing or not finite: {bad}")
        (outs[tag],) = glob.glob(os.path.join(runs[tag], "sampling_during_evaluation", "*"))
        for name in ("final_samples_array.npz", "gen_scene_graph.txt"):
            if not os.path.exists(os.path.join(outs[tag], name)):
                fail(f"cli.eval {tag} wrote no {name}")
        if not os.path.exists(os.path.join(runs[tag], "eval_results.csv")):
            fail(f"cli.eval {tag} wrote no eval_results.csv")
        sec = metrics["_seconds"]
        plots = sorted(os.path.basename(p) for p in glob.glob(os.path.join(outs[tag], "*.png")))
        log(f"eval: cli.eval {tag}: one sg_go_sampling over {EVAL_GRAPHS} graphs at "
            f"{EVAL_STEPS} Heun steps, {sec['sampling_decode']:.3f} s sampling + decode, "
            f"{sec['metrics_artifacts']:.3f} s metrics + artifacts "
            f"({metrics['_wall']:.1f} s for the whole cli.eval call, data and model included); "
            f"{EVAL_GRAPHS / sec['sampling_decode']:.1f} graphs sampled per second; "
            f"plots written: {len(plots) > 0} ({len(plots)} png)")
        log(f"eval: cli.eval {tag} metrics: " + ", ".join(f"{k} {metrics[k]:.6g}"
                                                          for k in METRIC_KEYS))
    log(f"eval: peak memory of the two cli.eval runs {peak:.2f} GiB on {smi}")

    # the inpainted run's known entries equal the ground truth's decode
    res = dict(np.load(os.path.join(outs["inpaint"], "final_samples_array.npz")))
    flags = res["gt_node_flags"]
    _, known = inpaint_masks(flags, 0.5)
    pair = known[:, :, None] & known[:, None, :]
    exact = (np.array_equal(res["samples_x"][known], res["gt_x"][known])
             and np.array_equal(res["samples_x_bbox"][known], res["gt_x_bbox"][known])
             and np.array_equal(res["samples_a"][pair], res["gt_a"][pair]))
    unknown = flags & ~known
    moved = not np.array_equal(res["samples_x"][unknown], res["gt_x"][unknown])
    log(f"eval: inpainted run, {int(known.sum())} known nodes and {int(pair.sum())} known "
        f"pairs equal the ground truth's decode exactly: {exact}; the {int(unknown.sum())} "
        f"unknown nodes differ from it: {moved}")
    if not (exact and moved):
        fail("inpainting did not pin the known entries exactly, or pinned everything")

    # the native VOC F1: built on this machine, equal to numpy on these samples
    lib = get_lib()
    if lib is None:
        fail("the native VOC F1 library did not build")
    pred, gt = xyxy_in_unit(res["samples_x_bbox"]), xyxy_in_unit(res["gt_x_bbox"])
    f1_args = (pred, res["samples_x"], res["samples_node_flags"], gt, res["gt_x"], flags)
    t0 = time.perf_counter()
    nat = compute_bbox_f1_native(*f1_args)
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = compute_bbox_f1(*f1_args)
    t_np = time.perf_counter() - t0
    err = float(np.abs(nat - ref).max())
    log(f"eval: native VOC F1 ({lib._name}) vs numpy on the inpainted samples, "
        f"{nat.shape[0]}x{nat.shape[1]} pairs: max abs difference {err:.3e} (tolerance "
        f"{F1_TOL} + {F1_TOL} rel); {t_nat * 1e3:.2f} ms native, {t_np * 1e3:.2f} ms numpy")
    if not np.allclose(nat, ref, rtol=F1_TOL, atol=F1_TOL):
        fail("the native VOC F1 disagrees with numpy")

    # the same inpainted sample with the kernels off: the fp32 plain model on
    # the card, the same checkpoint, inputs and draws (these launches are a
    # comparison, not the path: they come after the counts were read)
    payload = read_checkpoint(ckpt)
    idx = list(payload["ema_betas"]).index(beta)
    ecfg = load_config(os.path.join(runs["inpaint"], "config.yaml"))
    kmodel = build_model(ecfg, device=dev, seed=0)
    load_weights(kmodel, payload, idx)
    with ecfg.unlocked():
        ecfg.tpu.use_pallas_attention = False
        ecfg.tpu.compute_dtype = "float32"
    pmodel = build_model(ecfg, device=dev, seed=0)
    load_weights(pmodel, payload, idx)
    if not kmodel.use_kernels or pmodel.use_kernels or pmodel.dtype != torch.float32:
        fail("the kernel and plain models are not what they should be")
    test = split_eval_set(load_data(ecfg, eval_mode=True, data_root="/nonexistent").test,
                          EVAL_GRAPHS, seed=ecfg.seed)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    mask_a, known_t = inpaint_masks(test.node_flags, 0.5)
    flags_t = put(test.node_flags)
    ip = dict(gt_adjs=put(test.adjs), gt_nodes=put(test.nodes), mask_adjs=put(mask_a),
              mask_nodes=put(known_t))
    sampler = get_mc_sampler(ecfg)
    first = {}

    def sample(model, record):
        def net(*args):  # the network inside the preconditioning
            out = model(*args)
            if record is not None and "net" not in record:
                record["net"] = (tuple(t.clone() for t in args), tuple(t.clone() for t in out))
            return out

        def denoiser(a, x, sigmas, sc_a, sc_x):
            out = precond_forward(net, "edm", a, x, flags_t, sigmas, sc_a, sc_x)
            if record is not None and "denoised" not in record:
                record["denoised"] = ((a.clone(), x.clone(), sigmas.clone(), sc_a.clone(),
                                       sc_x.clone()), tuple(t.clone() for t in out))
            return out
        return sampler.sample(denoiser, flags_t, 5, 1, inpaint=ip,
                              noise=TorchNoise(int(ecfg.seed) + epoch, dev))
    k_a, k_x = sample(kmodel, first)
    p_a, p_x = sample(pmodel, None)
    # the first step's inputs, known entries pinned, through the plain model:
    # the denoised output (c_skip x + c_out F) and the network's own output F,
    # which the skip term cannot hide
    with torch.inference_mode():
        (a, x, sigmas, sc_a, sc_x), got_d = first["denoised"]
        want_d = precond_forward(pmodel, "edm", a, x, flags_t, sigmas, sc_a, sc_x)
        net_args, got_f = first["net"]
        want_f = pmodel(*net_args)
    for what, got, want in (("denoised output", got_d, want_d), ("network output", got_f, want_f)):
        for g, w, part in zip(got, want, ("adj", "node")):
            rel = float((g.float() - w).norm() / w.norm())
            log(f"eval: inpainted sample's first {what} (known entries pinned), card bf16 "
                f"kernels vs card fp32 plain model, {part} relative L2 {rel:.3e} (limit "
                f"{EVAL_REL_L2})")
            if not rel < EVAL_REL_L2:
                fail(f"the inpainted sample's first {part} {what} disagrees with the fp32 "
                     "plain model")
    rel_final = [float((k - p).norm() / p.norm()) for k, p in ((k_a, p_a), (k_x, p_x))]
    same_raw = (np.array_equal(k_a.cpu().numpy(), res["raw_a"])
                and np.array_equal(k_x.cpu().numpy(), res["raw_x"]))
    dec = [decode_samples(a, x, flags_t, ecfg.train.node_encoding, ecfg.train.edge_encoding,
                          VG["node_types"], VG["edge_types"]) for a, x in ((k_a, k_x), (p_a, p_x))]
    fl = flags_t.bool()
    pr = fl[:, :, None] & fl[:, None, :]
    node_eq = float((dec[0].node_types == dec[1].node_types)[fl].float().mean())
    edge_eq = float((dec[0].adj_types == dec[1].adj_types)[pr].float().mean())
    log(f"eval: reading, not a gate: after {EVAL_STEPS} steps with churn the kernels' final "
        f"inpainted samples are {rel_final[0]:.3e} (adj) / {rel_final[1]:.3e} (node) relative "
        f"L2 from the fp32 plain model's; decoded node types equal {node_eq:.1%}, edge types "
        f"{edge_eq:.1%} of valid entries; the kernel run repeats cli.eval's samples "
        f"bit for bit: {same_raw}")
    return launches


# ------------------------------------------------------------------ phase 9

SERVE_STEPS = 16
SERVE_BATCH = 16
SERVE_SEED = 11
SERVE_UP_S = 120  # how long a cli.serve process may take to answer /healthz


def _reference_pth(model, cfg, path: str):
    """A checkpoint in the reference's schema (trainer_utils.py:168-185) from
    the seeded model: ``model`` under ``module.model.`` with the two buffers
    the reference saves, one ``model_ema_beta_*`` set per beta of the config
    that differs from the raw weights, the config dict and the epoch.
    Returns (raw state dict, {beta: EMA state dict})."""
    gen = torch.Generator().manual_seed(9)
    raw = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    bufs = {k: v.detach().cpu() for k, v in model.named_buffers()}

    def ref(sd):
        return {"module.model." + k: v for k, v in {**sd, **bufs}.items()}
    ckpt = {"model": ref(raw), "config": cfg.to_dict(), "epoch": 3}
    emas = {}
    for i, beta in enumerate(sorted(cfg.train.ema_coef)):
        emas[beta] = {k: v + 1e-3 * (i + 1) * torch.randn(v.shape, generator=gen)
                      for k, v in raw.items()}
        ckpt[f"model_ema_beta_{beta:.4f}"] = ref(emas[beta])
    torch.save(ckpt, path)
    return raw, emas


def _http(url: str, payload=None, timeout: float = 300.0):
    """(status, JSON body) of one request to a server on this machine."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=None if payload is None else json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _burst(base: str, bodies: list) -> tuple[list, float]:
    """The requests sent at once, one thread each; (answers, wall seconds)."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(bodies)) as pool:
        answers = list(pool.map(lambda b: _http(base + "/v1/generate", b), bodies))
    return answers, time.perf_counter() - t0


def _in_thread(batcher):
    """``serve(batcher, port)`` in a thread on a free port; (httpd, base URL)."""
    import threading

    from diffusesg_torch.serving import serve
    httpd = serve(batcher, _free_port())
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _serve_process(argv: list, what: str):
    """``python -m diffusesg_torch.cli.serve`` with its default device, up
    and answering /healthz; (process, base URL, seconds to come up)."""
    port = _free_port()
    log_path = os.path.join("build", "smoke_runs", "serve", f"{what}.log")
    with open(log_path, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", "diffusesg_torch.cli.serve", *argv,
                                 "--port", str(port)], stdout=out, stderr=subprocess.STDOUT)
    base, t0 = f"http://127.0.0.1:{port}", time.perf_counter()
    while True:
        if proc.poll() is not None:
            with open(log_path) as f:
                fail(f"cli.serve {what} exited with {proc.returncode}: {f.read()[-2000:]}")
        try:
            code, health = _http(base + "/healthz", timeout=2)
            if code == 200 and health.get("status") == "ok":
                return proc, base, time.perf_counter() - t0
        except OSError:
            pass
        if time.perf_counter() - t0 > SERVE_UP_S:
            proc.kill()
            fail(f"cli.serve {what} did not answer /healthz in {SERVE_UP_S} s")
        time.sleep(0.5)


def _stop(proc) -> None:
    proc.terminate()
    try:
        proc.wait(30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(30)


def check_serving(dev, smi: str) -> dict:
    """Phase 9, the serving slice on the card; returns its launch counts."""
    import numpy as np

    from diffusesg_torch.cli import import_ckpt
    from diffusesg_torch.cli import serve as serve_cli
    from diffusesg_torch.config import load_config
    from diffusesg_torch.models import build_model
    from diffusesg_torch.ops import cuda_build
    from diffusesg_torch.serving import BatchingSampler, fixed_batch, load_artifact
    from diffusesg_torch.serving.export import make_serving_fn
    from diffusesg_torch.serving.server import _graph_dict
    from diffusesg_torch.utils.checkpoint import latest_checkpoint, read_checkpoint
    from diffusesg_torch.utils.perf import device_peak_tflops, estimate_model_flops

    root = os.path.join("build", "smoke_runs", "serve")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cfg = load_config(VG["config"])

    # 1. a reference-schema .pth of the seeded model -> cli.import_ckpt
    t0 = time.perf_counter()
    seeded = build_model(cfg, device="cpu", seed=0)
    pth, run = os.path.join(root, "reference.pth"), os.path.join(root, "run")
    raw, emas = _reference_pth(seeded, cfg, pth)
    names = [k for k, _ in seeded.named_parameters()]
    del seeded
    path = import_ckpt.main([pth, "-o", run])
    payload = read_checkpoint(latest_checkpoint(os.path.join(run, "models_ckpt")))
    same = (all(torch.equal(payload["params"][k], v) for k, v in raw.items())
            and payload["ema_betas"] == sorted(emas)
            and all(torch.equal(t, emas[b][k]) for b, ema in zip(payload["ema_betas"],
                                                                  payload["ema_params"])
                    for k, t in zip(names, ema)))
    log(f"serve: cli.import_ckpt of a reference-schema .pth ({len(emas)} EMA sets, "
        f"module.model. prefixes, relative_position_index and attn_mask buffers) -> {path} in "
        f"{time.perf_counter() - t0:.1f} s; weights and EMA sets bit-equal to what went in: "
        f"{same}")
    if not same:
        fail("the imported run dir does not hold the weights that went in")
    del payload, raw, emas

    # 2. cli.serve's loader, BatchingSampler and serve() in this process
    argv = ["-p", run, "--num_steps", str(SERVE_STEPS), "--batch_size", str(SERVE_BATCH)]
    fn, complete_fn, batch, n, scfg, bounds, (model, sampler) = serve_cli._load_from_checkpoint(
        serve_cli.build_serve_parser().parse_args(argv))
    if (not model.use_kernels or model.dtype != torch.bfloat16 or batch != SERVE_BATCH
            or sampler.num_steps != SERVE_STEPS):
        fail(f"cli.serve's loader built {model.dtype} kernels={model.use_kernels} batch {batch}")
    calls = collections.Counter()  # sampler batches run while the counts are read

    def counted(f, kind):
        def call(*args, **kw):
            calls[kind] += 1
            return f(*args, **kw)
        return call
    gen = counted(fn, "generate")
    batcher = BatchingSampler(gen, batch, n, linger_ms=50.0,
                              complete_fn=counted(complete_fn, "complete"),
                              num_node_types=bounds[0], num_edge_types=bounds[1])
    httpd, base = _in_thread(batcher)
    try:
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        batcher.warmup()
        warm_s = time.perf_counter() - t0

        rng = np.random.default_rng(0)
        bodies = [{"num_graphs": int(k), "num_nodes": [int(c) for c in rng.integers(1, n + 1, k)]}
                  for k in rng.integers(1, 5, 8)]
        answers, _ = _burst(base, bodies)
        code, stats = _http(base + "/v1/stats")
        in_box, ok = [], True
        for body, (code, ans) in zip(bodies, answers):
            graphs = ans.get("graphs", [])
            ok &= code == 200 and [len(g["nodes"]) for g in graphs] == body["num_nodes"]
            for g, c in zip(graphs, body["num_nodes"]):
                ok &= (len(g["bboxes"]) == c and all(0 <= t < bounds[0] for t in g["nodes"])
                       and all(0 <= i < c and 0 <= j < c and 1 <= p < bounds[1]
                               for i, j, p in g["edges"]))
                in_box += [0.0 <= v <= 1.0 for bb in g["bboxes"] for v in bb]
        log(f"serve: a burst of {len(bodies)} unseeded /v1/generate requests of "
            f"{[len(b['num_nodes']) for b in bodies]} graphs ({sum(len(b['num_nodes']) for b in bodies)} "
            f"in all) answered in {stats['batches']} batches of {batch}; every answer in range: "
            f"{ok}; box coordinates in [0, 1]: {np.mean(in_box):.1%}")
        if not ok or not stats["batches"] < len(bodies):
            fail("the burst's answers are out of range, or the server did not pack them")

        counts = [n, 23, 5]
        seeded = {"num_graphs": len(counts), "num_nodes": counts, "seed": SERVE_SEED}
        (c1, a1), (c2, a2) = _http(base + "/v1/generate", seeded), _http(base + "/v1/generate",
                                                                          seeded)
        flags = np.zeros((batch, n), bool)
        for i, c in enumerate(counts):
            flags[i, :c] = True
        adj, node, bbox = gen(SERVE_SEED, flags)
        direct = [_graph_dict(adj[i], node[i], bbox[i], flags[i]) for i in range(len(counts))]
        padded_zero = not (adj[len(counts):].any() or node[len(counts):].any()
                           or bbox[len(counts):].any())
        filled = flags.copy()
        filled[len(counts):, :n] = True
        same_rows = all(np.array_equal(a[:len(counts)], b[:len(counts)])
                        for a, b in zip((adj, node, bbox), gen(SERVE_SEED, filled)))
        a1.pop("latency_ms", None), a2.pop("latency_ms", None)
        log(f"serve: the seeded request twice gives identical JSON: {a1 == a2}; equal to the "
            f"serving core called at seed {SERVE_SEED} with the same padded flags: "
            f"{a1.get('graphs') == direct}; the {batch - len(counts)} all-False rows decode to "
            f"zeros: {padded_zero}; the requested rows bit-equal with those rows filled "
            f"instead: {same_rows}")
        if not (c1 == c2 == 200 and a1 == a2 and a1["graphs"] == direct and padded_zero
                and same_rows):
            fail("seeded serving is not deterministic, or padding rows leak")

        known = [{"index": i, "type": t} for i, t in enumerate((3, 17, 42, 99))]
        known[0]["bbox"] = [0.25, 0.5, 0.125, 0.2]
        code, comp = _http(base + "/v1/complete", {"num_nodes": 12, "seed": 5,
                                                   "known_nodes": known,
                                                   "known_edges": [[0, 1, 7]]})
        g = comp["graphs"][0] if code == 200 else {}
        pinned = (code == 200 and g["nodes"][:4] == [3, 17, 42, 99] and [0, 1, 7] in g["edges"]
                  and np.allclose(g["bboxes"][0], known[0]["bbox"], rtol=0, atol=1e-5))
        code_h, health = _http(base + "/healthz")
        log(f"serve: /v1/complete with 4 pinned node types, one pinned box and one pinned edge: "
            f"pinned parts verbatim {pinned} ({len(g.get('nodes', []))} nodes); /healthz "
            f"{code_h} {health}")
        if not pinned or code_h != 200 or health.get("batch_size") != batch:
            fail("completion did not return its pinned parts, or /healthz failed")

        launches = dict(cuda_build.LAUNCHES)
        by_kernel = cuda_build.launches_by_kernel()
        n_batches = sum(calls.values())
        log(f"serve: launches of phase 9's server ({n_batches} sampler batches of {batch}: "
            f"{dict(calls)}) {json.dumps(by_kernel, sort_keys=True)}; per batch "
            + ", ".join(f"{k} {v / n_batches:g}" for k, v in sorted(by_kernel.items())))
        for name in FORWARD_KERNELS:
            if by_kernel.get(name, 0) == 0:
                fail(f"the server never launched {name}")
        if any(k.endswith("_bwd") for k in by_kernel):
            fail(f"the server launched a backward kernel: {by_kernel}")

        chunked = fixed_batch(make_serving_fn(model, sampler, scfg, chunk_steps=4), batch, n, dev)
        same_chunk = all(np.array_equal(a, b) for a, b in zip(chunked(SERVE_SEED, flags),
                                                              (adj, node, bbox)))
        log(f"serve: chunk_steps=4 over {SERVE_STEPS} steps equals the unchunked run at seed "
            f"{SERVE_SEED}: {same_chunk}")
        if not same_chunk:
            fail("chunked sampling differs from the unchunked run")

        # 3. cli.serve --export_to, load_artifact; an artifact for the CPU is refused
        art = os.path.join(root, "artifact")
        serve_cli.main(argv + ["--export_to", art])
        art_fn, meta = load_artifact(art)
        same_art = all(np.array_equal(a, b) for a, b in zip(art_fn(SERVE_SEED, flags),
                                                            (adj, node, bbox)))
        cpu_art = os.path.join(root, "artifact_cpu")
        os.makedirs(cpu_art)
        with open(os.path.join(cpu_art, "meta.json"), "w") as f:
            json.dump(dict(meta, platforms=["cpu"]), f)
        try:
            load_artifact(cpu_art)
            refused = False
        except RuntimeError:
            refused = True
        log(f"serve: cli.serve --export_to -> {art} ({meta['format']}, platforms "
            f"{meta['platforms']}, batch {meta['batch_size']}, {meta['num_steps']} steps); the "
            f"artifact's graphs at seed {SERVE_SEED} equal the live server's: {same_art}; an "
            f"artifact for the CPU refused on the card: {refused}")
        if not (same_art and refused):
            fail("the artifact does not serve the live server's graphs, or a CPU artifact loaded")
        del art_fn

        # 5. readings: graphs/s through HTTP under bursts that fill the batch
        full = {"num_graphs": 4, "num_nodes": n}
        rates = {batch: [64 / _burst(base, [full] * 16)[1] for _ in range(2)]}
        _, lat = _http(base + "/v1/stats")
        # the host's share after the sampler: a batch's graphs as JSON
        out = gen(SERVE_SEED, np.ones((batch, n), bool))
        t0 = time.perf_counter()
        graphs = [_graph_dict(out[0][i], out[1][i], out[2][i], np.ones(n, bool))
                  for i in range(batch)]
        dict_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        json.dumps({"graphs": graphs})
        dumps_s = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    big = BatchingSampler(fixed_batch(make_serving_fn(model, sampler, scfg), 64, n, dev), 64, n,
                          linger_ms=200.0)
    httpd, base64 = _in_thread(big)
    try:
        t0 = time.perf_counter()
        big.warmup()
        warm64 = time.perf_counter() - t0
        rates[64] = [64 / _burst(base64, [full] * 16)[1] for _ in range(2)]
        _, stats64 = _http(base64 + "/v1/stats")
    finally:
        httpd.shutdown()
        httpd.server_close()
        big.close()
    flops = estimate_model_flops(scfg)["total"]
    # Heun: a second eval in every step but the last, unless it reuses the
    # first (heun_reuse_xhat without self-conditioning)
    second = sampler.self_condition or not sampler.heun_reuse_xhat
    evals = sampler.num_steps + (sampler.num_steps - 1 if second else 0)
    peak_tflops = device_peak_tflops(torch.cuda.get_device_name(0))
    mean = {b: sum(r) / len(r) for b, r in rates.items()}
    share = ", ".join(f"batch {b} {r * evals * flops / 1e12:.3f} TFLOP/s"
                      + (f" ({r * evals * flops / (peak_tflops * 1e12):.3%} of "
                         f"{peak_tflops:g})" if peak_tflops else "")
                      for b, r in mean.items())
    log(f"serve: readings (eager, {SERVE_STEPS} Heun steps, {evals} denoiser evals a graph, "
        f"{flops / 1e9:.3f} GFLOP an eval a graph by utils/perf.estimate_model_flops) on {smi}: "
        f"graphs/s through HTTP under two bursts of 16 requests x 4 full graphs "
        f"{' and '.join(f'{r:.2f}' for r in rates[batch])} at batch {batch}, "
        f"{' and '.join(f'{r:.2f}' for r in rates[64])} at batch 64 (the two bursts in "
        f"{stats64['batches']} batches there); "
        f"/v1/stats batch latency p50 {lat['latency_ms_p50']:.1f} ms, p95 "
        f"{lat['latency_ms_p95']:.1f} ms at batch {batch} ({lat['batches']} batches), "
        f"p50 {stats64['latency_ms_p50']:.1f} ms at batch 64; {batch} full graphs "
        f"({sum(len(g['edges']) for g in graphs)} edges) to dicts {dict_s * 1e3:.1f} ms "
        f"(server._graph_dict) and to JSON {dumps_s * 1e3:.1f} ms; first batch (warm-up, one "
        f"generation + one completion batch) {warm_s:.2f} s at batch {batch}, {warm64:.2f} s "
        f"(generation) at batch 64; served, from the mean rates, {share}; peak memory "
        f"{peak:.2f} GiB at batch {batch}")

    # 4. the entry point as users run it, as a process: checkpoint, then artifact
    procs = []
    try:
        proc, url, up_s = _serve_process(argv, "checkpoint")
        procs.append(proc)
        code, ans = _http(url + "/v1/generate", seeded)
        same_ckpt = code == 200 and ans["graphs"] == a1["graphs"]
        apart = [64 / _burst(url, [full] * 16)[1] for _ in range(2)]
        _stop(proc)
        proc, url, up_art = _serve_process(["--from_artifact", art], "artifact")
        procs.append(proc)
        code, ans = _http(url + "/v1/generate", seeded)
        same_art = code == 200 and ans["graphs"] == a1["graphs"]
        code_c, _ = _http(url + "/v1/complete", {"num_nodes": 3})
    finally:
        for p in procs:
            if p.poll() is None:
                _stop(p)
    log(f"serve: python -m diffusesg_torch.cli.serve -p <run dir> up in {up_s:.1f} s, the "
        f"seeded request equals the in-process answer: {same_ckpt}; reading: graphs/s under "
        f"two bursts of 16 requests x 4 full graphs with the server in its own process, batch "
        f"{SERVE_BATCH}: {' and '.join(f'{r:.2f}' for r in apart)} on {smi}; --from_artifact up in "
        f"{up_art:.1f} s, equal: {same_art}, /v1/complete answers {code_c}")
    if not (same_ckpt and same_art and code_c == 501):
        fail("cli.serve as a process does not answer as the in-process server does")
    return launches


# which kernel each device function belongs to (demangled-name fragments,
# first match wins): the backward kernels' GEMM sites and the fused MLP
# backward by their call-site tags (SwinBwd*, MlpBwd*)
OTHER = "other PyTorch ops"
KERNEL_OF = (("window_attn_bwd_kernel", "swin_attn_bwd"), ("SwinBwd", "swin_attn_bwd"),
             ("MlpBwd", "token_mlp_bwd"),
             ("ln_bwd_rows_kernel", "backward row pass + reductions (both backward kernels)"),
             ("reduce_partials_kernel", "backward row pass + reductions (both backward kernels)"),
             ("col_sums_kernel", "backward row pass + reductions (both backward kernels)"),
             ("window_attn_kernel", "swin_attn"),
             ("SwinQkv", "swin_attn"), ("SwinProj", "swin_attn"),
             ("token_mlp_kernel", "token_mlp"), ("mlp_close_kernel", "token_mlp"),
             ("MergeProj", "patch_merge"),
             ("BreakupIn", "patch_breakup"), ("breakup_rows_kernel", "patch_breakup"),
             ("BreakupOut", "patch_breakup"), ("readout_kernel", "readout"))
# device functions printed under their own names beside their kernel's total:
# the parts of the redesigned kernels (label, name fragment, kernel)
PARTS = (("window core", "window_attn_kernel<", "swin_attn"),
         ("qkv GEMM", "SwinQkv", "swin_attn"), ("proj GEMM", "SwinProj", "swin_attn"),
         ("fused MLP", "token_mlp_kernel", "token_mlp"),
         ("closing pass", "mlp_close_kernel", "token_mlp"),
         ("breakup first GEMM", "BreakupIn", "patch_breakup"),
         ("breakup row pass", "breakup_rows_kernel", "patch_breakup"),
         ("breakup second GEMM", "BreakupOut", "patch_breakup"),
         ("backward window core", "window_attn_bwd_kernel", "swin_attn_bwd"),
         ("qkv recompute", "SwinBwdQkv", "swin_attn_bwd"),
         ("attention weight gradients", "SwinBwdDw", "swin_attn_bwd"),
         ("dy Wproj", "SwinBwdDattn", "swin_attn_bwd"),
         ("dqkv Wqkv", "SwinBwdDhn", "swin_attn_bwd"),
         ("fused MLP backward", "MlpBwdFused", "token_mlp_bwd"),
         ("MLP weight gradients", "MlpBwdDw", "token_mlp_bwd"),
         ("MLP chain fc1 recompute", "MlpBwdFc1", "token_mlp_bwd"))


def profile_eval(ev, eager_ms: float, tag: str) -> None:
    """Device time of one batch-64 denoiser eval by kernel (torch.profiler),
    and the launches of each kernel in that eval."""
    with torch.inference_mode():
        profile_call(ev, f"one batch-64 {tag} eval", eager_ms)


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
    split = []
    for label, frag, kernel in PARTS:
        ms, n = sum(t for t, _, k in funcs if frag in k), sum(c for _, c, k in funcs if frag in k)
        if n and groups.get(kernel):
            split.append(f"{label} {ms:.3f} ms x{n} ({ms / groups[kernel]:.1%} of {kernel})")
    log(f"profile parts ({what}): " + "; ".join(split))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-slice", action="store_true", help="skip phases 3 to 9")
    ap.add_argument("--no-train", action="store_true",
                    help="skip phases 4 and 6, and phase 8's training run")
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
    check_sass(cuda_build.build())
    from diffusesg_torch.ops import mlp_block_kernel as mk
    from diffusesg_torch.ops import mm_microbench as mm
    from diffusesg_torch.ops import patch_resample as pr
    from diffusesg_torch.ops import readout_kernel as rk
    from diffusesg_torch.ops import swin_block_v3 as sw
    log("Hopper GEMM tiles (rows, columns, blocks an SM, whole rows), as the library reports "
        "them: " + ", ".join(f"swin_attn {w} C{c} {sw.attn_gemm_tile(c, w)}"
                             for c in (96, 192, 384, 768) for w in ("qkv", "proj"))
        + f", swin_attn qkv C384 64-row panels {sw.attn_gemm_tile(384, 'qkv', True)}"
        + ", " + ", ".join(f"patch_breakup {w} {cin}->{dim} {pr.breakup_tile(cin, dim, w)}"
                           for cin, dim in ((1536, 1536), (768, 768), (384, 384))
                           for w in ("in", "out"))
        + ", " + ", ".join(f"patch_merge C{c} {pr.merge_tile(c)}" for c in (96, 192, 384))
        + f", patch_merge C96 64-row panels {pr.merge_tile(96, True)}; readout (rows, "
          f"warpgroups, blocks an SM) {rk.readout_tile()}; backward: "
        + ", ".join(f"swin_attn_bwd {w} C{c} {sw.attn_bwd_tile(c, w)}"
                    for c in (96, 192, 384, 768) for w in ("qkv", "stream", "wgrad"))
        + ", " + ", ".join(f"token_mlp_bwd fused C{c} {mk.mlp_bwd_fused_tile(c)}"
                           for c in (96, 192, 384, 768))
        + ", " + ", ".join(f"token_mlp_bwd {w} C{c} {mk.mlp_bwd_tile(c, w)}"
                           for c in (384, 768) for w in ("fc1", "stream"))
        + ", " + ", ".join(f"token_mlp_bwd wgrad {j} columns {mk.mlp_bwd_tile(j, 'wgrad')}"
                           for j in (96, 384, 768, 3072))
        + "; mm_accumulate (rows, columns, blocks an SM, shared bytes): "
        + ", ".join(f"{m}x{k}x{n} {t} {mm.kernel_tile(n, k, t == 'int8')}"
                    for m, k, n in mm.SHAPES for t in ("bf16", "int8")))
    log("grid plans, as the library reports them: blocks of the window core an SM holds "
        + ", ".join(f"{q} L={L} {cuda_build.blocks_per_sm(q, L)}"
                    for q in ("dsg_swin_attn_core_per_sm", "dsg_window_attention_per_sm",
                              "dsg_swin_attn_bwd_core_per_sm")
                    for L in (64, 100))
        + "; token_mlp (rows, hidden chunk, blocks an SM) "
        + ", ".join(f"C{c} {mk.mlp_tile(c)}" for c in (64, 96, 192, 384, 768)))

    results, entry_cases = check_kernels(dev)
    # launch counts per path: {path: (sampling or entries run, training run)}
    counts, eval_counts, serve_counts = {}, {}, {}
    if not args.no_slice:
        vg, _ = check_slice(dev, smi, VG)
        vg_train = {} if args.no_train else check_training(dev, smi, VG)
        coco, coco_model = check_slice(dev, smi, COCO)
        entries = check_entries(dev, coco_model, entry_cases)
        del coco_model
        torch.cuda.empty_cache()
        coco_train = {} if args.no_train else check_training(dev, smi, COCO,
                                                             find_largest_batch=False)
        counts = dict(vg=(vg, vg_train), coco=(coco, coco_train), entries=(entries, {}))
        check_small_config(dev)
        eval_counts = check_eval_slice(dev, smi, run_training=not args.no_train)
        serve_counts = check_serving(dev, smi)
    # launches: of the path's sampling (or entries) run for the forward
    # kernels, of its training run for the backward kernels; launches_train:
    # of the training run; launches_eval: of phase 8 and launches_serve: of
    # phase 9 (the VG forward kernels).  A case that moves several counters
    # (an entry over two kernels) reports the least of them.
    for r in results:
        keys, kernel, path = r.pop("keys"), r.pop("kernel"), r.pop("path")
        run, train = counts.get(path, ({}, {}))
        r["launches_train"] = min(train.get(k, 0) for k in keys)
        r["launches_eval"] = min(eval_counts.get(k, 0) for k in keys) if path == "vg" else 0
        r["launches_serve"] = min(serve_counts.get(k, 0) for k in keys) if path == "vg" else 0
        r["launches"] = (r["launches_train"] if kernel.endswith("_bwd")
                         else min(run.get(k, 0) for k in keys))
        if r["launches"] == 0 and not (args.no_slice or (args.no_train and
                                                         kernel.endswith("_bwd"))):
            fail(f"{r['name']} was never launched on its path")
    log(smi)
    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
