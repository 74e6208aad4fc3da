"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py            # every phase, as a CI check
    python3 chip_smoke.py --no-slice # build + kernels vs plain only
    python3 chip_smoke.py --no-train # phases 1-3, 5, 7-9, 11 and 12 (8 from a seeded checkpoint)

Phases, each printed on its own line:
  1. the card (nvidia-smi name and power limit), the kernels' nvcc build, and
     the built library's SASS: every wgmma kernel (each hgemm_kernel, the
     readout_kernel and its output head readout_kernel_head, patch_embed_kernel
     and the fused MLP backward mlp_bwd_kernel) must issue
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
     the denoiser's two full-resolution ends (patch_embed and the output
     head, readout at its "head" shapes) at VG's and COCO's grids, self-
     conditioning on, padded node counts;
     the resampling layers' backwards (patch_merge_bwd, patch_breakup_bwd)
     against ``plain_vjp`` of their plain versions on the card;
     for swin_attn, patch_merge, patch_breakup, readout, swin_attn_bwd,
     token_mlp_bwd, patch_merge_bwd and patch_breakup_bwd also the device
     time and count of each of their launches
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
     at batch 16 and 64, and the profile of one batch-64 eval, in which no
     PyTorch LayerNorm may run (the two ends are patch_embed and the head);
  4. the training slice: the same model takes 8 training steps at batch 64
     through ``go_training`` (its compiled step, train/compiled.py, since
     phase 13's slice; its graphs are read) on synthetic scene graphs (seed
     0): finite losses,
     12 launches of each backward kernel per step and 3 of each resampling
     backward (COCO: 18 and 2), parameters, Adam moments
     and the 5 EMAs move and the EMAs follow their warm-up ramp, a checkpoint
     restores bit-equal state; the gradients of the card's bf16 kernel model
     are held against the fp32 plain model on the CPU at batch 4 (a leaf that
     the plain model in bf16 cannot hold under the limit either is held at
     the kernel instead, against its plain backward on the same inputs, on 8
     batches, beside its window core alone, its recomputed operands in bf16
     ulps and two controls without the kernel); then ms per training step at
     batch 64, its peak memory, the largest power-of-two batch that fits, and
     the profile of one step (the window core and the fused MLP under their
     own names); the timed steps are the eager step's;
  5. the COCO-Stuff slice: the full-width COCO model (30,690,020 parameters,
     window 10, bf16) answers requests of 40, 33, 12 and 5 nodes and then 16
     full graphs through ``serving.generate``, checked as phase 3 (node types
     < 171, edge types < 7); then the kernels with an entry of their own are
     driven through those entries: ``WindowAttention.forward`` of the model's
     shifted block against the fp32 CPU module, ``fused_swin_attn_block`` and
     ``fused_swin_block`` on a pre-rolled grid against the model's own block,
     and ``scripts/microbench_int8_torch.py``;
  6. the COCO-Stuff training slice: 8 steps at batch 64 through
     ``go_training`` (compiled) as phase 4, 18 launches of each backward
     kernel per step;
  7. ``configs/vg_small_test.yaml``, whose ``tpu`` block switches the kernels
     off (float32, head_dim 16, which no kernel covers): its denoiser on the
     card against the same fp32 plain model on the CPU (relative L2 1e-4),
     then two training steps through ``cli.train`` with its default device;
     no kernel may launch;
  8. the eval slice on the full-width VG model (kernels on, bf16; 16 Heun
     steps, an eval set of 64 synthetic graphs at batch 64): ``go_training``
     (its compiled training and test steps) with the sampler for epochs 0
     and 1 (epoch 0's sanity check reads every
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
  10. data parallel (``torch.distributed``, world 1 through NCCL: the card's
     machine has one card, and NCCL refuses two ranks on one): the
     rendezvous from torchrun's variables must start an NCCL group; the
     full-width VG model (bf16, kernels on, batch 64) takes 2 steps through
     the ``shard_map`` step, bit-equal to the single-device step on the
     same draws (parameters, Adam, the EMAs, the metrics), each step 12
     launches of each backward kernel, and 2 through the ``gspmd`` + ZeRO-1
     step, within tests/test_torch_train_step.py's bars of it, its
     checkpoint (gathered to rank 0) restoring bit-equal in a
     single-device state (both steps eager here; phase 13 (d) compiles the
     ``shard_map`` one); ``go_training`` runs 2 epochs of 2 steps with
     the group up (the data-parallel loop; at world 1 the single-device
     steps, compiled), every VG kernel launched, and its rank-0 checkpoint restores
     bit-equal in a single-device trainer; ``sg_go_sampling`` with the
     sanity check gives the same rows and metrics with the group up and
     after it is destroyed; readings (not gated): ms per step single-device
     against both data-parallel steps and the ``gspmd`` step without
     ZeRO-1, ZeRO's optimizer step against the Adam inside it, one
     all-reduce of the flat fp32 gradient, peak memory with ZeRO-1.
  11. the rest of the multi-device stack and the training leftovers: (a) the
     full-width VG model (seeded weights, bf16, kernels on; 16 Heun steps,
     batch 16) served across the device list [cuda:0, cuda:0] by
     ``make_sharded_serving_fn`` in both ``spmd_mode``s: each shard's
     decoded graphs bit-equal to the single-device core on its rows with its
     draws (its rows of the whole batch's draws under ``gspmd``, the stream
     folded with its index under ``shard_map``), each forward kernel as many
     launches on each shard as that core's, ``gspmd``'s samples against the
     whole batch on one card at phase 3's bar (relative L2 5e-2; decoded
     agreement a reading); readings: graphs/s of two shards and of one batch;
     (b) an artifact over two devices refused on this one-card process and
     served over [cuda:0, cuda:0], and ``cli.serve --devices 2`` exiting
     with the JAX package's message; (c) two tensor-parallel steps at grid
     (1, 1) through NCCL (full VG width, bf16, kernels off, batch 16)
     bit-equal to the single-device plain step, the tensor-parallel
     collectives counted and no kernel launched, its checkpoint (gathered
     over the model group) restored bit-equal on one device; (d) the host ms
     of a synchronous and an asynchronous save of that state, and an
     asynchronous save drained after the state took another step restoring
     the state at the save bit-equal; (e) phase 4's synthetic data through
     the native batcher (g++, built here) equal to the numpy path over two
     epochs.
  12. the compiled sampler (``sampling/compiled.py``: every sampler step a
     replay of a captured CUDA graph, the draws made outside it; the default
     of every caller since this phase's slice, so phases 3 and 8-11 ran it
     too): (a) the full-width VG and COCO models (bf16, kernels on, 16 Heun
     steps with churn) at batch 16 and 64, the compiled sampler's adjs,
     nodes and decoded graphs bit-equal to the eager sampler at one seed
     (a first call and an all-replay one), its launch counts equal to the
     eager run's, three variants captured, and for each variant the port's
     kernel nodes of its graph (read from the graph's own nodes,
     ``CUDAGraph.debug_dump``, demangled as the profiler does) equal to the
     kernels one eager run of the step launches (torch.profiler), whose
     wrapper counts equal the variant's launch record; readings: graphs/s of the serving
     core compiled and eager, host to host, in turns; host CUDA calls a
     step (torch.profiler); seconds of each variant's first use and
     capture; the graph pool's bytes; (b) VG: the completion core with
     inpainting, 4 interim snapshots and ``chunk_steps=4`` bit-equal to
     eager; (c) ``sg_go_sampling`` with an EMA (plain, the sanity check,
     ``inpaint_frac`` 0.5), every array equal to its eager pass; (d) two
     shards of the card, ``gspmd`` and ``shard_map``, each block bit-equal
     to the eager sharded function; (e) a burst of seeded requests and a
     seeded completion through ``cli.serve``'s compiled core: JSON equal to
     an eager server's; (f) ``save_compiled``, then ``load_compiled`` in a
     fresh process with an empty kernel build directory and no nvcc:
     output bit-equal, load seconds against the cold build; (g) a denoiser
     that reads a value on the host, compiled in a fresh process: the
     capture raises; (h) a reading: VG batch 64, 1000 Heun steps,
     compiled, decoded, wall seconds and graphs/s; (i) a reading:
     ``serving.generate`` (a new core and its captures at every call) against
     the eager core and a held compiled core, and bit-equal to eager.
  13. the compiled training step (``train/compiled.py``: the training and
     test steps as replays of captured CUDA graphs, one per
     self-conditioning coin, the draws made outside; ``go_training``'s
     default on the card, so phases 4, 6, 8 and 10 ran it too): (a) the
     full-width VG and COCO models (bf16, kernels on), 8 steps at batch 64
     from one seeded state on the same draws, compiled and eager, coins
     taking both values, an epoch boundary after step 4 (the learning rate
     halves) and the EMA warm-up: every metric, the parameters, gradients,
     Adam's moments and steps and all 5 EMAs bit-equal, the launch counts
     equal, and for each graph the port's kernel nodes of the graph
     (``debug_dump``, as in phase 12) equal to the kernels one eager run of
     its body launches, whose wrapper counts equal its launch record;
     readings: ms per step compiled and eager in turns, with
     and without the conditioning pass, the card's busy ms and kernel count
     of a step, the graph's replay alone, host CUDA calls a step
     (torch.profiler), each graph's seconds of first use and capture, the
     pool's bytes, peak memory, training graphs/s; (b) the compiled test-pass
     step on the smallest-beta EMA bit-equal to eager; (c) ``go_training``
     compiled against ``compiled=False`` (full VG, 2 epochs of 2 steps, a
     test pass, an asynchronous checkpoint and in-training sampling each
     epoch): the final states bit-equal, the loss logs and the sampling
     rows' metrics equal, the compiled run's checkpoint restored bit-equal
     in an eager trainer on the card and on the CPU's plain Adam; (d) the
     ``shard_map`` step at world 1 through NCCL (two graphs per coin around
     the all-reduce, one update graph) bit-equal to the eager ``shard_map``
     step and to the compiled single-device step, the launches equal.
Launch counts are set to 0 before each of phases 3-13 and read after it
(phase 12: around its compiled VG batch-16 sampling; phase 13: its
compiled VG and COCO steps of (a)).
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
# the denoiser's entry replaces no TPU kernel: XLA composes it there
PE = "none (diffusesg_tpu/models/layers.py::PatchEmbed, XLA's composition)"
VG = dict(tag="VG", path="vg", config="configs/edm_diffuse_sg_regular_visual_genome.yaml",
          params=35_808_848, node_types=150, edge_types=51, requests=[64, 40, 12, 5],
          small=(64, 23), blocks=12, resamples=3)
COCO = dict(tag="COCO", path="coco", config="configs/edm_diffuse_sg_regular_coco.yaml",
            params=30_690_020, node_types=171, edge_types=7, requests=[40, 33, 12, 5],
            small=(40, 17), blocks=18, resamples=2)
# the resampling layers' backwards: each runs once per merge (breakup) of a
# backward, ``resamples`` of each a model
RESAMPLE_BWD = ("patch_merge_bwd", "patch_breakup_bwd")


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


WGMMA_KERNELS = ("hgemm_kernel", "readout_kernel", "mlp_bwd_kernel", "token_mlp_kernel_wg",
                 "patch_embed_kernel", "window_attn_kernel_fused", "window_attn_bwd_kernel_fused")
MM_KERNEL = "mm_accumulate_wgmma"  # K12: an instantiation per type, tile and K tail
# the warpgroup MMA of each K12 instantiation: HGMMA for bf16 operands,
# IGMMA for int8 ones; WMMA-era mma.sync (HMMA, IMMA) in none
MM_SASS = {"bf16": "HGMMA", "int8": "IGMMA"}


def check_sass(lib_path) -> None:
    """The wgmma kernels of the built library issue wgmma: count the HGMMA
    instructions of every hgemm_kernel instantiation (the forward and
    backward GEMM sites), of readout_kernel, of the fused MLP backward
    mlp_bwd_kernel, of the fused MLP token_mlp_kernel_wg (every C) and of the
    attention half window_attn_kernel_fused (every C and L) and of its fused
    backward window_attn_bwd_kernel_fused (cuobjdump -sass); and the port has one GEMM: no other
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
    from diffusesg_torch.ops import patch_embed as pe
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

    def resample_vjp(plain_fn):
        """The resampling backwards' reference: the plain version
        differentiated on the card (``plain_vjp``, fp32 products)."""
        from diffusesg_torch.ops import cuda_build
        return lambda *a: cuda_build.plain_vjp(plain_fn, a[:-1], a[-1])

    def attn_bwd_launches(m, c):
        return (("fused window kernel", "window_attn_bwd_kernel_fused", None),
                ("qkv recompute", "SwinBwdQkv", ln_linear(m, c, 3 * c)),
                ("dattn = dy Wproj", "SwinBwdDattn", mm_nn(m, c, c)),
                ("window core", "window_attn_bwd_kernel<", None),
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

    def ln_mlp(m, c):
        """The MLP half in PyTorch, bf16 (cuBLAS products): LayerNorm, fc1,
        GELU, fc2 and the residual, the yardstick of token_mlp."""
        a, g, bt = rnd(m, c), rnd(c, offset=1.0, scale=0.1), rnd(c, scale=0.1)
        w1, b1, w2, b2 = lin(4 * c, c), rnd(4 * c, scale=0.1), lin(c, 4 * c), rnd(c, scale=0.1)
        return lambda: a + F.linear(F.gelu(F.linear(F.layer_norm(a, (c,), g, bt, 1e-6), w1, b1)),
                                    w2, b2)

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
                              gemms=(("one kernel", "window_attn_kernel_fused", None),
                                     ("closing pass", "window_attn_kernel_close", None))))
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
                              2 * m * c * 2 + 8 * c * c * 2 + 6 * c * 4, fwd_tol, path,
                              library=ln_mlp(m, c)))
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
            # its backward: dout in, four gradients out (plain_vjp the reference)
            bargs = args + (rnd(b, hw // 2, hw // 2, 2 * c),)
            cases.append(Case("patch_merge_bwd", "patch_resample.cu", K2, pr.patch_merge_bwd,
                              resample_vjp(pr.patch_merge_plain), bargs, 4 * mo * 4 * c * 2 * c,
                              2 * b * hw * hw * c * 2 + mo * 2 * c * 2 + 2 * 8 * c * c * 2
                              + 4 * 4 * c * 4, bwd_tol, path, graph_plain=False,
                              gemms=(("dhn = dy W", "MergeProjBwdDhn", None),
                                     ("row pass", "merge_rows_bwd_kernel", None),
                                     ("dW", "MergeProjBwdDw, dsg::hg", None),
                                     ("reductions", "resample_reduce_kernel", None))))
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
            # its backward: dout in, eight gradients out (plain_vjp the reference)
            bargs = args + (rnd(b, 2 * hw, 2 * hw, cout),)
            cases.append(Case("patch_breakup_bwd", "patch_resample.cu", K3, pr.patch_breakup_bwd,
                              resample_vjp(pr.patch_breakup_plain), bargs,
                              4 * mi * cin * dim + 4 * mo * cout * cout,
                              2 * mi * cin * 2 + mo * cout * 2 + 2 * (cin * dim + cout * cout) * 2
                              + 2 * (2 * dim + 2 * cout) * 4, bwd_tol, path, graph_plain=False,
                              gemms=(("y recompute", "BreakupInBwdY", None),
                                     ("dh2 = dout W_out", "BreakupOutBwdDh", None),
                                     ("row pass", "breakup_rows_kernel_bwd", None),
                                     ("dW_out", "BreakupOutBwdDw, dsg::hg", None),
                                     ("[dx | dskip] = dy W_in", "BreakupInBwdDx", None),
                                     ("dW_in", "BreakupInBwdDw, dsg::hg", None),
                                     ("reductions", "resample_reduce_kernel", None))))
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
        # the full-resolution ends over B*N*N rows, self-conditioning on (22
        # input channels), the batch's node counts 2..N: patch_embed writes
        # 192 bytes a row from the inputs (products K = 32, padded), the head
        # reads 192 and writes 4 bytes a row and the pooling's partials
        m = b * n * n
        counts = torch.randint(2, n + 1, (b,), generator=gen, device=dev)
        flags = torch.arange(n, device=dev)[None, :] < counts[:, None]
        adj, node = rnd(b, n, n, 1, dtype=f32), rnd(b, n, 5, dtype=f32)
        args = (adj, node, flags, adj * 0.5, node * 0.5, lin(96, 22), rnd(96, scale=0.1),
                rnd(96, dtype=f32, scale=0.1, offset=1.0), rnd(96, dtype=f32, scale=0.1),
                rnd(b, 192, scale=0.5), True)
        cases.append(Case("patch_embed", "patch_embed.cu", PE, pe.patch_embed,
                          pe.patch_embed_plain, args, 2 * m * 32 * 96,
                          m * (96 * 2 + 2 * 4) + b * n * 10 * 4 + 96 * 22 * 2 + b * 192 * 2,
                          fwd_tol, path,
                          gemms=(("patch_embed", "patch_embed_kernel", None),)))
        args = (rnd(b, n, n, 96, scale=2.0, offset=0.5),
                rnd(96, dtype=f32, scale=0.1, offset=1.0), rnd(96, dtype=f32, scale=0.1),
                lin(96, 96), rnd(96, scale=0.1), lin(96, 96), rnd(96, scale=0.1), lin(96, 96),
                rnd(96, scale=0.1), lin(96, 96), rnd(96, dtype=f32, scale=0.1), lin(1, 96),
                rnd(1, dtype=f32, scale=0.1), flags)
        cases.append(Case("readout", "readout.cu", K4, rk.output_head, rk.output_head_plain,
                          args, 2 * m * 96 * (4 * 96 + 1),
                          m * (96 * 2 + 4) + b * n * 2 * 96 * 4 + 4 * 96 * 96 * 2, fwd_tol, path,
                          gemms=(("output head", "readout_kernel_head", None),)))

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
    for name in ("swin_attn", "token_mlp", "patch_merge", "patch_breakup", "readout",
                 "patch_embed"):
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
# the batch sweep runs no step whose extrapolated peak passes this share of the card
SWEEP_SHARE = 0.9
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
    qkv, d(attn)) ``ops``.  The fused kernel keeps qkv and d(attn) on chip
    (None): its window core cannot be checked alone, so ``core_ok`` is False
    there (not checkable, never passed) and only hn is compared."""
    from diffusesg_torch.ops import swin_block_v3 as sw

    got, core_args = outs[8], args[8:]
    want = sw.swin_attn_bwd_plain(*args)[8]
    plain_ops = sw.swin_attn_bwd_operands_plain(*args[:8], *args[11:13])
    fused = ops[1] is None
    cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    ulps = [bf16_ulps(k, p) for k, p in zip(ops, plain_ops) if k is not None]
    moved = [int((u > 0).sum()) for u in ulps]
    op_err = [rel_max_err(k, p) for k, p in zip(ops, plain_ops) if k is not None]
    nudge = (float("nan") if fused else rel_max_err(sw.window_core_drel_plain(
        nudged(plain_ops[1], moved[1], gen), nudged(plain_ops[2], moved[2], gen), *core_args),
        want))
    coarse = sw.window_core_drel_plain(coarser(plain_ops[1]), coarser(plain_ops[2]), *core_args)
    core = None if fused else sw.window_core_drel_plain(ops[1], ops[2], *core_args)
    return dict(
        old=rel_max_err(got, want), old_ok=held(got, want, NOISY_LEAF_TOL),
        core=float("nan") if fused else rel_max_err(got, core),
        core_ok=not fused and held(got, core, BWD_TOL), fused=fused,
        witness=rel_max_err(sw.swin_attn_bwd_plain(*cpu_args)[8], want),
        nudge=nudge, coarse=rel_max_err(coarse, want),
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
                + ("not checkable: the fused kernel keeps qkv and d(attn) on chip; "
                   if r["fused"] else
                   f"{r['core']:.3e} {'ok' if r['core_ok'] else 'MISMATCH'} (tol {BWD_TOL}); ")
                + "recomputed hn / qkv / d(attn) vs the plain version's: "
                + " / ".join(f"{f:.3%} of elements apart, at most {u} ulp, max_err/max|ref|="
                             f"{e:.3e}" for f, u, e in zip(r["moved"], r["max_ulps"], r["op_err"]))
                + f" {'ok' if r['ops_ok'] else 'MISMATCH'} (at most {OPERANDS_APART:.0%} apart, "
                f"{OPERANDS_MAX_ERR:.3e} of max); without the kernel: plain on the CPU vs on "
                f"the card {r['witness']:.3e}, that many elements moved 1 ulp {r['nudge']:.3e}, "
                f"qkv and d(attn) one mantissa bit coarser {r['coarse']:.3e} "
                f"{'refused' if r['coarse_refused'] else 'PASSED THE GATE'}")
            if not (r["old_ok"] and r["core_ok"] and r["ops_ok"] and r["coarse_refused"]):
                failed.append(f"{name} batch {seed}"
                              + (" (its window core cannot be checked)" if r["fused"] else ""))
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
                                       make_optimizer, make_train_step, train_step_config_from)
    from diffusesg_torch.train import trainer
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

    def watched_step(step, st, noise, *batch):
        before = cuda_build.launches_by_kernel()
        done = st.step
        st, metrics = step(st, noise, *batch)
        after = cuda_build.launches_by_kernel()
        record["losses"].append(metrics["loss"])
        record["bwd"].append(tuple(after.get(k, 0) - before.get(k, 0)
                                   for k in ("swin_attn_bwd", "token_mlp_bwd") + RESAMPLE_BWD))
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

    real_steps = trainer._steps

    def watched_steps(*args, **kw):  # go_training's steps, its compiled step watched
        st, train_step, eval_step, noise = real_steps(*args, **kw)
        record["step"] = train_step
        return (st, lambda *a: watched_step(train_step, *a), eval_step, noise)

    cuda_build.reset_launches()
    t0 = time.perf_counter()
    trainer._steps = watched_steps
    try:
        state = go_training(model, state, step_cfg, cfg, bundle, mc_sampler=None,
                            noise=TorchNoise(0, dev))
    finally:
        trainer._steps = real_steps
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_build.LAUNCHES)
    losses = [float(x) for x in record["losses"]]
    graphs = [g for p in record["step"].stats() for g in p["variants"]]
    log(f"train {tag}: {state.step} steps at batch {TRAIN_BATCH} through go_training in {wall:.2f} s "
        f"(first step and the epoch-0 test pass included; compiled: graphs {graphs}); losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}; backward launches per step "
        f"(swin_attn_bwd, token_mlp_bwd, patch_merge_bwd, patch_breakup_bwd) "
        f"{sorted(set(record['bwd']))}")
    if state.step != 2 * steps_per_epoch or len(losses) != state.step:
        fail(f"expected {2 * steps_per_epoch} steps, ran {state.step}")
    if not graphs:
        fail("go_training's training step captured no graph")
    if not all(x == x and abs(x) != float("inf") for x in losses):
        fail("a training loss is not finite")
    n_res = spec["resamples"]
    if set(record["bwd"]) != {(n_blocks, n_blocks, n_res, n_res)}:
        fail(f"each backward must launch each block's backward kernel {n_blocks} times and "
             f"each resampling backward {n_res} times, saw {record['bwd']}")
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
    # the largest power-of-two batch whose step fits the card's memory; a
    # batch whose peak, extrapolated from the last two, would pass
    # SWEEP_SHARE of the card is not run: the sweep never grows until it fails
    total = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    fits, b, peaks, skipped = TRAIN_BATCH, 2 * TRAIN_BATCH, {TRAIN_BATCH: peak}, ""
    while b <= 4096:
        half, quarter = peaks.get(b // 2), peaks.get(b // 4)
        need = None if quarter is None else 2 * half - quarter
        if need is not None and need > SWEEP_SHARE * total:
            log(f"train {tag}: batch {b} not run: its peak would be about {need:.1f} GiB "
                f"(the last two, extrapolated), over {SWEEP_SHARE:.0%} of {total:.0f} GiB")
            skipped = f" (batch {b} skipped on its extrapolated peak, not measured)"
            break
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
            del big
        fits, peaks[b] = b, torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"train {tag}: batch {b} fits, peak {peaks[b]:.2f} GiB")
        b *= 2
    torch.cuda.empty_cache()
    log(f"train {tag}: largest power-of-two batch of a training step in {total:.0f} GiB: "
        f"{fits}{skipped}")
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
FORWARD_KERNELS = ("swin_attn", "token_mlp", "patch_merge", "patch_breakup", "readout",
                   "patch_embed")
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
    from diffusesg_torch.train import (create_train_state, go_training, make_optimizer,
                                       train_step_config_from)
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
        go_training(model, state, step_cfg, cfg, bundle, mc_sampler=get_mc_sampler(cfg),
                    noise=noise)
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
    fn, complete_fn, batch, n, scfg, bounds, (model, sampler, *_) = serve_cli._load_from_checkpoint(
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
    log(f"serve: readings (the compiled sampler, {SERVE_STEPS} Heun steps, {evals} denoiser "
        f"evals a graph, "
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


# ----------------------------------------------------------------- phase 10

DP_STEPS = 2
# the gspmd step's steps compiled and eager against the single-device step
# (the coins of phase 13, CTRAIN_COINS), and their stream's seed
DP_COMPILED_STEPS, DP_SEED = 8, 4
BACKWARD_KERNELS = ("swin_attn_bwd", "token_mlp_bwd")
_UNSTABLE_FRAC = 4e-3  # tests/test_torch_train_step.py: Adam's update sign may flip below it


def _dp_config(exp_dir):
    """The full-width VG config (kernels on, bf16) at batch 64 on synthetic
    graphs: two epochs of two steps, a checkpoint at epoch 0, a test set of
    64 graphs."""
    from diffusesg_torch.config import load_config
    cfg = load_config(VG["config"])
    with cfg.unlocked():
        cfg.seed = 0
        cfg.exp_dir = exp_dir
        cfg.mcmc.num_steps = EVAL_STEPS
        cfg.train.batch_size = TRAIN_BATCH
        cfg.test.batch_size = TRAIN_BATCH
        cfg.test.eval_size = TRAIN_BATCH
        cfg.train.max_epoch = 2
        cfg.dataset.synthetic_num_train = 2 * TRAIN_BATCH
        cfg.dataset.synthetic_num_test = TRAIN_BATCH
    return cfg


def _train_states(cfg, dev, n):
    """``n`` training states of the seeded model, each on its own copy."""
    from diffusesg_torch.models import build_model
    from diffusesg_torch.train import create_train_state, make_optimizer
    opt = make_optimizer(cfg.train.lr_init, cfg.train.lr_dacey, 1, cfg.train.weight_decay)
    return [create_train_state(build_model(cfg, device=dev, seed=0), list(cfg.train.ema_coef), opt)
            for _ in range(n)]


def _state_diffs(a, b) -> dict:
    """Largest absolute differences of two training states: parameters, the
    EMAs and Adam's moments, each in the single-device form (a ZeRO-1
    state's gathered from its ranges, a collective there), and their step
    counts."""
    from diffusesg_torch.train.train_state import whole_emas_and_opt
    (ea, oa), (eb, ob) = whole_emas_and_opt(a), whole_emas_and_opt(b)

    @torch.no_grad()
    def worst(xs, ys):
        return max(float((x - y).abs().max()) for x, y in zip(xs, ys))
    moments = [worst([oa["state"][i][k] for i in sorted(oa["state"])],
                     [ob["state"][i][k] for i in sorted(ob["state"])])
               for k in ("exp_avg", "exp_avg_sq")]
    steps = {int(s["step"]) for o in (oa, ob) for s in o["state"].values()}
    return {"params": worst(a.params(), b.params()),
            "emas": max(worst(x, y) for x, y in zip(ea, eb)),
            "adam": max(moments), "adam_steps": sorted(steps), "step": (a.step, b.step)}


def check_data_parallel(dev, smi: str) -> tuple[dict, dict]:
    """Phase 10: the data-parallel path at world 1 through NCCL; returns the
    launch counts of its ``go_training`` run and of its compiled ``gspmd``
    steps."""
    import numpy as np
    import torch.distributed as dist

    from diffusesg_torch.data import load_data
    from diffusesg_torch.models import build_model
    from diffusesg_torch.ops import cuda_build
    from diffusesg_torch.parallel.distributed import (load_kernels, maybe_initialize_distributed,
                                                      shutdown)
    from diffusesg_torch.parallel.mesh import current_world
    from diffusesg_torch.parallel.shardmap_dp import make_shardmap_train_step
    from diffusesg_torch.parallel.sharded_step import (make_sharded_eval_step,
                                                       make_sharded_train_step, shard_train_state)
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.sampling.orchestrator import sg_go_sampling
    from diffusesg_torch.train import (create_train_state, ema_slice, go_training, make_eval_step,
                                       make_optimizer, make_train_step, train_step_config_from)
    from diffusesg_torch.train.train_state import whole_emas_and_opt
    from diffusesg_torch.utils import cuda_graphs
    from diffusesg_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
    from diffusesg_torch.utils.logging_utils import set_seed_and_logger

    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0")
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    exp_dir = os.path.join("build", "smoke_runs", "dp")
    shutil.rmtree(exp_dir, ignore_errors=True)
    cfg = _dp_config(exp_dir)
    try:
        t0 = time.perf_counter()
        if not maybe_initialize_distributed("cuda") or dist.get_backend() != "nccl":
            fail("maybe_initialize_distributed did not start an NCCL process group")
        world = current_world()
        load_kernels()
        log(f"dp: NCCL process group of {world.size} on {world.device} in "
            f"{time.perf_counter() - t0:.2f} s (rendezvous, barrier, kernels loaded)")
        set_seed_and_logger(cfg, mode="train", comment="smoke_dp", log_level="WARNING")
        bundle = load_data(cfg, data_root="/nonexistent")
        step_cfg = train_step_config_from(cfg)
        batch = tuple(torch.from_numpy(a[:TRAIN_BATCH]).to(dev) for a in
                      (bundle.train.adjs, bundle.train.nodes, bundle.train.node_flags))

        # the shard_map step (eager) and the gspmd + ZeRO-1 step eager and compiled
        # against the single-device step, from one start and the same draws
        one, sm, gs_e, gs_c = _train_states(cfg, dev, 4)
        single = make_train_step(one.model, step_cfg)
        shard_map = make_shardmap_train_step(sm.model, step_cfg, world, compiled=False)
        gs_e, gs_c = shard_train_state(gs_e, world), shard_train_state(gs_c, world)
        gspmd = {c: make_sharded_train_step(st.model, step_cfg, world, compiled=c)
                 for c, st in ((False, gs_e), (True, gs_c))}
        streams = {k: _scripted(DP_SEED, dev) for k in ("single", "shard_map", False, True)}
        cuda_graphs.KEEP_NODES = True  # for the replay check's debug_dump
        compiled_counts = collections.Counter()
        equal = {"shard_map": True, False: True, True: True}
        compiled_vs_eager = True  # compiled gspmd metrics against eager gspmd, each step
        bwd, losses, unstable = [], [], None
        for i in range(DP_COMPILED_STEPS):
            before = [p.detach().clone() for p in one.params()]
            one, m1 = single(one, streams["single"], *batch)
            counts0 = cuda_build.launches_by_kernel()
            sm, m2 = shard_map(sm, streams["shard_map"], *batch)
            counts1 = cuda_build.launches_by_kernel()
            gs_e, m3 = gspmd[False](gs_e, streams[False], *batch)
            c0 = dict(cuda_build.LAUNCHES)
            gs_c, m4 = gspmd[True](gs_c, streams[True], *batch)
            compiled_counts += _delta(c0, dict(cuda_build.LAUNCHES))
            bwd.append(tuple(counts1.get(k, 0) - counts0.get(k, 0) for k in BACKWARD_KERNELS))
            for k, m in (("shard_map", m2), (False, m3), (True, m4)):
                equal[k] &= m.keys() == m1.keys() and all(torch.equal(m1[n], m[n]) for n in m1)
            compiled_vs_eager &= m4.keys() == m3.keys() and all(torch.equal(m3[n], m4[n])
                                                                  for n in m3)
            losses.append((float(m1["loss"]), float(m4["loss"])))
            with torch.no_grad():  # the training step test's stable elements
                eff = [p.grad + cfg.train.weight_decay * w for p, w in zip(one.params(), before)]
                masks = [e.abs() <= _UNSTABLE_FRAC * e.abs().max() for e in eff]
            unstable = masks if unstable is None else [a | b for a, b in zip(unstable, masks)]
        # the test pass's step on the smallest-beta EMA: single-device, gspmd eager
        # and compiled, both coins
        tests = {"single": make_eval_step(one.model, step_cfg),
                 False: make_sharded_eval_step(gs_e.model, step_cfg, world, compiled=False),
                 True: make_sharded_eval_step(gs_c.model, step_cfg, world)}
        test_states = {"single": one, False: gs_e, True: gs_c}
        test_streams = {k: _scripted(DP_SEED + 1, dev) for k in tests}
        test_equal, test_vs_eager = True, True
        for i in (1, 2):  # coins True, False
            got = {k: tests[k](ema_slice(test_states[k], 0), test_streams[k], i, *batch)
                   for k in tests}
            test_equal &= all(torch.equal(got["single"][n], got[k][n])
                              for k in (False, True) for n in got["single"])
            test_vs_eager &= got[True].keys() == got[False].keys() and all(
                torch.equal(got[False][n], got[True][n]) for n in got[False])
        cuda_graphs.KEEP_NODES = False
        torch.cuda.synchronize()
        same = _state_diffs(one, sm)
        bit_equal = equal["shard_map"] and all(same[k] == 0.0 for k in ("params", "emas", "adam"))
        log(f"dp: shard_map step at world 1, {DP_COMPILED_STEPS} steps at batch {TRAIN_BATCH} "
            f"(full VG, bf16, kernels on; self-conditioning coins {list(CTRAIN_COINS)}) against "
            f"the single-device step on the same draws: bit-equal {bit_equal} ({same}; metrics "
            f"equal {equal['shard_map']}); backward launches per step (swin_attn_bwd, "
            f"token_mlp_bwd) {sorted(set(bwd))}")
        if not bit_equal:
            fail("the shard_map step at world 1 differs from the single-device step")
        if set(bwd) != {(VG["blocks"], VG["blocks"])}:
            fail(f"each data-parallel step must launch each backward kernel {VG['blocks']} times")

        vs_eager, d_eager = _equal_states(gs_c, gs_e)
        vs_single, d_single = _equal_states(gs_c, one)
        (stats,) = gspmd[True].stats()
        comp_k = _by_kernel(compiled_counts)
        log(f"dp: gspmd + ZeRO-1 (flat buffers, {len(gs_c.zero.buckets)} dtype, padding "
            f"{gs_c.zero.padding()}) at world 1, {DP_COMPILED_STEPS} steps: compiled (graphs "
            f"{stats['variants']}; the valid-node count, the gradient all-reduce and the "
            f"all-gather on the caller's stream; seconds of first use / capture "
            f"{json.dumps({k: [round(x, 3) for x in v] for k, v in stats['seconds'].items()})}, "
            f"pool {stats['pool_bytes']} bytes) against the eager gspmd step: metrics "
            f"{compiled_vs_eager}, state bit-equal {vs_eager} ({d_eager}), the test-pass step "
            f"(both coins) {test_vs_eager}; against the single-device step: metrics "
            f"{equal[True]}, state bit-equal {vs_single} ({d_single}); the test-pass step "
            f"(single-device, gspmd eager, compiled; both coins) bit-equal {test_equal}; "
            f"compiled launches {json.dumps(comp_k, sort_keys=True)}")
        if not (vs_eager and compiled_vs_eager and test_vs_eager):
            fail("the compiled gspmd step differs from the eager gspmd step")
        if not test_equal:
            fail("the gspmd test-pass step differs from the single-device one")
        if set(stats["variants"]) != SHARD_MAP_GRAPHS:
            fail(f"the compiled gspmd step captured {stats['variants']}")
        if any(comp_k.get(k, 0) == 0 for k in FORWARD_KERNELS + BACKWARD_KERNELS):
            fail(f"the compiled gspmd steps launched {comp_k}")
        if not (vs_single and equal[True]):
            # not bit-equal: held to the training step's bars instead
            lr = cfg.train.lr_init
            gathered, _ = whole_emas_and_opt(gs_c)
            worst_stable, worst_unstable = 0.0, 0.0
            with torch.no_grad():
                for got, want in ([(gs_c.params(), one.params())]
                                  + list(zip(gathered, one.ema_params))):
                    for g, w, mask in zip(got, want, unstable):
                        diff = (g - w).abs()
                        room = 1e-4 * w.abs() + 0.05 * lr
                        worst_stable = max(worst_stable, float(((diff - room) * ~mask).max()))
                        worst_unstable = max(worst_unstable, float((diff * mask).max()))
            loss_ok = all(abs(a - b) <= 2e-4 * abs(a) for a, b in losses)
            within = (loss_ok and worst_stable <= 0.0
                      and worst_unstable <= 2.5 * lr * DP_COMPILED_STEPS)
            log(f"dp: the gspmd step is not bit-equal to the single-device step; within "
                f"tests/test_torch_train_step.py's bars {within} (losses {losses}; stable "
                f"elements' worst excess over 1e-4 |w| + 0.05 lr {worst_stable:.3e}, unstable "
                f"elements' worst {worst_unstable:.3e} against "
                f"{2.5 * lr * DP_COMPILED_STEPS:.3e})")
            if not within:
                fail("the gspmd + ZeRO-1 step is outside the training step's bars")

        # each compiled graph's kernel nodes against its launch record
        (program,) = gspmd[True]._programs.values()
        replayed = _replayed_kernels(dict(sorted(program.graphs.items())),
                                     lambda name: program.bodies[name](),
                                     os.path.join(GRAPH_DUMPS, "dp_gspmd"), quiet=("update",))
        log("dp: the port's kernel nodes of each gspmd graph (debug_dump) equal to those one "
            "eager run of its body launches (torch.profiler), its launch record to that run's "
            "wrapper counts: " + "; ".join(f"{g} {json.dumps(k, sort_keys=True)} {ok}"
                                           for g, (k, ok) in replayed.items()))
        if not all(ok for _, ok in replayed.values()):
            fail("a gspmd graph launches other kernels than its launch record says")

        # the gathered checkpoint (the replay check ran the update body once more:
        # the compiled state is one update ahead, so the eager one is saved)
        path = save_checkpoint(os.path.join(cfg.model_ckpt_dir, "zero"), gs_e, {"epoch": 0})
        other = create_train_state(
            build_model(cfg, device=dev, seed=1), list(cfg.train.ema_coef),
            make_optimizer(cfg.train.lr_init, cfg.train.lr_dacey, 1, cfg.train.weight_decay))
        restore_checkpoint(path, other)
        back = _state_diffs(other, gs_e)
        restored = (back["params"] == back["emas"] == back["adam"] == 0.0
                    and back["step"] == (DP_COMPILED_STEPS, DP_COMPILED_STEPS)
                    and back["adam_steps"] == [DP_COMPILED_STEPS])
        log(f"dp: the gspmd + ZeRO-1 state's checkpoint (gathered from the ranges through "
            f"NCCL) restored in a single-device state bit-equal: {restored} ({back})")
        if not restored:
            fail("the ZeRO-1 checkpoint does not restore bit-equal on one device")
        del other

        # readings: ms per step with and without the conditioning pass, in turns
        # there and back (the host moves eager times); the host CUDA calls of a
        # gspmd step; ZeRO's collectives alone; the all-reduce of a flat
        # gradient; peak memory
        step_ms = collections.defaultdict(list)
        for sc in (False, True):
            n = {k: _forced(TorchNoise, sc)(1, dev) for k in ("single", "shard_map", False, True)}
            runs = {"single": lambda: single(one, n["single"], *batch),
                    "shard_map": lambda: shard_map(sm, n["shard_map"], *batch),
                    "gspmd eager": lambda: gspmd[False](gs_e, n[False], *batch),
                    "gspmd compiled": lambda: gspmd[True](gs_c, n[True], *batch)}
            for name in list(runs) + list(runs)[::-1]:
                step_ms[(name, sc)].append(time_ms(runs[name], 3, warmup=1))
            if sc:
                prof = {k: _step_profile(runs[f"gspmd {k}"]) for k in ("eager", "compiled")}
        zero_ms = {"gradient all-reduce": time_ms(gs_c.zero.all_reduce_grads, 5),
                   "all-gather": time_ms(gs_c.zero.gather_params, 5)}
        flat = torch.zeros(sum(p.numel() for p in one.params()), dtype=torch.float32, device=dev)
        ms_ar = time_ms(lambda: dist.all_reduce(flat), 20)
        grad_mb = flat.numel() * flat.element_size() / 1e6
        log(f"dp: ms per training step at batch {TRAIN_BATCH} (world 1, in turns there and "
            f"back), without / with the self-conditioning pass: " + ", ".join(
                f"{k} {' / '.join(f'{t:.3f}' for t in step_ms[(k, False)])}; "
                f"{' / '.join(f'{t:.3f}' for t in step_ms[(k, True)])}" for k in runs)
            + f"; with the pass the card busy {prof['eager'][0]:.3f} ms of an eager gspmd step "
              f"({prof['eager'][1]} kernels, copies and sets), {prof['compiled'][0]:.3f} of a "
              f"compiled one ({prof['compiled'][1]}), host CUDA calls a step eager "
              f"{prof['eager'][2]} {prof['eager'][3]}, compiled {prof['compiled'][2]} "
              f"{prof['compiled'][3]}; ZeRO's collectives alone (ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in zero_ms.items())
            + f"; one NCCL all-reduce of the flat fp32 gradient ({grad_mb:.1f} MB) {ms_ar:.3f} "
              f"ms; on {smi}")
        # the other steps hold their models: free them before the peak reading
        del one, sm, gs_e, single, shard_map, runs, flat, unstable, before, eff, masks, tests
        del test_states, gspmd[False]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gspmd[True](gs_c, streams[True], *batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"dp: peak {peak:.2f} GiB of a compiled gspmd + ZeRO-1 step alone (the other "
            f"states freed); on {smi}")
        del gs_c, gspmd
        torch.cuda.empty_cache()

        # go_training with the process group up: the data-parallel loop, and at
        # world 1 the single-device steps (a mean over one rank is the
        # identity, ZeRO-1 over one rank shards nothing)
        (state,) = _train_states(cfg, dev, 1)
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        state = go_training(state.model, state, step_cfg, cfg, bundle, noise=TorchNoise(0, dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
        path = save_checkpoint(os.path.join(cfg.model_ckpt_dir, "dp_final"), state, {"epoch": 1})
        other = create_train_state(
            build_model(cfg, device=dev, seed=1), list(cfg.train.ema_coef),
            make_optimizer(cfg.train.lr_init, cfg.train.lr_dacey, 1, cfg.train.weight_decay))
        restore_checkpoint(path, other)
        back = _state_diffs(other, state)
        ckpts = sorted(os.listdir(cfg.model_ckpt_dir))
        restored = (back["params"] == back["emas"] == back["adam"] == 0.0
                    and back["step"] == (2 * DP_STEPS, 2 * DP_STEPS))
        by_kernel = cuda_build.launches_by_kernel()
        log(f"dp: go_training, 2 epochs of {DP_STEPS} steps at batch {TRAIN_BATCH} with the NCCL "
            f"group up (the data-parallel loop; at world 1 the single-device steps) in "
            f"{wall:.2f} s; "
            f"checkpoints {ckpts}; the rank-0 checkpoint restored in a single-device trainer "
            f"bit-equal: {restored} ({back}); launches {json.dumps(by_kernel, sort_keys=True)}")
        if not restored:
            fail("the data-parallel checkpoint does not restore bit-equal on one device")
        if "00000.pt" not in ckpts:
            fail(f"go_training wrote checkpoints {ckpts}")
        missing = [k for k in FORWARD_KERNELS + BACKWARD_KERNELS if not by_kernel.get(k)]
        if missing:
            fail(f"the data-parallel training run launched no {missing}")
        del other, state
        torch.cuda.empty_cache()

        # sg_go_sampling with the sanity check, with the process group up
        model = build_model(cfg, device=dev, seed=1)
        with_group = sg_go_sampling(model, None, get_mc_sampler(cfg), cfg, bundle, eval_mode=True,
                                    sanity_check=True)
        rows_dp = _latest_samples(cfg.logdir)
    finally:
        shutdown()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    without = sg_go_sampling(model, None, get_mc_sampler(cfg), cfg, bundle, eval_mode=True,
                             sanity_check=True)
    rows_one = _latest_samples(cfg.logdir)
    same_rows = (sorted(rows_dp) == sorted(rows_one)
                 and all(np.array_equal(rows_dp[k], rows_one[k]) for k in rows_one))
    same_metrics = ({k: v for k, v in with_group.items() if not k.startswith("_")}
                    == {k: v for k, v in without.items() if not k.startswith("_")})
    log(f"dp: sg_go_sampling with the sanity check on {TRAIN_BATCH} graphs with the NCCL group "
        f"up and after it is destroyed: the same rows {same_rows}, the same metrics "
        f"{same_metrics}; the process group destroyed: {not dist.is_initialized()}")
    if not (same_rows and same_metrics):
        fail("sg_go_sampling under the process group differs from the run without one")
    return launches, dict(compiled_counts)


# ----------------------------------------------------------------- phase 11

MULTI_STEPS = 16
MULTI_BATCH = 16
MULTI_SEED = 21
MULTI_TRAIN_BATCH = 16
SHARD_KERNELS = ("swin_attn", "token_mlp", "patch_merge", "patch_breakup", "readout",
                 "patch_embed")


def _sharded_serving(dev, smi: str) -> dict:
    """Phase 11 (a) and (b): the full VG model served across two shards of
    one card in both modes, and the refusals of more cards than the process
    has; returns the launches of one shard of the ``gspmd`` run."""
    import numpy as np

    from diffusesg_torch.cli import serve as serve_cli
    from diffusesg_torch.config import load_config, save_config
    from diffusesg_torch.models import build_model
    from diffusesg_torch.models.channels import resolve_sampling_channels
    from diffusesg_torch.ops import cuda_build
    from diffusesg_torch.parallel.mesh import World
    from diffusesg_torch.parallel.mesh import GlobalRows
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.serving.export import (export_sampler, fixed_batch, load_artifact,
                                                local_devices, make_denoiser,
                                                make_sharded_serving_fn, make_serving_fn,
                                                save_artifact)

    cfg = load_config(VG["config"])
    with cfg.unlocked():
        cfg.mcmc.num_steps = MULTI_STEPS
    model = build_model(cfg, device=dev, seed=0).eval()
    if not model.use_kernels or model.dtype != torch.bfloat16:
        fail("phase 11 serves the VG model with its kernels in bf16")
    sampler = get_mc_sampler(cfg)
    n = int(cfg.dataset.max_node_num)
    devices, per = [dev, dev], MULTI_BATCH // 2
    rng = np.random.default_rng(3)
    counts = [n] * 4 + [int(c) for c in rng.integers(5, n + 1, MULTI_BATCH - 4)]
    flags = np.zeros((MULTI_BATCH, n), bool)
    for i, c in enumerate(counts):
        flags[i, :c] = True
    core = fixed_batch(make_serving_fn(model, sampler, cfg), per, n, dev)
    whole = fixed_batch(make_serving_fn(model, sampler, cfg), MULTI_BATCH, n, dev)
    per_shard = {}
    fns = {}
    for mode in ("gspmd", "shard_map"):
        fn = fns[mode] = make_sharded_serving_fn(model, sampler, cfg, devices, mode)
        fn(MULTI_SEED, flags)  # the first call builds nothing new; warm the allocator
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        out = fn(MULTI_SEED, flags)
        torch.cuda.synchronize()
        launched = cuda_build.launches_by_kernel()
        if (any(launched.get(k, 0) == 0 for k in SHARD_KERNELS)
                or any(v % 2 for v in cuda_build.LAUNCHES.values())):
            fail(f"{mode}: the shards launched {launched}; each forward kernel must launch "
                 "as often on each shard")
        shard = {k: launched[k] // 2 for k in SHARD_KERNELS}
        if mode == "gspmd":
            per_shard = {k: v // 2 for k, v in cuda_build.LAUNCHES.items()}
        cuda_build.reset_launches()
        single = core(MULTI_SEED, flags[:per], noise=GlobalRows(TorchNoise(MULTI_SEED, dev),
                                                                 World(0, 2, dev)))
        if cuda_build.launches_by_kernel() != {k: shard[k] for k in SHARD_KERNELS}:
            fail(f"{mode}: one shard's launches {shard} are not the single-device core's on "
                 f"its rows {cuda_build.launches_by_kernel()}")
        same = []
        for i in range(2):
            draws = (GlobalRows(TorchNoise(MULTI_SEED, dev), World(i, 2, dev))
                     if mode == "gspmd" else TorchNoise(MULTI_SEED, dev).fold_in(i))
            want = single if (i == 0 and mode == "gspmd") else core(
                MULTI_SEED, flags[i * per:(i + 1) * per], noise=draws)
            same.append(all(np.array_equal(g[i * per:(i + 1) * per], w)
                            for g, w in zip(out, want)))
        log(f"multi: {mode} over 2 shards of {dev} (VG, bf16, kernels on, {MULTI_STEPS} Heun "
            f"steps, batch {MULTI_BATCH}): each shard's decoded graphs bit-equal to the "
            f"single-device core on its rows with its draws {same}; launches per shard "
            f"{json.dumps(shard, sort_keys=True)}")
        if not all(same):
            fail(f"a {mode} shard differs from the single-device core on its rows")

    # gspmd against the whole batch on one card, at phase 3's bar: the raw
    # samples (token_mlp splits its hidden by row count, so not bit-equal)
    info = resolve_sampling_channels(cfg)
    flags_t = torch.from_numpy(flags).to(dev)
    with torch.inference_mode():
        full = sampler.sample(make_denoiser(model, cfg, flags_t), flags_t, info["num_node_chan"],
                              info["num_adj_chan"], noise=TorchNoise(MULTI_SEED, dev))
        parts = [sampler.sample(make_denoiser(model, cfg, flags_t[i * per:(i + 1) * per]),
                                flags_t[i * per:(i + 1) * per], info["num_node_chan"],
                                info["num_adj_chan"],
                                noise=GlobalRows(TorchNoise(MULTI_SEED, dev), World(i, 2, dev)))
                 for i in range(2)]
    rels = [float((torch.cat([p[k] for p in parts]) - full[k]).norm() / full[k].norm())
            for k in range(2)]
    dec_whole = whole(MULTI_SEED, flags)
    dec_sharded = fns["gspmd"](MULTI_SEED, flags)
    agree = [float(np.mean(a == b)) for a, b in zip(dec_whole[:2], dec_sharded[:2])]
    log(f"multi: gspmd's samples against the whole batch of {MULTI_BATCH} on one card, relative "
        f"L2 adj {rels[0]:.3e} node {rels[1]:.3e} (limit 5e-2); decoded edge and node types "
        f"equal in {agree[0]:.2%} and {agree[1]:.2%} of entries (a reading)")
    if not max(rels) < 5e-2:
        fail("gspmd serving disagrees with the single-device sampler on the whole batch")

    # readings: graphs/s, two shards on one card against one batch, in turns
    runs = dict(one_batch=lambda: whole(MULTI_SEED, flags),
                gspmd=lambda: fns["gspmd"](MULTI_SEED, flags),
                shard_map=lambda: fns["shard_map"](MULTI_SEED, flags))
    secs = collections.defaultdict(list)
    for name in list(runs) + list(runs)[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize()
        secs[name].append(time.perf_counter() - t0)
    log(f"multi: graphs/s at batch {MULTI_BATCH}, {MULTI_STEPS} Heun steps, decoded, host to "
        f"host (in turns there and back): " + ", ".join(
            f"{k} {' / '.join(f'{MULTI_BATCH / s:.2f}' for s in v)}" for k, v in secs.items())
        + f" on {smi}")

    # (b) the refusals: an artifact over two cards, and cli.serve --devices 2
    # on a run dir of the seeded weights (config.yaml and one checkpoint)
    root = os.path.join("build", "smoke_runs", "multi")
    shutil.rmtree(root, ignore_errors=True)
    run = os.path.join(root, "run")
    os.makedirs(os.path.join(run, "models_ckpt"))
    save_config(cfg, os.path.join(run, "config.yaml"))
    torch.save({"step": 0, "params": {k: v.cpu() for k, v in model.state_dict().items()},
                "ema_params": [], "ema_betas": [], "extra": {}},
               os.path.join(run, "models_ckpt", "00000.pt"))
    art = os.path.join(root, "art2")
    save_artifact(art, export_sampler(model, sampler, cfg, MULTI_BATCH, num_devices=2), cfg,
                  MULTI_BATCH)
    local = len(local_devices("cuda"))
    try:
        load_artifact(art, device="cuda")
        refused = None
    except RuntimeError as e:
        refused = str(e)
    served, _ = load_artifact(art, device="cuda", devices=devices)
    same_art = all(np.array_equal(a, b) for a, b in zip(served(MULTI_SEED, flags), dec_sharded))
    try:
        serve_cli.main(["-p", run, "--devices", "2", "--batch_size", str(MULTI_BATCH),
                        "--num_steps", str(MULTI_STEPS)])
        cli_exit = None
    except SystemExit as e:
        cli_exit = str(e)
    log(f"multi: an artifact over 2 devices on this process of {local} card(s): refused with "
        f"{refused!r}; served over [{dev}, {dev}] equal to the gspmd function {same_art}; "
        f"cli.serve --devices 2 exits with {cli_exit!r}")
    want_exit = f"--devices 2 but only {local} local devices"
    if local < 2 and (refused is None or "spans 2 devices" not in refused
                      or cli_exit != want_exit):
        fail("a process with one card must refuse an artifact over two and --devices 2")
    if not same_art:
        fail("the artifact over two devices serves otherwise than the gspmd function")
    del model, fns, runs
    torch.cuda.empty_cache()
    return per_shard


class _CountingDist:
    """``torch.distributed`` with its collectives counted, for the tensor
    parallel module to call while phase 11 (c) reads which ones launched."""

    def __init__(self, dist, counts):
        self._dist, self._counts = dist, counts

    def __getattr__(self, name):
        attr = getattr(self._dist, name)
        if name in ("all_reduce", "all_gather"):
            def counted(*args, **kw):
                self._counts[name] += 1
                return attr(*args, **kw)
            return counted
        return attr


# phase 11 (c): the tensor-parallel steps (coins CTRAIN_COINS[:TP_STEPS]: both
# variants, one replayed)
TP_STEPS = 3


def _graph_nccl_nodes(graph, path: str) -> int:
    """The NCCL kernel nodes of a captured graph (kept with
    ``cuda_graphs.KEEP_NODES``), read from its ``debug_dump``."""
    import re
    os.makedirs(os.path.dirname(path), exist_ok=True)
    graph.debug_dump(path)
    with open(path) as f:
        labels = re.findall(r'label="((?:[^"\\]|\\.)*)"', f.read())
    return sum("KERNEL" in label.split("|")[0] and "nccl" in label.lower() for label in labels)


def _profiled_nccl_kernels(fn) -> int:
    """The NCCL kernels one eager call of ``fn`` launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower())


def _tensor_parallel_and_checkpoints(dev, smi: str) -> None:
    """Phase 11 (c) and (d): tensor-parallel steps at grid (1, 1) through
    NCCL, compiled (one graph per coin, the model group's collectives
    captured) against eager against the single-device plain step, and an
    asynchronous checkpoint drained and restored."""
    import torch.distributed as dist

    from diffusesg_torch.data import load_data
    from diffusesg_torch.models import build_model
    from diffusesg_torch.ops import cuda_build
    from diffusesg_torch.parallel import tp as tp_mod
    from diffusesg_torch.parallel.distributed import maybe_initialize_distributed, shutdown
    from diffusesg_torch.parallel.mesh import make_grid
    from diffusesg_torch.parallel.sharded_step import make_sharded_train_step
    from diffusesg_torch.parallel.tp import shard_tp_state
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train import (create_train_state, make_optimizer, make_train_step,
                                       train_step_config_from)
    from diffusesg_torch.train.compiled import VARIANT
    from diffusesg_torch.utils import cuda_graphs
    from diffusesg_torch.utils.checkpoint import (restore_checkpoint, save_checkpoint,
                                                  wait_for_async_saves)

    exp_dir = os.path.join("build", "smoke_runs", "multi")
    ckpt_dir = os.path.join(exp_dir, "models_ckpt")
    cfg = _dp_config(exp_dir)
    with cfg.unlocked():
        cfg.tpu.use_pallas_attention = False  # tensor parallelism runs the plain composition
    bundle = load_data(cfg, data_root="/nonexistent")
    batch = tuple(torch.from_numpy(a[:MULTI_TRAIN_BATCH]).to(dev) for a in
                  (bundle.train.adjs, bundle.train.nodes, bundle.train.node_flags))
    step_cfg = train_step_config_from(cfg)
    opt = make_optimizer(cfg.train.lr_init, cfg.train.lr_dacey, 1, cfg.train.weight_decay)

    def fresh(seed=0):
        return create_train_state(build_model(cfg, device=dev, seed=seed),
                                  list(cfg.train.ema_coef), opt)

    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0")
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    counts = collections.Counter()
    try:
        if not maybe_initialize_distributed("cuda") or dist.get_backend() != "nccl":
            fail("phase 11 did not start an NCCL process group")
        grid = make_grid(1, 1)
        one, tp_e, tp_c = fresh(), fresh(), fresh()
        if one.model.use_kernels or one.model.dtype != torch.bfloat16:
            fail("phase 11 (c) runs the VG model's plain composition in bf16")
        single = make_train_step(one.model, step_cfg)
        tp_e, tp_c = shard_tp_state(tp_e, grid), shard_tp_state(tp_c, grid)
        steps = {"single": single,
                 "eager": make_sharded_train_step(tp_e.model, step_cfg, grid, tp=True,
                                                  compiled=False),
                 "compiled": make_sharded_train_step(tp_c.model, step_cfg, grid, tp=True)}
        states = {"single": one, "eager": tp_e, "compiled": tp_c}
        noises = {k: _scripted(6, dev) for k in steps}
        coins = list(CTRAIN_COINS[:TP_STEPS])
        cuda_build.reset_launches()
        cuda_graphs.KEEP_NODES = True  # for the graphs' NCCL nodes
        tp_mod.dist = _CountingDist(dist, counts)
        calls = collections.defaultdict(list)  # collectives a step issued, by step kind
        metrics_equal = True
        try:
            for _ in range(TP_STEPS):
                out = {}
                for k in steps:
                    n0 = sum(counts.values())
                    states[k], out[k] = steps[k](states[k], noises[k], *batch)
                    calls[k].append(sum(counts.values()) - n0)
                metrics_equal &= all(torch.equal(out["single"][m], out[k][m])
                                     for k in ("eager", "compiled") for m in out["single"])
        finally:
            tp_mod.dist = dist
            cuda_graphs.KEEP_NODES = False
        torch.cuda.synchronize()
        vs_eager, d_eager = _equal_states(states["compiled"], states["eager"])
        vs_single, d_single = _equal_states(states["eager"], states["single"])
        tp_state = states["compiled"]
        n_split = sum(k in ("qkv", "rows", "cols") for k in tp_state.tp.kinds)
        path = save_checkpoint(os.path.join(ckpt_dir, "tp"), tp_state, {"epoch": 0})
        other = fresh(1)
        restore_checkpoint(path, other)
        back = _state_diffs(other, states["single"])
        restored = back["params"] == back["emas"] == back["adam"] == 0.0
        log(f"multi: the compiled tensor-parallel state's checkpoint (gathered over the model "
            f"group) restored in a single-device state bit-equal to the single-device run: "
            f"{restored} ({back})")
        if not restored:
            fail("the tensor-parallel checkpoint does not restore bit-equal on one device")
        del tp_state, other
        (program,) = steps["compiled"]._programs.values()
        # a coin's first use runs its step eagerly and then captures it: twice the
        # eager step's collectives, of which the capture's are the graph's; a replay
        # calls none from the host
        first = {c: coins.index(c) for c in set(coins)}
        captured = all(calls["compiled"][i] == (2 * calls["eager"][i] if first[c] == i else 0)
                       for i, c in enumerate(coins))
        nccl_graph = {name: _graph_nccl_nodes(graph, os.path.join(GRAPH_DUMPS, f"tp_{name}.dot"))
                      for name, (graph, _) in program.graphs.items()}
        nccl_eager = {VARIANT[c]: _profiled_nccl_kernels(lambda c=c: steps["eager"](
            tp_e, _forced(TorchNoise, c)(1, dev), *batch)) for c in set(coins)}
        log(f"multi: tensor parallel at grid (1, 1) through NCCL, full VG width in bf16 with "
            f"the kernels off, {TP_STEPS} steps at batch {MULTI_TRAIN_BATCH} (self-conditioning "
            f"coins {coins}): compiled (graphs {sorted(program.graphs)}) against eager bit-equal "
            f"{vs_eager} ({d_eager}), eager against the single-device plain step {vs_single} "
            f"({d_single}); metrics equal {metrics_equal}; {n_split} split leaves; collectives of "
            f"the tensor parallel module {dict(counts)} (f and g, the model-group sums), by step "
            f"eager {calls['eager']}, compiled {calls['compiled']} (a coin's first use "
            f"runs and captures: each capture holds the eager step's collectives, a replay "
            f"calls none: {captured}); NCCL kernel nodes in each graph {nccl_graph} against "
            f"NCCL kernels of an eager step (torch.profiler) {nccl_eager} (one rank: NCCL "
            f"launches no device work for a sum in place); kernel launches "
            f"{cuda_build.launches_by_kernel()}")
        if not (vs_eager and vs_single and metrics_equal):
            fail("the tensor-parallel step at grid (1, 1) differs, compiled from eager or eager "
                 "from the single-device step")
        if (min(calls["eager"]) < 2 * 2 * VG["blocks"] or cuda_build.launches_by_kernel()
                or not captured or set(program.graphs) != {VARIANT[c] for c in coins}):
            fail("the tensor-parallel steps did not run their collectives, ran a kernel, or the "
                 "compiled step's graphs do not hold its collectives")
        if any(nccl_graph[VARIANT[c]] != nccl_eager[VARIANT[c]] for c in set(coins)):
            fail("a tensor-parallel graph holds other NCCL work than its eager step launches")
        step_ms = collections.defaultdict(list)
        for sc in (False, True):
            n = {k: _forced(TorchNoise, sc)(1, dev) for k in ("eager", "compiled")}
            for k in ("eager", "compiled", "compiled", "eager"):
                step_ms[(k, sc)].append(time_ms(
                    lambda k=k: steps[k](states[k], n[k], *batch), 3, warmup=1))
        log(f"multi: tensor parallel at grid (1, 1), ms per step at batch {MULTI_TRAIN_BATCH} "
            f"in turns (eager, compiled, compiled, eager) without / with the self-conditioning "
            f"pass: " + "; ".join(" / ".join(f"{t:.3f}" for t in (
                step_ms[("eager", sc)][:1] + step_ms[("compiled", sc)]
                + step_ms[("eager", sc)][1:])) for sc in (False, True)) + f"; on {smi}")
        one, noise_one = states["single"], noises["single"]
        del steps, states, tp_e, tp_c, program
    finally:
        shutdown()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # (d) asynchronous saves: host ms to return, and the drained file holds the
    # state at the save although the state moved on
    params = [p.detach().clone() for p in one.params()]
    emas = [[e.clone() for e in ema] for ema in one.ema_params]
    moments = [{k: one.opt.state[p][k].clone() for k in ("exp_avg", "exp_avg_sq")}
               for p in one.params()]
    host_ms = collections.defaultdict(list)
    for kind in ("sync", "async", "async", "sync"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(ckpt_dir, f"{kind}"), one, {"epoch": 1},
                        asynchronous=kind == "async")
        host_ms[kind].append(1e3 * (time.perf_counter() - t0))
        if kind == "async":
            t0 = time.perf_counter()
            wait_for_async_saves()
            host_ms["async drain"].append(1e3 * (time.perf_counter() - t0))
    save_checkpoint(os.path.join(ckpt_dir, "moving"), one, {"epoch": 2},
                    asynchronous=True)
    one, _ = single(one, noise_one, *batch)  # the state moves on while the write is in flight
    wait_for_async_saves()
    other = fresh(1)
    extra = restore_checkpoint(os.path.join(ckpt_dir, "moving.pt"), other)
    same = (extra == {"epoch": 2}
            and all(torch.equal(a, b) for a, b in zip(other.params(), params))
            and all(torch.equal(a, b) for x, y in zip(other.ema_params, emas)
                    for a, b in zip(x, y))
            and all(torch.equal(other.opt.state[q][k], m[k])
                    for q, m in zip(other.params(), moments) for k in m))
    size = os.path.getsize(os.path.join(ckpt_dir, "moving.pt")) / 2 ** 20
    log(f"multi: checkpoint of {size:.0f} MiB, host ms until the save returns (in turns "
        f"there and back) " + ", ".join(f"{k} {' / '.join(f'{t:.1f}' for t in v)}"
                                        for k, v in host_ms.items())
        + f"; an asynchronous save drained after the state took another step restores the "
          f"state at the save bit-equal: {same}; on {smi}")
    if not same:
        fail("the drained asynchronous checkpoint differs from the state at the save")
    del one, other, params, emas, moments
    torch.cuda.empty_cache()


def _native_batches() -> None:
    """Phase 11 (e): phase 4's data through the native batcher and numpy."""
    import numpy as np

    from diffusesg_torch.config import load_config
    from diffusesg_torch.data import Batches, load_data
    from diffusesg_torch.data.native import get_lib

    cfg = load_config(VG["config"])
    with cfg.unlocked():
        cfg.seed = 0
        cfg.dataset.synthetic_num_train = 4 * TRAIN_BATCH
        cfg.dataset.synthetic_num_test = TRAIN_BATCH
    bundle = load_data(cfg, data_root="/nonexistent")
    lib = get_lib()
    equal, n_batches = lib is not None, 0
    for kw in (dict(shuffle=True), dict(shuffle=False, drop_remainder=True)):
        nat = Batches(bundle.train, TRAIN_BATCH, seed=0, native=True, **kw)
        ref = Batches(bundle.train, TRAIN_BATCH, seed=0, native=False, **kw)
        for epoch in (0, 1):
            nat.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = list(nat), list(ref)
            n_batches += len(got)
            equal &= len(got) == len(want) and all(
                g.dtype == w.dtype and np.array_equal(g, w)
                for gb, wb in zip(got, want) for g, w in zip(gb, wb))
    log(f"multi: the native batcher (built: {lib is not None}) over phase 4's "
        f"{len(bundle.train)} graphs, {n_batches} batches of {TRAIN_BATCH} in two epochs, "
        f"shuffled and in order: equal to the numpy path {equal}")
    if not equal:
        fail("the native batcher's batches differ from the numpy path's, or it did not build")


def check_multi_device(dev, smi: str) -> dict:
    """Phase 11; returns the launches of one shard of the sharded serving."""
    per_shard = _sharded_serving(dev, smi)
    _tensor_parallel_and_checkpoints(dev, smi)
    _native_batches()
    return per_shard


# ----------------------------------------------------------------- phase 12

COMPILED_STEPS = 16
COMPILED_SEED = 31
# where the replay checks of phases 12 and 13 write each graph's nodes (DOT)
GRAPH_DUMPS = os.path.join("build", "smoke_runs", "graphs")
COMPILED_BATCHES = (16, 64)
NORTH_STAR_STEPS = 1000
# the variants of 16 Heun steps with churn: no draw (sigma above S_max or
# below S_min), draws, and the last step's Euler
COMPILED_VARIANTS = 3
BUILD_S = {}  # phase 1's nvcc build, seconds (a cold build when the tree had none)

# a fresh process: load_compiled with an empty kernel build directory and no
# nvcc to call, then the compiled function at one seed; its outputs to an npz
FRESH_LOAD = r"""
import json, sys, time
from pathlib import Path
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from diffusesg_torch.ops import cuda_build
fresh = Path(sys.argv[2])
cuda_build.build_dir = lambda: fresh


def no_nvcc():
    raise RuntimeError("load_compiled ran nvcc")


cuda_build._nvcc = no_nvcc
from diffusesg_torch.serving.export import load_compiled
t0 = time.perf_counter()
fn, meta = load_compiled(sys.argv[1])
load_s = time.perf_counter() - t0
flags = np.load(sys.argv[3])
out = fn(int(sys.argv[5]), flags)
np.savez(sys.argv[4], *out)
library = sorted(p.name for p in fresh.iterdir())
print(json.dumps({"load_s": load_s, "meta": meta, "library": library}))
"""

# a fresh process: a denoiser that reads a value on the host, compiled on
# the card; the capture must raise, not fall back to eager
HOST_READ = r"""
import sys
import torch
from diffusesg_torch.sampling.compiled import CompiledSampler
from diffusesg_torch.sampling.edm_sampler import NodeAdjEDMSampler


def host_read_for(flags):
    def denoiser(a, x, sigmas, sc_a, sc_x):
        if float(sigmas[0]) < 0:  # a host read inside the step
            raise AssertionError("negative sigma")
        return torch.tanh(a), torch.tanh(x)
    return denoiser


flags = torch.ones(2, 8, dtype=torch.bool, device="cuda")
try:
    out = CompiledSampler(NodeAdjEDMSampler(num_steps=4)).sample(host_read_for, flags, 3, 1, seed=0)
except Exception as e:  # noqa: BLE001 - any raise is the answer; its type is printed
    print("RAISED", type(e).__name__, str(e).splitlines()[0][:160])
    sys.exit(0)
print("NO RAISE: the compiled sampler returned", tuple(out[0].shape))
sys.exit(1)
"""


def _flags(b: int, n: int, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    counts = [n] * (b // 2) + [int(c) for c in rng.integers(1, n + 1, b - b // 2)]
    flags = np.zeros((b, n), bool)
    for i, c in enumerate(counts):
        flags[i, :c] = True
    return flags


def _same(got, want) -> bool:
    import numpy as np
    return len(got) == len(want) and all(
        (torch.equal(g, w) if isinstance(g, torch.Tensor) else np.array_equal(g, w))
        for g, w in zip(got, want))


def _compiled_model(dev, smi: str, spec, steps: int = COMPILED_STEPS) -> dict:
    """(a) One model (``spec``), batch 16 and 64: the compiled sampler's
    adjs, nodes and decoded graphs bit-equal to the eager ``sample`` at the
    same seed, twice (the second call all replays), its launch counts equal
    to the eager run's, three variants; graphs/s of the serving core
    compiled and eager, host to host, in turns; host CUDA calls a step;
    seconds of each variant's first use and capture, the pool's bytes.
    Returns the model, its config and the launches of the compiled VG
    batch-16 sampling."""
    from functools import partial

    import numpy as np

    from diffusesg_torch.config import load_config
    from diffusesg_torch.models import build_model
    from diffusesg_torch.models.channels import resolve_sampling_channels
    from diffusesg_torch.ops import cuda_build
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.sampling.compiled import CompiledSampler
    from diffusesg_torch.serving.export import _decoder, fixed_batch, make_denoiser, make_serving_fn

    tag = spec["tag"]
    cfg = load_config(spec["config"])
    with cfg.unlocked():
        cfg.mcmc.num_steps = steps
    model = build_model(cfg, device=dev, seed=0).eval()
    if not model.use_kernels or model.dtype != torch.bfloat16:
        fail(f"phase 12 runs the {tag} model with its kernels in bf16")
    sampler = get_mc_sampler(cfg)
    info = resolve_sampling_channels(cfg)
    decode = _decoder(cfg, "serving")[2]
    n = int(cfg.dataset.max_node_num)
    denoiser_for = partial(make_denoiser, model, cfg)
    out = {"model": model, "cfg": cfg, "launches": {}}
    for b in COMPILED_BATCHES:
        flags_t = torch.from_numpy(_flags(b, n, b)).to(dev)
        runner = CompiledSampler(sampler)
        args = (flags_t, info["num_node_chan"], info["num_adj_chan"])
        with torch.inference_mode():
            cuda_build.reset_launches()
            eager = sampler.sample(denoiser_for(flags_t), *args, seed=COMPILED_SEED)
            eager = (*eager, *decode(*eager, flags_t))
            torch.cuda.synchronize()
            eager_counts = cuda_build.launches_by_kernel()
            cuda_build.reset_launches()
            comp = runner.sample(denoiser_for, *args, seed=COMPILED_SEED)
            comp = (*comp, *decode(*comp, flags_t))
            torch.cuda.synchronize()
            comp_counts = dict(cuda_build.LAUNCHES)
            comp_by_kernel = cuda_build.launches_by_kernel()
            again = runner.sample(denoiser_for, *args, seed=COMPILED_SEED)
            again = (*again, *decode(*again, flags_t))
            torch.cuda.synchronize()
        (stats,) = runner.stats()
        seconds = {k: [round(x, 4) for x in v] for k, v in stats["seconds"].items()}
        same = [_same(comp, eager), _same(again, eager)]
        log(f"compiled {tag} batch {b}: {steps} Heun steps with churn, the compiled sampler's "
            f"adjs, nodes and decoded graphs bit-equal to the eager sampler at seed "
            f"{COMPILED_SEED} (first call, all-replay call): {same}; launches compiled "
            f"{json.dumps(comp_by_kernel, sort_keys=True)} (eager equal: "
            f"{comp_by_kernel == eager_counts}); {stats['variants']} variants, seconds of first "
            f"use / capture {json.dumps(seconds)}; "
            f"graph pool {stats['pool_bytes']} bytes")
        if not all(same):
            fail(f"{tag} batch {b}: the compiled sampler is not bit-equal to the eager one")
        if comp_by_kernel != eager_counts or any(comp_by_kernel.get(k, 0) == 0
                                                 for k in FORWARD_KERNELS):
            fail(f"{tag} batch {b}: compiled launches {comp_by_kernel} against eager "
                 f"{eager_counts}")
        if stats["variants"] != COMPILED_VARIANTS:
            fail(f"{tag} batch {b}: {stats['variants']} variants captured, expected "
                 f"{COMPILED_VARIANTS}")
        (program,) = runner._programs.values()
        with torch.inference_mode():
            got = _replayed_kernels(program.graphs, program._body,
                                    os.path.join(GRAPH_DUMPS, f"{tag}_{b}"))
        replayed = {"+".join(k for k, on in v._asdict().items() if on) or "euler": r
                    for v, r in got.items()}
        log(f"compiled {tag} batch {b}: the port's kernel nodes of each variant's graph "
            f"(debug_dump) equal to those one eager run of its step launches "
            f"(torch.profiler) and its launch "
            f"record equal to that run's wrapper counts: " + "; ".join(
                f"{v} {json.dumps(k, sort_keys=True)} {ok}" for v, (k, ok) in replayed.items()))
        if not all(ok for _, ok in replayed.values()):
            fail(f"{tag} batch {b}: a graph launches other kernels than its launch record says")
        if tag == "VG" and b == 16:
            out["launches"] = comp_counts
        del runner

        # graphs/s of the serving core, host to host, in turns there and back
        cores = {c: fixed_batch(make_serving_fn(model, sampler, cfg, compiled=c), b, n, dev)
                 for c in (False, True)}
        full = np.ones((b, n), bool)
        for c in cores.values():
            c(COMPILED_SEED, full)
        secs = collections.defaultdict(list)
        for c in (False, True, True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cores[c](COMPILED_SEED, full)
            secs[c].append(time.perf_counter() - t0)
        calls = {c: _step_profile(lambda c=c: cores[c](COMPILED_SEED, full))[2:]
                 for c in cores}
        log(f"compiled {tag} batch {b}: graphs/s of the serving core (decoded, numpy out), host "
            f"to host, {steps} Heun steps: eager "
            f"{' / '.join(f'{b / s:.2f}' for s in secs[False])}, compiled "
            f"{' / '.join(f'{b / s:.2f}' for s in secs[True])}; host CUDA calls a step "
            f"eager {calls[False][0] / steps:.1f} {calls[False][1]}, compiled "
            f"{calls[True][0] / steps:.1f} {calls[True][1]}; on {smi}")
        del cores
    return out


def _canonical(name: str) -> str:
    """A device function's demangled name without white space."""
    return "".join(name.split())


def _port_kernel(name: str) -> bool:
    return any(frag in name for frag, _ in KERNEL_OF)


def _port_kernels(prof) -> collections.Counter:
    """The port's kernels in a torch.profiler trace: {device function: launches}."""
    from torch.autograd import DeviceType
    return collections.Counter({_canonical(e.key): e.count for e in prof.key_averages()
                                if e.device_type == DeviceType.CUDA and "#" not in e.key
                                and _port_kernel(e.key)})


def _profiled_port_kernels(fn) -> collections.Counter:
    """The port's kernels one eager call of ``fn`` launches (torch.profiler,
    by device function)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _port_kernels(prof)


def _demangle(mangled: str) -> str:
    """A mangled device-function name as the profiler prints it: the C++
    runtime's own demangler (``abi::__cxa_demangle``, which kineto calls)."""
    import ctypes
    demangle = ctypes.CDLL("libstdc++.so.6").__cxa_demangle
    demangle.restype = ctypes.c_void_p
    demangle.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.POINTER(ctypes.c_int)]
    status = ctypes.c_int()
    out = demangle(mangled.encode(), None, None, ctypes.byref(status))
    if status.value != 0 or not out:
        fail(f"cannot demangle {mangled[:120]} (status {status.value})")
    name = ctypes.string_at(out).decode()
    ctypes.CDLL(None).free(ctypes.c_void_p(out))
    return name


def _graph_port_kernels(graph, path: str) -> collections.Counter:
    """The port's kernels a captured graph holds, read from its nodes and
    not from a trace of a replay: ``debug_dump`` (the graph captured with
    ``cuda_graphs.KEEP_NODES``) writes them to ``path`` as DOT, each kernel
    node under its mangled function name.  {device function: kernel nodes}."""
    import re
    os.makedirs(os.path.dirname(path), exist_ok=True)
    graph.debug_dump(path)
    with open(path) as f:
        dot = f.read()
    mangled = [m.group(1) for label in re.findall(r'label="((?:[^"\\]|\\.)*)"', dot)
               if "KERNEL" in label.split("|")[0]
               for m in [re.search(r"(_Z\w+)", label)] if m]
    if not mangled:
        fail(f"no kernel node in the graph's dump {path}")
    names = {m: _demangle(m) for m in set(mangled)}
    return collections.Counter(_canonical(names[m]) for m in mangled
                               if _port_kernel(names[m]))


def _replayed_kernels(graphs: dict, body, dump_dir: str, quiet: tuple = ()) -> dict:
    """Per graph of a compiled program (``graphs``: {key: (graph, launch
    record)}, captured with ``cuda_graphs.KEEP_NODES``): the port's kernels
    the graph holds (``_graph_port_kernels``) against those one eager run of
    ``body(key)`` on the same static buffers launches (torch.profiler), and
    the launch record (what each replay adds to the launch counts) against
    the wrappers' counts in that eager run.  A graph holds at least one of
    the port's kernels unless its key is in ``quiet``.  Returns {key: (the
    graph's launches by kernel, all equal)}."""
    from diffusesg_torch.ops import cuda_build
    out, t0 = {}, time.perf_counter()
    for i, (key, (graph, record)) in enumerate(graphs.items()):
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        want = _profiled_port_kernels(lambda: body(key))
        wrappers = dict(cuda_build.LAUNCHES)
        got = _graph_port_kernels(graph, os.path.join(dump_dir, f"graph{i}.dot"))
        by_kernel = collections.Counter()
        for name, n in got.items():
            by_kernel[next(k for frag, k in KERNEL_OF if frag in name)] += n
        out[key] = (dict(by_kernel), (bool(got) or key in quiet) and got == want
                     and wrappers == dict(record))
        if got != want:
            log(f"replay check {key}: graph-only {dict(got - want)}, eager-only "
                f"{dict(want - got)}")
        if wrappers != dict(record):
            log(f"replay check {key}: record {dict(record)} against wrappers {wrappers}")
    cuda_build.reset_launches()
    log(f"replay check of {len(graphs)} graphs in {time.perf_counter() - t0:.2f} s")
    return out


def _generate_cost(dev, smi: str, model, cfg) -> None:
    """(i) A reading, not a gate: ``serving.generate`` builds its serving
    core anew at each call, so each call runs every variant's first use and
    capture; its wall seconds against the eager core and a held compiled
    core (all replays), VG, batch 16, and its output bit-equal to eager."""
    import numpy as np

    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.serving import generate
    from diffusesg_torch.serving.export import make_serving_fn

    sampler = get_mc_sampler(cfg)
    n = int(cfg.dataset.max_node_num)
    counts = [int(c) for c in np.random.default_rng(3).integers(1, n + 1, SERVE_BATCH)]
    flags = torch.arange(n, device=dev)[None, :] < torch.tensor(counts, device=dev)[:, None]
    held = make_serving_fn(model, sampler, cfg)
    runs = {"generate": lambda: generate(model, sampler, cfg, counts, COMPILED_SEED, device=dev),
            "eager core": lambda: make_serving_fn(model, sampler, cfg, compiled=False)(
                COMPILED_SEED, flags),
            "held compiled core": lambda: held(COMPILED_SEED, flags)}
    held(COMPILED_SEED, flags)
    secs, outs = collections.defaultdict(list), {}
    for name in ("generate", "eager core", "held compiled core") * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = runs[name]()
        torch.cuda.synchronize()
        secs[name].append(time.perf_counter() - t0)
    same = _same(outs["generate"], outs["eager core"])
    log(f"compiled generate (a reading): VG, {SERVE_BATCH} requests, {COMPILED_STEPS} Heun "
        f"steps, wall s a call: " + ", ".join(f"{k} {' / '.join(f'{x:.4f}' for x in v)}"
                                              for k, v in secs.items())
        + f"; generate bit-equal to the eager core {same}; on {smi}")
    if not same:
        fail("generate differs from the eager serving core")


def _compiled_options(dev, model, cfg) -> None:
    """(b) The completion core with inpainting, interim snapshots and
    ``chunk_steps``, compiled against eager, bit-equal (VG, batch 16)."""
    from functools import partial

    import numpy as np

    from diffusesg_torch.models.channels import resolve_sampling_channels
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.sampling.compiled import CompiledSampler
    from diffusesg_torch.serving.export import (fixed_batch, make_completion_fn, make_denoiser,
                                                make_serving_fn)

    sampler = get_mc_sampler(cfg)
    n, b = int(cfg.dataset.max_node_num), 16
    flags = _flags(b, n, 5)
    rng = np.random.default_rng(5)
    known = (np.arange(n)[None, :] < 6) & flags
    args = (flags, rng.integers(0, VG["node_types"], (b, n)), known,
            rng.uniform(0, 1, (b, n, 4)).astype(np.float32), known,
            rng.integers(0, VG["edge_types"], (b, n, n)), known[:, :, None] & known[:, None, :])
    comp = {c: fixed_batch(make_completion_fn(model, sampler, cfg, compiled=c), b, n, dev)(
        COMPILED_SEED, *args) for c in (True, False)}
    same_complete = _same(comp[True], comp[False])
    pinned = bool(np.array_equal(comp[True][1][known], args[1][known]))

    info = resolve_sampling_channels(cfg)
    flags_t = torch.from_numpy(flags).to(dev)
    run_args = (flags_t, info["num_node_chan"], info["num_adj_chan"])
    with torch.inference_mode():
        interim_c = CompiledSampler(sampler).sample(partial(make_denoiser, model, cfg), *run_args,
                                                    seed=COMPILED_SEED, num_interim=4)
        interim_e = sampler.sample(make_denoiser(model, cfg, flags_t), *run_args,
                                   seed=COMPILED_SEED, num_interim=4)
    same_interim = _same(interim_c, interim_e)
    chunked = fixed_batch(make_serving_fn(model, sampler, cfg, chunk_steps=4), b, n, dev)
    plain = fixed_batch(make_serving_fn(model, sampler, cfg, compiled=False), b, n, dev)
    same_chunk = _same(chunked(COMPILED_SEED, flags), plain(COMPILED_SEED, flags))
    log(f"compiled options (VG, batch {b}): the completion core with inpainting bit-equal to "
        f"eager {same_complete} (pinned node types verbatim {pinned}); 4 interim snapshots "
        f"bit-equal {same_interim}; chunk_steps=4 compiled equal to the eager unchunked core "
        f"{same_chunk}")
    if not (same_complete and pinned and same_interim and same_chunk):
        fail("a compiled option (completion, interim, chunk_steps) differs from eager")


def _compiled_orchestrator(dev, model, cfg) -> None:
    """(c) ``sg_go_sampling`` with an EMA (plain, the sanity check and
    inpainting): the compiled pass's arrays equal to the eager pass's."""
    import numpy as np

    from diffusesg_torch.data import load_data
    from diffusesg_torch.sampling import get_mc_sampler, orchestrator

    exp_dir = os.path.join("build", "smoke_runs", "compiled")
    shutil.rmtree(exp_dir, ignore_errors=True)
    ecfg = _eval_config(exp_dir)
    bundle = load_data(ecfg, data_root="/nonexistent")
    gen = torch.Generator(device=dev).manual_seed(7)
    ema = {k: p.detach() + 1e-3 * torch.randn(p.shape, generator=gen, device=dev).to(p.dtype)
           for k, p in model.named_parameters()}
    sampler = get_mc_sampler(ecfg)
    real, captured = orchestrator.write_artifacts, []
    orchestrator.write_artifacts = lambda res, *a, **k: captured.append(res)
    results = []
    try:
        for kind, kw in (("plain", {}), ("sanity check", dict(sanity_check=True)),
                         ("inpaint", dict(inpaint_frac=0.5))):
            outs = []
            for c in (True, False):
                captured.clear()
                orchestrator.sg_go_sampling(model, ema, sampler, ecfg, bundle, eval_mode=True,
                                            skip_eval=True, compiled=c, **kw)
                outs.append(captured[0])
            same = sorted(outs[0]) == sorted(outs[1]) and all(
                np.array_equal(outs[0][k], outs[1][k]) for k in outs[0])
            results.append((kind, same))
    finally:
        orchestrator.write_artifacts = real
    log(f"compiled orchestrator: sg_go_sampling over {EVAL_GRAPHS} graphs at batch "
        f"{EVAL_GRAPHS} with an EMA through functional_call, every array of the compiled pass "
        f"equal to the eager pass's: {results}")
    if not all(s for _, s in results):
        fail("sg_go_sampling compiled differs from its eager run")


def _compiled_shards(dev, model, cfg) -> None:
    """(d) Two shards of card 0, ``gspmd`` and ``shard_map``: each block of
    the compiled sharded function bit-equal to the eager one's."""
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.serving.export import make_sharded_serving_fn

    sampler = get_mc_sampler(cfg)
    n, b = int(cfg.dataset.max_node_num), MULTI_BATCH
    flags = _flags(b, n, 9)
    res = {}
    for mode in ("gspmd", "shard_map"):
        outs = [make_sharded_serving_fn(model, sampler, cfg, [dev, dev], mode, compiled=c)(
            COMPILED_SEED, flags) for c in (True, False)]
        res[mode] = [_same([o[i * b // 2:(i + 1) * b // 2] for o in outs[0]],
                           [o[i * b // 2:(i + 1) * b // 2] for o in outs[1]]) for i in range(2)]
    log(f"compiled shards: two shards of {dev} at batch {b}, each block of the compiled sharded "
        f"function bit-equal to the eager one's: {res}")
    if not all(all(v) for v in res.values()):
        fail("a compiled shard differs from the eager sharded function")


def _compiled_http(dev, model, cfg) -> None:
    """(e) One burst of seeded requests (and a seeded completion) through
    ``cli.serve``'s compiled core and through an eager server: equal JSON."""
    import numpy as np

    from diffusesg_torch.cli import serve as serve_cli
    from diffusesg_torch.config import save_config
    from diffusesg_torch.serving import BatchingSampler, fixed_batch
    from diffusesg_torch.serving.export import make_completion_fn, make_serving_fn

    root = os.path.join("build", "smoke_runs", "compiled")
    run = os.path.join(root, "run")
    os.makedirs(os.path.join(run, "models_ckpt"), exist_ok=True)
    save_config(cfg, os.path.join(run, "config.yaml"))
    torch.save({"step": 0, "params": {k: v.cpu() for k, v in model.state_dict().items()},
                "ema_params": [], "ema_betas": [], "extra": {}},
               os.path.join(run, "models_ckpt", "00000.pt"))
    argv = ["-p", run, "--num_steps", str(COMPILED_STEPS), "--batch_size", str(SERVE_BATCH)]
    fn, complete_fn, batch, n, scfg, bounds, (smodel, sampler, *_) = \
        serve_cli._load_from_checkpoint(serve_cli.build_serve_parser().parse_args(argv))
    eager = (fixed_batch(make_serving_fn(smodel, sampler, scfg, compiled=False), batch, n, dev),
             fixed_batch(make_completion_fn(smodel, sampler, scfg, compiled=False), batch, n,
                         dev))
    rng = np.random.default_rng(4)
    bodies = [{"num_graphs": int(k), "num_nodes": [int(c) for c in rng.integers(1, n + 1, k)],
               "seed": 100 + i} for i, k in enumerate(rng.integers(1, 5, 6))]
    complete = {"num_nodes": 12, "seed": 5, "known_nodes": [{"index": 0, "type": 3}],
                "known_edges": [[0, 1, 7]]}
    answers = {}
    for name, (gen, comp) in (("compiled", (fn, complete_fn)), ("eager", eager)):
        batcher = BatchingSampler(gen, batch, n, linger_ms=20.0, complete_fn=comp,
                                  num_node_types=bounds[0], num_edge_types=bounds[1])
        batcher.warmup()
        httpd, base = _in_thread(batcher)
        try:
            got, wall = _burst(base, bodies)
            got.append(_http(base + "/v1/complete", complete))
        finally:
            httpd.shutdown()
            httpd.server_close()
            batcher.close()
        for _, a in got:
            a.pop("latency_ms", None)
        answers[name] = (got, wall)
    same = answers["compiled"][0] == answers["eager"][0]
    ok = all(code == 200 for code, _ in answers["compiled"][0])
    log(f"compiled http: a burst of {len(bodies)} seeded /v1/generate requests and a seeded "
        f"/v1/complete through cli.serve's compiled core: JSON equal to the eager server's "
        f"{same}, every answer 200 {ok}; burst wall s compiled {answers['compiled'][1]:.3f}, "
        f"eager {answers['eager'][1]:.3f}")
    if not (same and ok):
        fail("the compiled server answers otherwise than the eager server")


def _compiled_artifact(dev, smi: str, model, cfg) -> None:
    """(f) ``save_compiled`` of the serving core at batch 16, then
    ``load_compiled`` in a fresh process with an empty kernel build
    directory and no nvcc: bit-equal output; load seconds against the cold
    build."""
    import numpy as np

    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.serving.export import (export_sampler, fixed_batch, make_serving_fn,
                                                save_compiled)

    root = os.path.join("build", "smoke_runs", "compiled")
    art, fresh = os.path.join(root, "aot"), os.path.join(root, "fresh_kernels")
    shutil.rmtree(art, ignore_errors=True)
    shutil.rmtree(fresh, ignore_errors=True)
    os.makedirs(fresh)
    sampler, n = get_mc_sampler(cfg), int(cfg.dataset.max_node_num)
    live = fixed_batch(make_serving_fn(model, sampler, cfg), SERVE_BATCH, n, dev)
    t0 = time.perf_counter()
    live(0, np.ones((SERVE_BATCH, n), bool))  # the warm-up load_compiled makes: the captures
    build_s = time.perf_counter() - t0
    meta = {"config": VG["config"], "batch": SERVE_BATCH, "steps": COMPILED_STEPS}
    save_compiled(art, export_sampler(model, sampler, cfg, SERVE_BATCH), meta)
    flags = _flags(SERVE_BATCH, n, 13)
    flags_path, out_path = os.path.join(root, "flags.npy"), os.path.join(root, "fresh_out.npz")
    np.save(flags_path, flags)
    want = live(COMPILED_SEED, flags)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", FRESH_LOAD, art, fresh, flags_path, out_path,
                           str(COMPILED_SEED)], capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"load_compiled in a fresh process: {proc.stderr[-2000:]}")
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    with np.load(out_path) as f:
        got = [f[f"arr_{i}"] for i in range(3)]
    same = _same(got, want)
    log(f"compiled artifact: save_compiled -> {art} ({sorted(os.listdir(art))}); load_compiled "
        f"in a fresh process with an empty build directory and no nvcc: {info['load_s']:.2f} s "
        f"(model, weights, library, warm-up and capture; {wall:.1f} s for the process), library "
        f"installed {info['library']}, meta equal {info['meta'] == meta}, output bit-equal to "
        f"the live function {same}; against a cold build: phase 1's nvcc "
        f"{BUILD_S.get('build', float('nan')):.1f} s (library present before: "
        f"{BUILD_S.get('present')}) + this process's warm-up call {build_s:.2f} s; on {smi}")
    if not (same and info["meta"] == meta and info["library"] == ["libdsg_kernels.so"]):
        fail("load_compiled in a fresh process does not serve the saved function")


def _no_fallback() -> None:
    """(g) A capture that fails raises: a denoiser with a host read."""
    proc = subprocess.run([sys.executable, "-c", HOST_READ], capture_output=True, text=True,
                          timeout=300)
    line = (proc.stdout.strip().splitlines() or [""])[-1]
    log(f"compiled no fallback: a denoiser that reads sigma on the host, compiled on the card: "
        f"exit {proc.returncode}, {line}")
    if proc.returncode != 0 or not line.startswith("RAISED"):
        fail(f"a failed capture did not raise: {line} {proc.stderr[-1000:]}")


def _north_star(dev, smi: str, model, cfg) -> None:
    """(h) A reading, not a gate: VG, batch 64, 1000 Heun steps with churn,
    compiled, decoded: wall seconds and graphs/s (warm-up included)."""
    import numpy as np

    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.serving.export import fixed_batch, make_serving_fn

    with cfg.unlocked():
        cfg.mcmc.num_steps = NORTH_STAR_STEPS
    sampler = get_mc_sampler(cfg)
    n, b = int(cfg.dataset.max_node_num), 64
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serving = fixed_batch(make_serving_fn(model, sampler, cfg), b, n, dev)
    adj, node, bbox = serving(COMPILED_SEED, np.ones((b, n), bool))
    wall = time.perf_counter() - t0
    with cfg.unlocked():
        cfg.mcmc.num_steps = COMPILED_STEPS
    evals = 2 * NORTH_STAR_STEPS - 1
    log(f"compiled north star (a reading): VG batch {b}, {NORTH_STAR_STEPS} Heun steps with "
        f"churn ({evals} denoiser evals), compiled sampling + decode: {wall:.2f} s wall "
        f"({b / wall:.3f} graphs/s, {wall / evals * 1e3:.3f} ms an eval; capture included), "
        f"decoded finite {bool(np.isfinite(bbox).all())}; on {smi}")
    if not np.isfinite(bbox).all():
        fail("the 1000-step sampling decoded non-finite boxes")


def _part_timer():
    """``timed(part, fn, *args)`` calls ``fn(*args)`` and keeps its wall
    seconds in ``timed.seconds[part]``."""
    def timed(part: str, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            timed.seconds[part] = round(time.perf_counter() - t0, 1)
    timed.seconds = {}
    return timed


def check_compiled(dev, smi: str) -> dict:
    """Phase 12, the compiled sampler; returns the launches of the compiled
    VG batch-16 sampling."""
    from diffusesg_torch.utils import cuda_graphs
    timed = _part_timer()
    cuda_graphs.KEEP_NODES = True  # for the replay checks' debug_dump
    vg = timed("(a) VG", _compiled_model, dev, smi, VG)
    timed("(a) COCO", _compiled_model, dev, smi, COCO)
    cuda_graphs.KEEP_NODES = False
    torch.cuda.empty_cache()
    model, cfg = vg["model"], vg["cfg"]
    timed("(b)", _compiled_options, dev, model, cfg)
    timed("(c)", _compiled_orchestrator, dev, model, cfg)
    timed("(d)", _compiled_shards, dev, model, cfg)
    timed("(e)", _compiled_http, dev, model, cfg)
    timed("(f)", _compiled_artifact, dev, smi, model, cfg)
    timed("(i)", _generate_cost, dev, smi, model, cfg)
    timed("(g)", _no_fallback)
    timed("(h)", _north_star, dev, smi, model, cfg)
    log(f"compiled: seconds by part {json.dumps(timed.seconds)}")
    launches = vg["launches"]
    del model, vg
    torch.cuda.empty_cache()
    return launches



# ----------------------------------------------------------------- phase 13

CTRAIN_STEPS = 8
CTRAIN_SPE = 4  # an epoch boundary after step 4: the learning rate changes there
CTRAIN_DECAY = 0.5  # the configs decay by 1.0 an epoch, which would not show the change
# the self-conditioning coin of each step: both variants, each first used at
# a step of its own and replayed after, and the first updates (the EMA
# warm-up) with the conditioning pass and without
CTRAIN_COINS = (True, True, False, True, False, False, True, False)
CTRAIN_SEED = 5
CTRAIN_GRAPHS = {"cond", "no_cond"}
# phase 13 (c): in-training sampling of this many graphs at this many Heun steps
CTRAIN_EVAL_GRAPHS, CTRAIN_SAMPLING_STEPS = 16, 4
# phase 13 (d): the shard_map step's graphs at world 1
SHARD_MAP_GRAPHS = {"backward:cond", "backward:no_cond", "update"}


def _scripted(seed: int, dev):
    """A ``TorchNoise`` whose self-conditioning coin at step i is
    ``CTRAIN_COINS[i]``."""
    from diffusesg_torch.sampling.edm_sampler import TorchNoise

    class Scripted(TorchNoise):
        def bernoulli(self, step, kind, p):
            return CTRAIN_COINS[step % len(CTRAIN_COINS)]
    return Scripted(seed, dev)


def _delta(before: dict, after: dict) -> collections.Counter:
    return collections.Counter({k: n - before.get(k, 0) for k, n in after.items()
                                if n != before.get(k, 0)})


def _by_kernel(counts: dict) -> dict:
    out = collections.Counter()
    for (name, _), n in counts.items():
        out[name] += n
    return dict(out)


def _grads_equal(a, b) -> bool:
    return all(torch.equal(p.grad, q.grad) for p, q in zip(a.params(), b.params()))


def _equal_states(a, b) -> tuple[bool, dict]:
    """(bit-equal, the largest differences) of two training states:
    parameters, gradients, Adam's moments and steps, every EMA, the step."""
    d = _state_diffs(a, b)
    same = (all(d[k] == 0.0 for k in ("params", "emas", "adam")) and len(d["adam_steps"]) == 1
            and a.step == b.step and _grads_equal(a, b))
    return same, d


def _step_profile(fn) -> tuple[float, int, int, dict]:
    """One call of ``fn`` under torch.profiler: the card's busy ms (the sum
    of its kernels, copies and sets), how many of those ran, and the host
    CUDA API calls (cuda* and cu*) with the most frequent."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA and "#" not in e.key]
    calls = {e.key: e.count for e in events
             if e.device_type == DeviceType.CPU and e.key.startswith("cu")}
    top = dict(sorted(calls.items(), key=lambda kv: -kv[1])[:4])
    return (sum(e.device_time_total for e in device) / 1e3, sum(e.count for e in device),
            sum(calls.values()), top)


def _compiled_training(dev, smi: str, spec) -> dict:
    """(a) and (b) for one model (``spec``): 8 steps at batch 64 compiled
    and eager from one seeded state and the same draws, bit-equal, the
    launch counts equal, each graph's replay against its record; readings;
    the compiled test-pass step against eager.  Returns the launch counts
    of the compiled steps."""
    from diffusesg_torch.config import load_config
    from diffusesg_torch.data import load_data
    from diffusesg_torch.models import build_model
    from diffusesg_torch.ops import cuda_build
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train import (create_train_state, ema_slice, make_eval_step,
                                       make_optimizer, make_train_step, train_step_config_from)
    from diffusesg_torch.train.compiled import CompiledEvalStep, CompiledTrainStep

    tag = spec["tag"]
    cfg = load_config(spec["config"])
    with cfg.unlocked():
        cfg.seed = 0
        cfg.dataset.synthetic_num_train = TRAIN_BATCH
        cfg.dataset.synthetic_num_test = TRAIN_BATCH
    bundle = load_data(cfg, data_root="/nonexistent")
    batch = tuple(torch.from_numpy(a[:TRAIN_BATCH]).to(dev) for a in
                  (bundle.train.adjs, bundle.train.nodes, bundle.train.node_flags))
    opt = make_optimizer(cfg.train.lr_init, CTRAIN_DECAY, CTRAIN_SPE, cfg.train.weight_decay)
    eager_state, comp_state = (create_train_state(build_model(cfg, device=dev, seed=0),
                                                  list(cfg.train.ema_coef), opt)
                               for _ in range(2))
    group = comp_state.opt.param_groups[0]
    if not (comp_state.model.use_kernels and comp_state.model.dtype == torch.bfloat16):
        fail(f"phase 13 trains the {tag} model with its kernels in bf16")
    if not (group["capturable"] and isinstance(group["lr"], torch.Tensor)):
        fail("the card's Adam is not capturable with its learning rate on the device")
    step_cfg = train_step_config_from(cfg)
    eager = make_train_step(eager_state.model, step_cfg)
    comp = CompiledTrainStep(make_train_step(comp_state.model, step_cfg))
    noise_e, noise_c = _scripted(CTRAIN_SEED, dev), _scripted(CTRAIN_SEED, dev)
    counts = {"eager": collections.Counter(), "compiled": collections.Counter()}
    metrics_equal, lrs = [], []
    t0 = time.perf_counter()
    for _ in range(CTRAIN_STEPS):
        c0 = dict(cuda_build.LAUNCHES)
        eager_state, m1 = eager(eager_state, noise_e, *batch)
        c1 = dict(cuda_build.LAUNCHES)
        comp_state, m2 = comp(comp_state, noise_c, *batch)
        c2 = dict(cuda_build.LAUNCHES)
        counts["eager"] += _delta(c0, c1)
        counts["compiled"] += _delta(c1, c2)
        metrics_equal.append(m1.keys() == m2.keys() and all(torch.equal(m1[k], m2[k])
                                                            for k in m1))
        lrs.append(float(group["lr"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    same, diffs = _equal_states(eager_state, comp_state)
    (stats,) = comp.stats()
    seconds = {k: [round(x, 3) for x in v] for k, v in stats["seconds"].items()}
    eager_k, comp_k = _by_kernel(counts["eager"]), _by_kernel(counts["compiled"])
    log(f"ctrain {tag}: {CTRAIN_STEPS} training steps at batch {TRAIN_BATCH} (bf16, kernels "
        f"on; coins {list(CTRAIN_COINS)}, learning rates {sorted(set(lrs), reverse=True)}, "
        f"the EMA warm-up at updates 1-2) compiled and eager from one seeded state and the "
        f"same draws in {wall:.2f} s: metrics bit-equal at every step {all(metrics_equal)}, "
        f"state bit-equal {same} ({diffs}); launches compiled {json.dumps(comp_k, sort_keys=True)}"
        f" (eager equal: {counts['compiled'] == counts['eager']}); graphs {stats['variants']}, "
        f"seconds of first use / capture {json.dumps(seconds)}; graph pool "
        f"{stats['pool_bytes']} bytes")
    if not (all(metrics_equal) and same):
        fail(f"{tag}: the compiled training step is not bit-equal to the eager one")
    n_blocks, n_res = spec["blocks"] * CTRAIN_STEPS, spec["resamples"] * CTRAIN_STEPS
    if counts["compiled"] != counts["eager"] or any(
            comp_k.get(k, 0) == 0 for k in FORWARD_KERNELS) or any(
            comp_k.get(k, 0) != n_blocks for k in BACKWARD_KERNELS) or any(
            comp_k.get(k, 0) != n_res for k in RESAMPLE_BWD):
        fail(f"{tag}: compiled training launches {comp_k} against eager {eager_k}")
    if set(stats["variants"]) != CTRAIN_GRAPHS or len(set(lrs)) != 2:
        fail(f"{tag}: graphs {stats['variants']}, learning rates {lrs}")

    # (b) the test pass's step on the smallest-beta EMA, both coins
    ev_e, ev_c = (make_eval_step(comp_state.model, step_cfg), CompiledEvalStep(
        make_eval_step(comp_state.model, step_cfg)))
    ne, nc = _scripted(CTRAIN_SEED + 1, dev), _scripted(CTRAIN_SEED + 1, dev)
    eval_equal = []
    for i in range(3):
        want = ev_e(ema_slice(comp_state, 0), ne, i, *batch)
        got = ev_c(ema_slice(comp_state, 0), nc, i, *batch)
        eval_equal.append(all(torch.equal(got[k], want[k]) for k in want))
    eval_ms = {c: time_ms(lambda c=c: (ev_c if c else ev_e)(ema_slice(comp_state, 0),
                                                           nc if c else ne, 0, *batch), 5)
               for c in (False, True)}
    (ev_stats,) = ev_c.stats()
    log(f"ctrain {tag}: the test pass's step on the smallest-beta EMA, compiled against "
        f"eager (3 batches, coins {list(CTRAIN_COINS[:3])}): metrics bit-equal {all(eval_equal)}"
        f"; graphs {ev_stats['variants']}; ms per eval step (coin of step 0) eager "
        f"{eval_ms[False]:.3f}, compiled {eval_ms[True]:.3f}")
    if not all(eval_equal):
        fail(f"{tag}: the compiled eval step is not bit-equal to the eager one")
    del ev_e, ev_c

    # each graph's replay launches the kernels its record says
    (program,) = comp._programs.values()
    replayed = _replayed_kernels(dict(sorted(program.graphs.items())),
                                 lambda name: program.bodies[name](),
                                 os.path.join(GRAPH_DUMPS, f"train_{tag}"))
    log(f"ctrain {tag}: the port's kernel nodes of each training graph (debug_dump) equal "
        f"to those one eager run of its body launches (torch.profiler), and its launch "
        f"record equal "
        f"to that run's wrapper counts: " + "; ".join(
            f"{g} {json.dumps(k, sort_keys=True)} {ok}" for g, (k, ok) in replayed.items()))
    if not all(ok for _, ok in replayed.values()):
        fail(f"{tag}: a training graph launches other kernels than its launch record says")

    # readings: ms per step in turns, the replay alone; with the pass also
    # the card's busy ms and the host CUDA calls of one step
    step_ms = collections.defaultdict(list)
    for sc in (False, True):
        n_e, n_c = (_forced(TorchNoise, sc)(1, dev) for _ in range(2))
        runs = {"eager": lambda: eager(eager_state, n_e, *batch),
                "compiled": lambda: comp(comp_state, n_c, *batch)}
        for kind in ("eager", "compiled", "compiled", "eager"):
            step_ms[(kind, sc)].append(time_ms(runs[kind], 3, warmup=1))
        mean = {k: sum(step_ms[(k, sc)]) / 2 for k in runs}
        graph = program.graphs["cond" if sc else "no_cond"][0]
        replay_ms = time_ms(graph.replay, 3, warmup=1)
        busy = ""
        if sc:
            prof = {k: _step_profile(runs[k]) for k in runs}
            busy = (f"; the card busy {prof['eager'][0]:.3f} ms of an eager step "
                    f"({prof['eager'][1]} kernels, copies and sets), {prof['compiled'][0]:.3f} "
                    f"ms of a compiled one ({prof['compiled'][1]}); host CUDA calls a step "
                    f"eager {prof['eager'][2]} {prof['eager'][3]}, compiled "
                    f"{prof['compiled'][2]} {prof['compiled'][3]}")
        log(f"ctrain {tag}: {'with' if sc else 'without'} the self-conditioning pass, ms per "
            f"training step at batch {TRAIN_BATCH} in turns (eager, compiled, compiled, eager) "
            f"{' / '.join(f'{t:.3f}' for t in step_ms[('eager', sc)][:1] + step_ms[('compiled', sc)] + step_ms[('eager', sc)][1:])}"
            f"; mean eager {mean['eager']:.3f}, compiled {mean['compiled']:.3f} "
            f"({TRAIN_BATCH * 1e3 / mean['eager']:.1f} and "
            f"{TRAIN_BATCH * 1e3 / mean['compiled']:.1f} training graphs/s); the graph's replay "
            f"alone {replay_ms:.3f} ms{busy}; on {smi}")
    ema_ms, ema_bytes = _ema_update_ms(comp_state)
    log(f"ctrain {tag}: the update of the {len(comp_state.ema_betas)} EMAs alone, ms in turns: "
        f"lerp against the device weight views (the step's) "
        f"{' / '.join(f'{t:.3f}' for t in ema_ms['views'])}, lerp with number weights "
        f"{' / '.join(f'{t:.3f}' for t in ema_ms['numbers'])}; the views read "
        f"{ema_bytes / 2 ** 20:.1f} MiB more (one weight an element of each EMA); on {smi}")
    del eager_state, eager, runs, n_e
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    comp(comp_state, noise_c, *batch)
    torch.cuda.synchronize()
    pool = comp.stats()[0]["pool_bytes"]
    log(f"ctrain {tag}: a compiled step alone (the eager state freed): peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, reserved "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB (graph pool "
        f"{'unknown' if pool is None else f'{pool / 2 ** 30:.2f}'} GiB) on {smi}")
    del comp, comp_state
    torch.cuda.empty_cache()
    return dict(counts["compiled"])


def _ema_update_ms(state) -> tuple[dict, int]:
    """ms of one update of the K EMAs (eager, in turns views, numbers,
    numbers, views): ``torch._foreach_lerp_`` against the weight views of
    ``state.ema_weights`` (the step's, capturable) and with number weights
    (which a graph would freeze), on copies of the EMAs; and the bytes the
    views read in addition."""
    from diffusesg_torch.train.train_state import ema_effective_decay
    params = [p.detach() for p in state.params()]
    emas = [[e.clone() for e in row] for row in state.ema_params]
    weights = [1.0 - ema_effective_decay(b, state.step) for b in state.ema_betas]
    views = state.ema_weights.views
    runs = {"views": lambda: [torch._foreach_lerp_(e, params, v) for e, v in zip(emas, views)],
            "numbers": lambda: [torch._foreach_lerp_(e, params, w)
                                for e, w in zip(emas, weights)]}
    ms = collections.defaultdict(list)
    for kind in ("views", "numbers", "numbers", "views"):
        ms[kind].append(time_ms(runs[kind], 5, warmup=1))
    extra = len(emas) * sum(p.numel() * p.element_size() for p in params)
    return ms, extra


def _compiled_go_training(dev, smi: str) -> None:
    """(c) ``go_training`` compiled (its default) against ``compiled=False``:
    2 epochs of 2 steps (full VG, bf16, kernels on), a test pass, an
    asynchronous checkpoint and in-training sampling (16 graphs, 4 Heun
    steps) each epoch; the final
    states, the loss logs and the sampling rows equal; the compiled run's
    checkpoint restored bit-equal in an eager trainer on the card and on
    the CPU's plain Adam."""
    import csv

    from diffusesg_torch.data import load_data
    from diffusesg_torch.models import build_model
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train import (create_train_state, go_training, make_optimizer,
                                       train_step_config_from)
    from diffusesg_torch.utils.checkpoint import restore_checkpoint
    from diffusesg_torch.utils.logging_utils import set_seed_and_logger

    def run(compiled: bool):
        exp_dir = os.path.join("build", "smoke_runs", "ctrain", str(compiled))
        shutil.rmtree(exp_dir, ignore_errors=True)
        cfg = _eval_config(exp_dir)
        with cfg.unlocked():  # phase 8's config, cut to fit the run's time
            cfg.dataset.synthetic_num_train = 2 * TRAIN_BATCH
            cfg.mcmc.num_steps = CTRAIN_SAMPLING_STEPS
            cfg.test.eval_size = CTRAIN_EVAL_GRAPHS
        set_seed_and_logger(cfg, mode="train", comment=f"ctrain_{compiled}",
                            log_level="WARNING")
        bundle = load_data(cfg, data_root="/nonexistent")
        state = create_train_state(build_model(cfg, device=dev, seed=0),
                                   list(cfg.train.ema_coef),
                                   make_optimizer(cfg.train.lr_init, cfg.train.lr_dacey, 2,
                                                  cfg.train.weight_decay))
        t0 = time.perf_counter()
        state = go_training(state.model, state, train_step_config_from(cfg), cfg, bundle,
                            mc_sampler=get_mc_sampler(cfg), noise=TorchNoise(0, dev),
                            compiled=compiled)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        logs = {}
        for name in ("train_loss.log", "test_loss.log"):
            with open(os.path.join(cfg.logdir, name)) as f:
                logs[name] = f.read()
        with open(os.path.join(cfg.logdir, "eval_results.csv"), newline="") as f:
            # a row holds its pass's seconds and paths: the metrics' columns
            rows = [{k: r[k] for k in METRIC_KEYS} for r in csv.DictReader(f)]
        return state, logs, rows, cfg, wall

    comp, comp_logs, comp_rows, cfg, comp_s = run(True)
    eager, eager_logs, eager_rows, _, eager_s = run(False)
    same, diffs = _equal_states(comp, eager)
    rows_equal = len(comp_rows) == 2 and comp_rows == eager_rows
    ckpt = os.path.join(cfg.model_ckpt_dir, "00001.pt")
    other = create_train_state(build_model(cfg, device=dev, seed=1), list(cfg.train.ema_coef),
                               make_optimizer(cfg.train.lr_init, cfg.train.lr_dacey, 2,
                                              cfg.train.weight_decay))
    extra = restore_checkpoint(ckpt, other)
    back = _state_diffs(other, comp)
    restored = (back["params"] == back["emas"] == back["adam"] == 0.0
                and other.step == comp.step and extra.get("epoch") == 1)
    del other
    torch.cuda.empty_cache()
    cpu = create_train_state(build_model(cfg, device="cpu", seed=1), list(cfg.train.ema_coef),
                             make_optimizer(cfg.train.lr_init, cfg.train.lr_dacey, 2,
                                            cfg.train.weight_decay))
    restore_checkpoint(ckpt, cpu)
    group = cpu.opt.param_groups[0]
    on_cpu = (not group["capturable"] and type(group["lr"]) is float and cpu.step == comp.step
              and all(torch.equal(a, b.cpu()) for a, b in zip(cpu.params(), comp.params()))
              and all(torch.equal(a, b.cpu()) for ea, eb in zip(cpu.ema_params, comp.ema_params)
                      for a, b in zip(ea, eb))
              and all(torch.equal(cpu.opt.state[p][k], comp.opt.state[q][k].cpu())
                      for p, q in zip(cpu.params(), comp.params())
                      for k in ("step", "exp_avg", "exp_avg_sq")))
    del cpu
    log(f"ctrain: go_training (full VG, bf16, kernels on; 2 epochs of 2 steps at batch "
        f"{TRAIN_BATCH}, a test pass, an asynchronous checkpoint and in-training sampling of "
        f"{CTRAIN_EVAL_GRAPHS} graphs at {CTRAIN_SAMPLING_STEPS} Heun steps each epoch) "
        f"compiled in {comp_s:.2f} s and with compiled=False "
        f"in {eager_s:.2f} s: final state bit-equal {same} ({diffs}); train_loss.log and "
        f"test_loss.log equal {comp_logs == eager_logs}; sampling rows' metrics equal "
        f"{rows_equal}; the compiled run's epoch-1 checkpoint restored bit-equal in an eager "
        f"trainer on the card {restored} and on the CPU's plain Adam {on_cpu}")
    if not (same and comp_logs == eager_logs and rows_equal and restored and on_cpu):
        fail("compiled go_training differs from compiled=False, or its checkpoint does not "
             "restore")


def _compiled_shard_map(dev) -> None:
    """(d) The ``shard_map`` step at world 1 through NCCL (full VG, bf16,
    kernels on, batch 64, 3 steps, both coins): compiled (two graphs per
    coin around the all-reduce, one update graph) bit-equal to the eager
    ``shard_map`` step and to the compiled single-device step."""
    import torch.distributed as dist

    from diffusesg_torch.data import load_data
    from diffusesg_torch.ops import cuda_build
    from diffusesg_torch.parallel.distributed import maybe_initialize_distributed, shutdown
    from diffusesg_torch.parallel.mesh import current_world
    from diffusesg_torch.parallel.shardmap_dp import make_shardmap_train_step
    from diffusesg_torch.train import make_train_step, train_step_config_from
    from diffusesg_torch.train.compiled import CompiledTrainStep

    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0")
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    cfg = _dp_config(os.path.join("build", "smoke_runs", "ctrain_dp"))
    try:
        if not maybe_initialize_distributed("cuda") or dist.get_backend() != "nccl":
            fail("phase 13 did not start an NCCL process group")
        world = current_world()
        bundle = load_data(cfg, data_root="/nonexistent")
        batch = tuple(torch.from_numpy(a[:TRAIN_BATCH]).to(dev) for a in
                      (bundle.train.adjs, bundle.train.nodes, bundle.train.node_flags))
        step_cfg = train_step_config_from(cfg)
        single, sm_c, sm_e = _train_states(cfg, dev, 3)
        steps = {"single": CompiledTrainStep(make_train_step(single.model, step_cfg)),
                 "compiled": make_shardmap_train_step(sm_c.model, step_cfg, world),
                 "eager": make_shardmap_train_step(sm_e.model, step_cfg, world, compiled=False)}
        states = {"single": single, "compiled": sm_c, "eager": sm_e}
        noises = {k: _scripted(CTRAIN_SEED, dev) for k in steps}
        counts = {k: collections.Counter() for k in steps}
        metrics_equal = True
        for _ in range(3):
            out = {}
            for k in steps:
                c0 = dict(cuda_build.LAUNCHES)
                states[k], out[k] = steps[k](states[k], noises[k], *batch)
                counts[k] += _delta(c0, dict(cuda_build.LAUNCHES))
            metrics_equal &= all(torch.equal(out["compiled"][m], out[k][m])
                                 for k in ("eager", "single") for m in out["eager"])
        torch.cuda.synchronize()
        vs_eager, d_eager = _equal_states(states["compiled"], states["eager"])
        vs_single, d_single = _equal_states(states["compiled"], states["single"])
        (stats,) = steps["compiled"].stats()
        launches_equal = counts["compiled"] == counts["eager"] == counts["single"]
        log(f"ctrain: shard_map at world 1 through NCCL, 3 steps at batch {TRAIN_BATCH} (full "
            f"VG, bf16, kernels on; coins {list(CTRAIN_COINS[:3])}): compiled (graphs "
            f"{stats['variants']}, the all-reduce between) against the eager shard_map step "
            f"bit-equal {vs_eager} ({d_eager}), against the compiled single-device step "
            f"{vs_single} ({d_single}); metrics equal {metrics_equal}; launches equal "
            f"{launches_equal} {json.dumps(_by_kernel(counts['compiled']), sort_keys=True)}")
        if not (vs_eager and vs_single and metrics_equal and launches_equal):
            fail("the compiled shard_map step differs from the eager one or the single-device "
                 "step")
        if set(stats["variants"]) != SHARD_MAP_GRAPHS:
            fail(f"the compiled shard_map step captured {stats['variants']}")
        del steps, states, single, sm_c, sm_e
    finally:
        shutdown()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.empty_cache()


def check_compiled_training(dev, smi: str) -> dict:
    """Phase 13, the compiled training step; returns the launch counts of
    its compiled VG and COCO runs ({"vg": ..., "coco": ...})."""
    from diffusesg_torch.ops import cuda_build
    from diffusesg_torch.utils import cuda_graphs
    timed = _part_timer()
    cuda_graphs.KEEP_NODES = True  # for the replay checks' debug_dump
    cuda_build.reset_launches()
    counts = {"vg": timed("(a, b) VG", _compiled_training, dev, smi, VG)}
    counts["coco"] = timed("(a, b) COCO", _compiled_training, dev, smi, COCO)
    cuda_graphs.KEEP_NODES = False
    timed("(c)", _compiled_go_training, dev, smi)
    timed("(d)", _compiled_shard_map, dev)
    log(f"ctrain: seconds by part {json.dumps(timed.seconds)}")
    return counts


def _latest_samples(logdir) -> dict:
    import glob

    import numpy as np
    runs = sorted(glob.glob(os.path.join(logdir, "sampling_during_evaluation", "*")),
                  key=os.path.getmtime)
    with np.load(os.path.join(runs[-1], "final_samples_array_before_eval.npz")) as f:
        return {k: f[k] for k in f.files}


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
             ("token_mlp_kernel", "token_mlp"), ("mlp_close_kernel", "token_mlp"),
             ("MergeProj", "patch_merge"),
             ("BreakupIn", "patch_breakup"), ("breakup_rows_kernel", "patch_breakup"),
             ("BreakupOut", "patch_breakup"), ("readout_kernel", "readout"),
             ("patch_embed_kernel", "patch_embed"))
# device functions printed under their own names beside their kernel's total:
# the parts of the redesigned kernels (label, name fragment, kernel)
PARTS = (("attention half", "window_attn_kernel_fused", "swin_attn"),
         ("attention closing pass", "window_attn_kernel_close", "swin_attn"),
         ("fused MLP", "token_mlp_kernel", "token_mlp"),
         ("closing pass", "mlp_close_kernel", "token_mlp"),
         ("breakup first GEMM", "BreakupIn", "patch_breakup"),
         ("breakup row pass", "breakup_rows_kernel", "patch_breakup"),
         ("breakup second GEMM", "BreakupOut", "patch_breakup"),
         ("output head", "readout_kernel_head", "readout"),
         ("fused window backward", "window_attn_bwd_kernel_fused", "swin_attn_bwd"),
         ("backward window core", "window_attn_bwd_kernel<", "swin_attn_bwd"),
         ("qkv recompute", "SwinBwdQkv", "swin_attn_bwd"),
         ("attention weight gradients", "SwinBwdDw", "swin_attn_bwd"),
         ("dy Wproj", "SwinBwdDattn", "swin_attn_bwd"),
         ("dqkv Wqkv", "SwinBwdDhn", "swin_attn_bwd"),
         ("fused MLP backward", "MlpBwdFused", "token_mlp_bwd"),
         ("MLP weight gradients", "MlpBwdDw", "token_mlp_bwd"),
         ("MLP chain fc1 recompute", "MlpBwdFc1", "token_mlp_bwd"))


def profile_eval(ev, eager_ms: float, tag: str) -> None:
    """Device time of one batch-64 denoiser eval by kernel (torch.profiler),
    and the launches of each kernel in that eval; no PyTorch LayerNorm runs
    in it (the full-resolution ends are patch_embed and the output head)."""
    with torch.inference_mode():
        funcs = profile_call(ev, f"one batch-64 {tag} eval", eager_ms)
    norms = [k for _, _, k in funcs if "layer_norm" in k]
    if norms:
        fail(f"a {tag} sampling eval ran PyTorch's LayerNorm: {norms}")


def profile_call(fn, what: str, eager_ms: float) -> list:
    """Device time of one call of ``fn`` by kernel (torch.profiler), and the
    launches of each kernel in that call; returns the device functions as
    (ms, launches, name)."""
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
        return funcs
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
    return funcs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-slice", action="store_true", help="skip phases 3 to 13")
    ap.add_argument("--no-train", action="store_true",
                    help="skip phases 4, 6, 10 and 13, and phase 8's training run")
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
    BUILD_S["present"] = (cuda_build.build_dir() / "libdsg_kernels.so").exists()
    cuda_build.build(verbose=True)
    cuda_build.lib()
    BUILD_S["build"] = time.perf_counter() - t0
    log(f"build: {BUILD_S['build']:.1f} s -> {cuda_build.build_dir()}")
    check_sass(cuda_build.build())
    from diffusesg_torch.ops import mlp_block_kernel as mk
    from diffusesg_torch.ops import mm_microbench as mm
    from diffusesg_torch.ops import patch_embed as pe
    from diffusesg_torch.ops import patch_resample as pr
    from diffusesg_torch.ops import readout_kernel as rk
    from diffusesg_torch.ops import swin_block_v3 as sw
    log("Hopper GEMM tiles (rows, columns, blocks an SM, whole rows), as the library reports "
        "them: " + ", ".join(f"patch_breakup {w} {cin}->{dim} {pr.breakup_tile(dev, cin, dim, w)}"
                           for cin, dim in ((1536, 1536), (768, 768), (384, 384))
                           for w in ("in", "out"))
        + ", " + ", ".join(f"patch_merge C{c} {pr.merge_tile(dev, c)}" for c in (96, 192, 384))
        + f", patch_merge C96 64-row panels {pr.merge_tile(dev, 96, True)}; readout (rows, "
          f"warpgroups, blocks an SM) {rk.readout_tile(dev)}, its output head "
          f"{rk.head_tile(dev)}, patch_embed {pe.embed_tile(dev)}; backward: "
        + ", ".join(f"swin_attn_bwd {w} C{c} {sw.attn_bwd_tile(dev, c, w)}"
                    for c in (96, 192, 384, 768) for w in ("qkv", "stream", "wgrad"))
        + ", " + ", ".join(f"swin_attn_bwd fused C{c} L={L} {sw.attn_bwd_fused_tile(dev, c, L)}"
                           for c in (96, 192, 384, 768) for L in (64, 100) if (c, L) != (768, 100))
        + ", " + ", ".join(f"token_mlp_bwd fused C{c} {mk.mlp_bwd_fused_tile(dev, c)}"
                           for c in (96, 192, 384, 768))
        + ", " + ", ".join(f"token_mlp_bwd {w} C{c} {mk.mlp_bwd_tile(dev, c, w)}"
                           for c in (384, 768) for w in ("fc1", "stream"))
        + ", " + ", ".join(f"token_mlp_bwd wgrad {j} columns {mk.mlp_bwd_tile(dev, j, 'wgrad')}"
                           for j in (96, 384, 768, 3072))
        + "; mm_accumulate (rows, columns, blocks an SM, shared bytes): "
        + ", ".join(f"{m}x{k}x{n} {t} {mm.kernel_tile(dev, n, k, t == 'int8')}"
                    for m, k, n in mm.SHAPES for t in ("bf16", "int8")))
    log("grid plans, as the library reports them: swin_attn (rows, windows a block, blocks an "
        "SM, heads a block) " + ", ".join(f"C{c} L={L} {sw.attn_tile(dev, c, L)}"
                                          for c in (96, 192, 384, 768) for L in (64, 100)
                                          if (c, L) != (768, 100))
        + "; blocks of the window cores an SM holds "
        + ", ".join(f"{q} L={L} {cuda_build.blocks_per_sm(dev, q, L)}"
                    for q in ("dsg_window_attention_per_sm", "dsg_swin_attn_bwd_core_per_sm")
                    for L in (64, 100))
        + "; token_mlp (rows, hidden chunk, blocks an SM) "
        + ", ".join(f"C{c} {mk.mlp_tile(dev, c)}" for c in (64, 96, 192, 384, 768)))

    # wall seconds of each phase, printed as it ends and again before the last lines
    seconds, mark = {}, [t0]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        seconds[phase] = round(now - mark[0], 1)
        mark[0] = now
        log(f"phase {phase}: {seconds[phase]} s")

    lap("1")
    results, entry_cases = check_kernels(dev)
    lap("2")
    # launch counts per path: {path: (sampling or entries run, training run)}
    counts, eval_counts, serve_counts, dp_counts, shard_counts = {}, {}, {}, {}, {}
    compiled_counts, ctrain_counts, cdp_counts = {}, {}, {}
    if not args.no_slice:
        vg, _ = check_slice(dev, smi, VG)
        lap("3")
        vg_train = {} if args.no_train else check_training(dev, smi, VG)
        lap("4")
        coco, coco_model = check_slice(dev, smi, COCO)
        entries = check_entries(dev, coco_model, entry_cases)
        del coco_model
        torch.cuda.empty_cache()
        lap("5")
        coco_train = {} if args.no_train else check_training(dev, smi, COCO,
                                                             find_largest_batch=False)
        lap("6")
        counts = dict(vg=(vg, vg_train), coco=(coco, coco_train), entries=(entries, {}))
        check_small_config(dev)
        lap("7")
        eval_counts = check_eval_slice(dev, smi, run_training=not args.no_train)
        lap("8")
        serve_counts = check_serving(dev, smi)
        lap("9")
        if not args.no_train:
            dp_counts, cdp_counts = check_data_parallel(dev, smi)
        lap("10")
        shard_counts = check_multi_device(dev, smi)
        lap("11")
        compiled_counts = check_compiled(dev, smi)
        lap("12")
        if not args.no_train:
            ctrain_counts = check_compiled_training(dev, smi)
        lap("13")
    # launches: of the path's sampling (or entries) run for the forward
    # kernels, of its training run for the backward kernels; launches_train:
    # of the training run; launches_eval: of phase 8 and launches_serve: of
    # phase 9 (the VG forward kernels); launches_dp: of phase 10's
    # data-parallel go_training run (the VG forward and backward kernels);
    # launches_shard: of one shard of phase 11's gspmd serving (the VG
    # forward kernels); launches_compiled: of phase 12's compiled VG sampling
    # at batch 16 (eager first uses + captured launches x replays);
    # launches_compiled_train: of phase 13's 8 compiled training steps of the
    # path's model (VG or COCO; first uses + captured launches x replays);
    # launches_compiled_dp: of phase 10's 8 compiled gspmd + ZeRO-1 steps (VG).
    # A case that moves several counters (an entry over two kernels) reports
    # the least of them.
    for r in results:
        keys, kernel, path = r.pop("keys"), r.pop("kernel"), r.pop("path")
        run, train = counts.get(path, ({}, {}))
        r["launches_train"] = min(train.get(k, 0) for k in keys)
        r["launches_eval"] = min(eval_counts.get(k, 0) for k in keys) if path == "vg" else 0
        r["launches_serve"] = min(serve_counts.get(k, 0) for k in keys) if path == "vg" else 0
        r["launches_dp"] = min(dp_counts.get(k, 0) for k in keys) if path == "vg" else 0
        r["launches_shard"] = min(shard_counts.get(k, 0) for k in keys) if path == "vg" else 0
        r["launches_compiled"] = (min(compiled_counts.get(k, 0) for k in keys) if path == "vg"
                                  else 0)
        if compiled_counts and path == "vg" and not kernel.endswith("_bwd") and \
                r["launches_compiled"] == 0:
            fail(f"{r['name']} was never launched by the compiled sampler")
        if dp_counts and path == "vg" and r["launches_dp"] == 0:
            fail(f"{r['name']} was never launched on the data-parallel path")
        r["launches_compiled_dp"] = min(cdp_counts.get(k, 0) for k in keys) if path == "vg" else 0
        if cdp_counts and path == "vg" and r["launches_compiled_dp"] == 0:
            fail(f"{r['name']} was never launched by the compiled gspmd step")
        r["launches_compiled_train"] = min(ctrain_counts.get(path, {}).get(k, 0) for k in keys)
        if ctrain_counts and path in ctrain_counts and r["launches_compiled_train"] == 0:
            fail(f"{r['name']} was never launched by the compiled training step")
        r["launches"] = (r["launches_train"] if kernel.endswith("_bwd")
                         else min(run.get(k, 0) for k in keys))
        if r["launches"] == 0 and not (args.no_slice or (args.no_train and
                                                         kernel.endswith("_bwd"))):
            fail(f"{r['name']} was never launched on its path")
    log(f"phase seconds: {json.dumps(seconds)}, {sum(seconds.values()):.1f} s in all")
    log(smi)
    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
