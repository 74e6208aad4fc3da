"""Driver of the sampling mixes: a closed loop of whole batches through the
program's serving core.

The entry is ``serving/export.py``: ``make_serving_fn`` over the config's
sampler (``sampling/factory.get_mc_sampler``), bound by ``fixed_batch`` to
the mix's batch and the card, numpy in and out; on the card every sampler
step replays a captured CUDA graph (``sampling/compiled.py``).  Each batch
has its own node counts and draws, both from the seed, and the next batch
is sent when the last one's decoded graphs are back on the host.

Set-up builds the kernels, the model and the core, and sends one batch of
its own, which makes each step variant's first use and capture: the
window then only replays.  The window holds whole batches: the rate is the
graphs decoded over the seconds from its start to the end of its last
batch, which starts before ``seconds`` have passed.

Correctness: once the window has closed and the program is freed, a
sample of the window's graphs drawn from the seed is sampled again by the
plain float32 reference (``reference/sampler.py``) from the same weights,
node counts and draws, decoded, and compared graph by graph.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchlib import data, support, weights
from benchlib.noise import KeyedNoise, key
from reference import model as ref_model
from reference import sampler as ref_sampler
from yardstick import flops as yflops

BATCH_STREAM, CHECK_STREAM = 4, 5


def _program(cfg, mix, seed, device):
    from diffusesg_torch.sampling import factory
    from diffusesg_torch.serving import export
    model = support.build_model(cfg, weights.make(support.param_shapes(cfg), seed, device),
                                device).eval()
    sampler = factory.get_mc_sampler(cfg)
    if mix.get("heun_steps"):
        import dataclasses
        sampler = dataclasses.replace(sampler, num_steps=int(mix["heun_steps"]))
    serve = export.fixed_batch(export.make_serving_fn(model, sampler, cfg), mix["batch"],
                               cfg.dataset.max_node_num, device)
    return model, sampler, serve


def batch_flags(seed: int, k: int, mix: dict, n: int) -> np.ndarray:
    rng = np.random.default_rng(key(seed, BATCH_STREAM, k))
    return data.flags_of(data.node_counts(rng, mix["batch"], mix["nodes_min"], n), n)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float, world=None) -> dict:
    mc, mix = cell.model_config, cell.traffic
    cfg = support.program_config(mc)
    shape = ref_model.Shape.of(mc)
    n, b = shape.n, mix["batch"]
    model, sampler, serve = _program(cfg, mix, seed, device)

    def one(k):
        """Batch k (-1: set-up's) through the serving core."""
        flags = batch_flags(seed, k, mix, n)
        return flags, serve(0, flags, noise=KeyedNoise(seed, device, stream=k + 1))

    one(-1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - t0
    support.check_guard("after set-up")

    outs, res = [], {}

    def loop(limit_s=None, batches=None):
        start = time.perf_counter()
        while True:
            outs.append(one(len(outs)))
            if batches is not None and len(outs) >= batches:
                break
            if limit_s is not None and time.perf_counter() - start >= limit_s:
                break
        return time.perf_counter() - start

    evals = 2 * sampler.num_steps - 1  # Heun with the reused first evaluation
    if trace:
        summary, window_s, _ = support.profiled(lambda: loop(batches=mix["traced_batches"]))
        res["ctx"] = dict(trace=summary, window_s=window_s, shape=shape, rows=b,
                          chips=1, forward_passes=len(outs) * evals,
                          heun_steps=len(outs) * sampler.num_steps,
                          flop=len(outs) * b * evals * yflops.forward_flops(mc))
    else:
        window_s = loop(limit_s=seconds)
        res["e2e"] = {"sample_graphs_per_s": len(outs) * b / window_s, "setup_s": setup_s}
    res["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    res["attempted"] = len(outs) * b
    res["failed"] = int(sum((~np.isfinite(o[1][2])).any(axis=(1, 2)).sum() for o in outs))
    del model, sampler, serve
    support.free_cuda()
    res["checks"] = check(cell, seed, outs, device)
    return res


def picked(cell, seed: int, batches: int) -> list:
    """The seed's choice of graphs to check among ``batches`` batches:
    [(batch, row)]."""
    b = cell.traffic["batch"]
    total = batches * b
    pick = np.sort(np.random.default_rng(key(seed, CHECK_STREAM)).choice(
        total, size=min(cell.check["check_graphs"], total), replace=False))
    return [(int(i) // b, int(i) % b) for i in pick]


def reference(cell, seed: int, where: list, device, quant=None):
    """The reference's decoded graphs of ``where`` [(batch, row)]: (flags,
    (adj types, node types, boxes)) as numpy."""
    mc, mix = cell.model_config, cell.traffic
    shape = ref_model.Shape.of(mc)
    b = mix["batch"]
    flags_np = np.stack([batch_flags(seed, k, mix, shape.n)[r] for k, r in where])
    flags = torch.from_numpy(flags_np).to(device)
    sources = {k: KeyedNoise(seed, device, stream=k + 1) for k, _ in where}

    def draw(step, kind, rows_shape):
        full = (b,) + tuple(rows_shape[1:])
        per = {k: src.normal(step, kind, full) for k, src in sources.items()}
        return torch.stack([per[k][r] for k, r in where])

    cfg = support.program_config(mc)
    P = weights.make(support.param_shapes(cfg), seed, device)
    heun = ref_sampler.Heun(steps=int(mix.get("heun_steps") or mc["mcmc"]["num_steps"]))
    with ref_model.fp32_matmul():
        a, x = ref_sampler.sample(P, shape, heun, flags, draw, quant)
    return flags_np, tuple(t.cpu().numpy() for t in ref_sampler.decode(shape, a, x, flags))


def check(cell, seed: int, outs: list, device) -> dict:
    """Sample the seed's choice of the window's graphs with the reference
    and compare: {name: value}."""
    where = picked(cell, seed, len(outs))
    flags, ref = reference(cell, seed, where, device)
    prog = tuple(np.stack([outs[k][1][j][r] for k, r in where]) for j in range(3))
    return compare(flags, prog, ref)


def control(cell, seed: int, device, batches: int) -> dict:
    """The control: the reference in float8 in the program's place."""
    where = picked(cell, seed, batches)
    flags, ref = reference(cell, seed, where, device)
    _, low = reference(cell, seed, where, device, ref_model.fp8_quant)
    return compare(flags, low, ref)


def compare(flags, prog, ref) -> dict:
    adj_p, node_p, box_p = prog
    adj_r, node_r, box_r = ref
    pairs = flags[:, :, None] & flags[:, None, :] & ~np.eye(flags.shape[1], dtype=bool)
    gap = np.abs(box_p.astype(np.float64) - box_r)
    per_graph = [gap[g][flags[g]].mean() for g in range(len(flags))]
    pad = ((adj_p != 0) & ~pairs).sum() + ((node_p != 0) & ~flags).sum() \
        + ((box_p != 0) & ~flags[..., None]).sum()
    return {"box_gap": float(gap[flags].mean()),
            "box_gap_median": float(np.median(per_graph)),
            "worst_graph_box_gap": float(max(per_graph)),
            "node_type_mismatch": float((node_p != node_r)[flags].mean()),
            # how far the node types lie apart, in levels: bf16 moves a type
            # to its neighbour, a wrong level or a broken channel moves it far
            "node_level_gap": float(np.abs(node_p.astype(np.int64) - node_r)[flags].mean()),
            "edge_type_mismatch": float((adj_p != adj_r)[pairs].mean()),
            "padding_nonzero": float(pad)}
