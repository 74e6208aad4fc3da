"""Driver of the training mixes: the inner loop of the program's trainer.

What ``train/trainer.py::go_training`` runs for an epoch, without its
epoch-end test pass, sampling, logs or checkpoints: ``data/loader.py``'s
``Batches`` over a pool of synthetic graphs (reshuffled each epoch, each
rank its strided shard) -> ``prefetch_to_device`` -> the compiled step
(``train/compiled.py::CompiledTrainStep``; on several cards the
``shard_map`` step of ``parallel/shardmap_dp.py`` over NCCL) with Adam and
the config's EMAs.  The draws come from ``KeyedNoise``, one stream per
rank, as the trainer folds its stream with the rank.

Set-up builds the kernels, the pool, the model and the state, and runs the
first five steps through the window's own call and feed.  Steps 0 and 1
are the first uses of the two self-conditioning variants, without and
with the pass: each runs eagerly once and is captured.  Steps 2 to 4
replay those graphs, as every step of the window does.  The window then
runs steps until ``seconds`` have passed (on several cards the ranks agree
at each step, on the host, whether to go on) and ends at a synchronise:
the rate is the global rows of all its steps over its seconds.

Correctness, once the window has closed and the program is freed: the
plain float32 reference (``reference/train.py``) runs step 0 from the
seed's weights (the start), and steps 2 (no pass) and 3 (the pass), both
replays, each from the program's own state before it: parameters, Adam's
moments and the EMA.  Two sides that both followed from the seed would
drift apart through Adam's early, sign-like moves (PERF.md), so a replay
is checked one step at a time.  The same rows, draws and coins go in.
Compared at each of those steps, leaf by leaf: each graph's loss, the
gradient as Adam got it (from its first moments, g_k = (m_k - beta1
m_{k-1}) / (1 - beta1)), and the step's change of the parameters and of
the fastest EMA.  The rows each rank read are held against the rows its
shard of the shuffled pool holds.
"""
from __future__ import annotations

import itertools
import sys
import time

import numpy as np
import torch

from benchlib import data, support, weights
from benchlib.noise import KeyedNoise, coin
from reference import model as ref_model
from reference import train as ref_train
from yardstick import flops as yflops

SETUP_STEPS = 5
# the set-up steps compared: step 0 from the seed's weights, then the first
# replays of the variant without the pass (coin false) and with it
COMPARED = (0, 2, 3)
# numbers read at step 0 alone as well (``<name>_start``): at the replays
# the global clip ties every leaf's gradient to the noise of the few small
# leaves that lead the norm, and no limit holds there (PERF.md)
START = ("grad_gap", "grad_gap_median")
# leaves whose reference gradient is below this share of the median leaf's
# move under Adam by round-off alone: their change is not compared
QUIET_LEAF = 1e-3


def _pool(mc, mix, seed):
    shape = ref_model.Shape.of(mc)
    graphs = mix["pool_batches"] * mix["batch"]
    return data.pool(seed, graphs, shape.n, shape.node_types, shape.edge_types, mix)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float, world=None) -> dict:
    from diffusesg_torch.data import Batches, SceneGraphData, pad_batch, prefetch_to_device
    from diffusesg_torch.parallel import mesh
    from diffusesg_torch.train import (create_train_state, make_optimizer, make_train_step,
                                       train_step_config_from)
    from diffusesg_torch.train.compiled import CompiledTrainStep

    mc, mix = cell.model_config, cell.traffic
    cfg = support.program_config(mc)
    shape = ref_model.Shape.of(mc)
    rank, ranks = (world.rank, world.size) if world is not None else (0, 1)
    rows = mix["batch"] // ranks
    adjs, nodes, flags = _pool(mc, mix, seed)
    pool = SceneGraphData(adjs=adjs, nodes=nodes, node_flags=flags,
                          image_ids=np.arange(len(adjs)), pkl_data=[],
                          num_node_type=shape.node_types, num_edge_type=shape.edge_types)
    loader_seed = seed % 2 ** 31
    batches = Batches(pool, rows, shuffle=True, seed=loader_seed, process_index=rank,
                      process_count=ranks)

    model = support.build_model(cfg, weights.make(support.param_shapes(cfg), seed, device),
                                device)
    step_cfg = train_step_config_from(cfg)
    spec = make_optimizer(cfg.train.lr_init, cfg.train.lr_dacey, len(batches),
                          cfg.train.weight_decay)
    state = create_train_state(model, list(cfg.train.ema_coef), spec)
    if world is None:
        step = CompiledTrainStep(make_train_step(model, step_cfg))
    else:
        from diffusesg_torch.parallel.shardmap_dp import make_shardmap_train_step
        mode = mesh.resolve_spmd_mode(cfg, ranks)
        if mode != "shard_map":
            raise SystemExit(f"the train driver runs the shard_map step; the config gives {mode}")
        step = make_shardmap_train_step(model, step_cfg, world)
    noise = KeyedNoise(seed, device, stream=rank, rank=rank, ranks=ranks, start=SETUP_STEPS)
    block = 2 ** ranks  # steps that hold every pattern of the ranks' coins once

    def feed():
        for epoch in itertools.count():
            batches.set_epoch(epoch)
            yield from prefetch_to_device(batches, device,
                                          transform=lambda it: pad_batch(it[:3], rows)[0])

    stream = feed()
    names = [n for n, _ in model.named_parameters()]

    def host(tensors):
        return dict(zip(names, (t.detach().to("cpu", copy=True) for t in tensors)))

    def adam(key):
        # no moment where Adam has not stepped: nought
        return host(state.opt.state.get(p, {}).get(key, torch.zeros_like(p))
                    for p in model.parameters())

    seen, losses = [], []
    snap = {"per_row": {}, "state": {}}
    for k in range(SETUP_STEPS):
        batch = next(stream)
        seen.append(tuple(t.cpu().numpy() for t in batch))
        state, metrics = step(state, noise, *batch)
        losses.append(metrics["loss"])
        if k in COMPARED:
            snap["per_row"][k] = (metrics["loss_adj_per_sample"]
                                  + metrics["loss_node_per_sample"]).cpu()
        if k in COMPARED or k + 1 in COMPARED:
            snap["state"][k] = {"P": host(model.parameters()), "m": adam("exp_avg"),
                                "v": adam("exp_avg_sq"), "ema": host(state.ema_params[0])}
    snap["losses"] = [float(v) for v in losses]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - t0
    support.check_guard("after set-up")

    agree = _agreement(world)
    window_losses, res = [], {}
    span = {"input_s": 0.0, "steps": []}

    def loop(limit_s=None, steps=None):
        nonlocal state
        start = time.perf_counter()
        done = 0
        while True:
            t_in = time.perf_counter()
            batch = next(stream)
            span["input_s"] += time.perf_counter() - t_in
            span["steps"].append(state.step)
            state, metrics = step(state, noise, *batch)
            window_losses.append(metrics["loss"])
            done += 1
            stop = done >= steps if steps is not None else \
                time.perf_counter() - start >= limit_s and done % block == 0
            if agree(stop):
                break
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - start

    if trace:
        summary, window_s, _ = support.profiled(lambda: loop(steps=mix["traced_steps"]))
        count = len(window_losses)
        f = yflops.forward_flops(mc)
        flop = sum((3 + coin(seed, s, r, ranks, SETUP_STEPS)) * f * rows
                   for s in span["steps"] for r in range(ranks))
        res["ctx"] = dict(trace=summary, window_s=window_s, shape=shape, rows=rows,
                          chips=ranks, train_steps=count, backward_passes=count,
                          forward_passes=sum(1 + coin(seed, s, rank, ranks, SETUP_STEPS)
                                             for s in span["steps"]),
                          input_s=span["input_s"], flop=flop)
    else:
        window_s = loop(limit_s=seconds)
        res["e2e"] = {"train_graphs_per_s": len(window_losses) * mix["batch"] / window_s,
                      "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    res["attempted"] = len(window_losses)
    res["failed"] = int((~torch.isfinite(torch.stack(window_losses))).sum()) \
        if window_losses else 0
    mismatch = _row_mismatch(seen, (adjs, nodes, flags), loader_seed, rank, ranks, rows)
    gathered = _gather(world, dict(peak=peak, mismatch=mismatch,
                                   busy=res.get("ctx", {}).get("trace").busy_s if trace else 0.0,
                                   window=window_s))
    res["memory_peak_bytes"] = max(g["peak"] for g in gathered)
    if trace:
        res["ctx"]["busy_per_chip"] = [g["busy"] for g in gathered]
        res["ctx"]["window_per_chip"] = [g["window"] for g in gathered]
    if "e2e" in res:
        res["e2e"]["peak_mem_gib"] = res["memory_peak_bytes"] / 2 ** 30
    del state, step, model, stream
    support.free_cuda()
    if world is not None:
        from diffusesg_torch.parallel import distributed
        distributed.shutdown()
    if rank != 0:
        return res
    res["checks"] = check(cell, seed, snap, device, ranks)
    res["checks"]["batch_rows_mismatch"] = float(sum(g["mismatch"] for g in gathered))
    return res


def _agreement(world):
    """stop -> whether every rank stops: on several ranks an all-reduce on
    the host (gloo), so that no rank enters a step the others skip."""
    if world is None:
        return lambda stop: stop
    import torch.distributed as dist
    group = dist.new_group(backend="gloo")

    def agree(stop: bool) -> bool:
        flag = torch.tensor([1 if stop else 0], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        return bool(flag.item())
    return agree


def _gather(world, item: dict) -> list:
    if world is None:
        return [item]
    import torch.distributed as dist
    out = [None] * world.size
    dist.all_gather_object(out, item)
    return out


def _row_mismatch(seen, pool, loader_seed, rank, ranks, rows) -> int:
    """Entries of the set-up batches that differ from the rows of this
    rank's shard of the shuffled pool."""
    bad = 0
    for k, got in enumerate(seen):
        sel = data.step_rows(len(pool[0]), loader_seed, k, rank, ranks, rows)
        for g, want in zip(got, pool):
            bad += int((g != want[sel]).sum())
    return bad


def _shards(cell, seed: int, device, ranks: int, k: int, pool, fault: str | None = None):
    """Step k's rows, draws and coin of every rank, as ``ref_train.grads``
    takes them; ``fault`` plants one of the faults the check must catch:
    ``half_batch`` (each rank's mean over the first half of its rows),
    ``no_exchange`` (rank 0's gradient alone, the all-reduce left out)."""
    shape = ref_model.Shape.of(cell.model_config)
    rows = cell.traffic["batch"] // ranks
    adjs, nodes, flags = pool
    shards = []
    for r in range(ranks):
        sel = data.step_rows(len(adjs), seed % 2 ** 31, k, r, ranks, rows)
        src = KeyedNoise(seed, device, stream=r, rank=r, ranks=ranks, start=SETUP_STEPS)
        t = lambda a: torch.from_numpy(a[sel]).to(device)  # noqa: E731
        draws = {"sigma": src.normal(k, "sigma", (rows,)),
                 "noise_adj": src.normal(k, "noise_adj", (rows, shape.n, shape.n)),
                 "noise_node": src.normal(k, "noise_node", (rows, shape.n, shape.node_chans))}
        shards.append((t(adjs), t(nodes), t(flags), draws, src.bernoulli(k, "self_cond", 0.5)))
    if fault == "half_batch":
        h = rows // 2
        shards = [(a[:h], x[:h], f[:h], {n: d[:h] for n, d in dr.items()}, c)
                  for a, x, f, dr, c in shards]
    elif fault == "no_exchange":
        shards = shards[:1]
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    return shards


def _ref_step(cell, k: int, before: dict, shards, device, quant=None) -> dict:
    """The reference's step k from the state ``before`` ({P, m, v, ema},
    on any device): {loss, per_row, grad (clipped), state (after)}."""
    mc = cell.model_config
    shape = ref_model.Shape.of(mc)
    on = {part: {n: v.to(device) for n, v in side.items()} for part, side in before.items()}
    adam = ref_train.Adam(on["P"], float(mc["train"]["lr_init"]))
    adam.m, adam.v, adam.t = on["m"], on["v"], k
    with ref_model.fp32_matmul():
        loss, g, per_row = ref_train.grads(on["P"], shape, shards, cell.traffic["check_block"],
                                           quant)
        g = ref_train.clip(g)
        P = adam.step(on["P"], g)
    w = ref_train.ema_weight(sorted(mc["train"]["ema_coef"])[0], k)
    ema = {n: e + w * (P[n] - e) for n, e in on["ema"].items()}
    return {"loss": loss, "per_row": per_row.cpu(), "grad": g,
            "state": {"P": P, "m": adam.m, "v": adam.v, "ema": ema}}


def _start(cell, seed: int, device) -> dict:
    """The state before step 0: the seed's weights, Adam's moments nought."""
    cfg = support.program_config(cell.model_config)
    P = dict(weights.make(support.param_shapes(cfg), seed, device))
    zero = {n: torch.zeros_like(v) for n, v in P.items()}
    return {"P": P, "m": zero, "v": dict(zero), "ema": dict(P)}


def reference_steps(cell, seed: int, device, ranks: int, quant=None, steps: int = SETUP_STEPS,
                    fault: str | None = None) -> dict:
    """The reference (``quant``: in lower precision; ``fault``: with that
    fault planted) in the program's place through the set-up steps, in the
    form of the program's record: {losses, per_row, state}."""
    pool = _pool(cell.model_config, cell.traffic, seed)
    cur = _start(cell, seed, device)
    out = {"losses": [], "per_row": {}, "state": {}}
    for k in range(steps):
        done = _ref_step(cell, k, cur, _shards(cell, seed, device, ranks, k, pool, fault), device,
                         quant)
        cur = done["state"]
        out["losses"].append(done["loss"])
        if k in COMPARED:
            out["per_row"][k] = done["per_row"]
        if k in COMPARED or k + 1 in COMPARED:
            out["state"][k] = {part: {n: v.cpu() for n, v in side.items()}
                               for part, side in cur.items()}
    return out


def check(cell, seed: int, prog: dict, device, ranks: int) -> dict:
    """Compare ``prog``, the record of the set-up steps ({losses, per_row,
    state}), with the reference's step at each of COMPARED, taken from the
    seed's weights (step 0) or from ``prog``'s state before it:
    {name: value}, each the worst over the steps, and those of START at
    step 0 alone."""
    pool = _pool(cell.model_config, cell.traffic, seed)
    rows = cell.traffic["batch"] // ranks
    # made on the device, as the program's weights were
    start = {part: {n: v.cpu() for n, v in side.items()}
             for part, side in _start(cell, seed, device).items()}
    b1 = ref_train.BETAS[0]
    nums, worst = {}, {}
    for k in COMPARED:
        before = start if k == 0 else prog["state"][k - 1]
        after = prog["state"][k]
        ref = _ref_step(cell, k, before, _shards(cell, seed, device, ranks, k, pool), device)
        got = {"grad": {n: (after["m"][n] - b1 * before["m"][n]) / (1 - b1) for n in after["m"]},
               "per_row": prog["per_row"][k], "loss": prog["losses"][k]}
        step_nums, leaves = compare(got, before, after, ref, rows)
        if k == 0:
            nums.update({f"{name}_start": step_nums[name] for name in START})
        for name, v in step_nums.items():
            if v >= nums.get(name, -1.0):
                nums[name] = v
                worst[name] = (k, leaves.get(name))
        support.free_cuda()
    print("train check: losses program %s; worst (step, leaf) %s" % (prog["losses"], worst),
          file=sys.stderr, flush=True)
    return nums


def control(cell, seed: int, device, ranks: int, fault: str | None = None) -> dict:
    """The control: the reference in float8 in the program's place; or,
    with ``fault``, the float32 reference with that fault planted."""
    quant = ref_model.fp8_quant if fault is None else None
    return check(cell, seed, reference_steps(cell, seed, device, ranks, quant, fault=fault),
                 device, ranks)


def compare(got: dict, before: dict, after: dict, ref: dict, rows: int):
    """One step's numbers: (name -> value, name -> worst leaf).  ``got``
    holds the program's gradient, graph losses and loss of the step;
    ``before`` and ``after`` its state around it; ``ref`` the reference's
    step from ``before``."""
    grad = {n: v.cpu() for n, v in ref["grad"].items()}
    rms = sorted(float(v.double().pow(2).mean().sqrt()) for v in grad.values())
    floor = QUIET_LEAF * rms[len(rms) // 2]
    # elements whose reference gradient is nought to rounding (a key's bias
    # under softmax) move under Adam by round-off alone: left out of the changes
    keep = {n: v.abs() >= floor for n, v in grad.items()}
    moving = [n for n, m in keep.items() if bool(m.any())]
    ref_after = {part: {n: v.cpu() for n, v in side.items()} for part, side in ref["state"].items()}

    def delta(end, part):
        return {n: (end[part][n] - before[part][n])[keep[n]] for n in moving}
    d_prog, d_ref = delta(after, "P"), delta(ref_after, "P")
    e_prog, e_ref = delta(after, "ema"), delta(ref_after, "ema")
    # each graph's loss that rank 0 holds, one by one; a graph the program
    # did not report counts its whole loss
    want = ref["per_row"][:rows]
    have = got["per_row"][:len(want)]
    graph_gap = (float((have - want[:len(have)]).abs().sum() + want[len(have):].abs().sum())
                 / len(want) / float(want.abs().mean()))
    grad_gap = support.leaf_gap(got["grad"], grad)
    change_gap = support.leaf_gap(d_prog, d_ref)
    ema_gap = support.leaf_gap(e_prog, e_ref)
    nums = {"loss_gap": abs(got["loss"] - ref["loss"]) / float(ref["per_row"].abs().mean()),
            "graph_loss_gap": graph_gap,
            "grad_gap": grad_gap[0], "grad_gap_median": support.median_leaf_gap(got["grad"], grad),
            "change_gap": change_gap[0],
            "change_gap_median": support.median_leaf_gap(d_prog, d_ref),
            "ema_gap": ema_gap[0], "ema_gap_median": support.median_leaf_gap(e_prog, e_ref)}
    return nums, {"grad_gap": grad_gap[1], "change_gap": change_gap[1], "ema_gap": ema_gap[1]}
