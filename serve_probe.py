"""Serving across cards in one process, timed: graphs/s of one batch on one
card against the same batch split into row blocks.

    python3 serve_probe.py [--batches 16 64 256] [--steps 16] [--reps 2]

Needs one H100 or more.  It builds the kernels (``ops/cuda_build.py``),
serves the full-width VG model (``configs/edm_diffuse_sg_regular_visual_genome.yaml``,
kernels on, bf16, random weights from seed 0) at each batch size and prints,
for each way of running the batch, its graphs/s host to host (16 Heun steps
by default, decoded), each way run ``--reps`` times in turns there and back:

- ``one_card``: one batch on card 0 (``serving.export.fixed_batch``);
- ``halves_in_turn``: two half batches on card 0, one after the other, in
  one thread;
- ``halves_in_threads``: the same two halves in two threads at once, each
  on a stream of its own;
- ``sharded_1x2``: ``make_sharded_serving_fn`` (``gspmd``) over card 0 listed
  twice: one thread steps both halves' samplers in turn;
- ``sharded_K``: the same over cards 0 .. K-1, for K = 2, 4, ... up to the
  cards the process sees.

Each ``sharded_K`` run is checked first: each row block is bit-equal to the
single-device core on card 0 on those rows with the same draws, which also
launches every forward kernel on each card (their shared-memory opt-in is
per card).  The script exits 1 when a block differs.  The last line holds
every reading as one JSON object, after the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

VG_CONFIG = "configs/edm_diffuse_sg_regular_visual_genome.yaml"
SEED = 5


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def flags_of(batch: int, n: int) -> np.ndarray:
    """Four full graphs, the rest of 5 to n nodes (chip_smoke's phase 11)."""
    rng = np.random.default_rng(3)
    counts = [n] * 4 + [int(c) for c in rng.integers(5, n + 1, batch - 4)]
    flags = np.zeros((batch, n), bool)
    for i, c in enumerate(counts):
        flags[i, :c] = True
    return flags


def in_threads(fns):
    """Call every function of ``fns`` in a thread of its own; their results."""
    out = [None] * len(fns)

    def run(i):
        out[i] = fns[i]()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[16, 64, 256])
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_probe: no CUDA device", file=sys.stderr)
        return 2

    from diffusesg_torch.config import load_config
    from diffusesg_torch.models import build_model
    from diffusesg_torch.ops import cuda_build
    from diffusesg_torch.parallel.mesh import World
    from diffusesg_torch.parallel.sharded_step import GlobalRows
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.serving.export import (fixed_batch, make_serving_fn,
                                                make_sharded_serving_fn)

    smi = smi_line()
    cuda_build.build()
    cards = torch.cuda.device_count()
    dev = torch.device("cuda", 0)
    cfg = load_config(VG_CONFIG)
    with cfg.unlocked():
        cfg.mcmc.num_steps = args.steps
    model = build_model(cfg, device=dev, seed=0).eval()
    sampler = get_mc_sampler(cfg)
    n = int(cfg.dataset.max_node_num)
    core = make_serving_fn(model, sampler, cfg)
    counts = [k for k in (2, 4, 8) if k <= cards]
    readings = {"device": smi, "cards": cards, "steps": args.steps, "graphs_per_s": {}}
    ok = True
    for batch in args.batches:
        flags = flags_of(batch, n)
        half = batch // 2
        whole = fixed_batch(core, batch, n, dev)
        halves = fixed_batch(core, half, n, dev)
        streams = [torch.cuda.Stream(dev) for _ in range(2)]

        def half_on(i):
            def run():
                with torch.cuda.stream(streams[i]):
                    return halves(SEED, flags[i * half:(i + 1) * half])
            return run
        runs = {"one_card": lambda: whole(SEED, flags),
                "halves_in_turn": lambda: [half_on(i)() for i in range(2)],
                "halves_in_threads": lambda: in_threads([half_on(0), half_on(1)]),
                "sharded_1x2": lambda f=make_sharded_serving_fn(
                    model, sampler, cfg, [dev, dev]): f(SEED, flags)}
        for k in counts:
            fn = make_sharded_serving_fn(model, sampler, cfg,
                                         [torch.device("cuda", i) for i in range(k)])
            got = fn(SEED, flags)
            per = batch // k
            part = fixed_batch(core, per, n, dev)
            for i in range(k):
                want = part(SEED, flags[i * per:(i + 1) * per],
                            noise=GlobalRows(TorchNoise(SEED, dev), World(i, k, dev)))
                same = all(np.array_equal(g[i * per:(i + 1) * per], w)
                           for g, w in zip(got, want))
                print(f"batch {batch}: sharded over {k} cards, block {i} (cuda:{i}) bit-equal "
                      f"to the core on cuda:0 on its rows: {same}", flush=True)
                ok &= same
            runs[f"sharded_{k}"] = lambda f=fn: f(SEED, flags)
        for fn in runs.values():  # warm-up: the allocator and each card's first launches
            fn()
        secs = {name: [] for name in runs}
        for _ in range(args.reps):
            for name in list(runs) + list(runs)[::-1]:
                for d in range(cards):
                    torch.cuda.synchronize(d)
                t0 = time.perf_counter()
                runs[name]()
                for d in range(cards):
                    torch.cuda.synchronize(d)
                secs[name].append(time.perf_counter() - t0)
        gps = {name: [round(batch / s, 3) for s in v] for name, v in secs.items()}
        readings["graphs_per_s"][str(batch)] = gps
        print(f"batch {batch}: graphs/s " + ", ".join(
            f"{k} {' / '.join(str(x) for x in v)}" for k, v in gps.items()), flush=True)
    print(smi)
    print(json.dumps(readings))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
