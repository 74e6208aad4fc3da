"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``; its configuration, traffic mix,
limits and per-layer readers are files under ``benchmark/`` found by name
(``benchlib/cells.py``).  The run loads and warms up (set-up), measures for
``--seconds`` (``--trace 0``: the cell's end-to-end metrics) or profiles a
bounded sub-window (``--trace 1``: its per-layer metrics), checks what the
timed path produced against the plain reference, and prints one JSON line
as the last line of standard output; the numbers compared, each with its
limit, are the last lines of standard error and the line's last key.

A cell on several chips runs one process per card (this file with
``--rank``), joined over NCCL from torchrun's variables; rank 0 prints the
result.  Without a card, or with fewer than the cell asks for, the run
fails and prints no result; so does one whose process holds a module of
the JAX stack or of the JAX package.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]
# the program's own caches are fixed directories of the checkout
# (build/kernels, build/native); the CUDA driver's, should it compile any
# PTX, goes there too
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(ROOT, "build", "cuda_cache"))
os.environ.setdefault("USE_FLAX", "0")

from benchlib import cells, support  # noqa: E402

RUN_LIMIT_S = 1150  # a rank that runs longer is stopped


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def fail(msg: str, code: int = 2) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def card_count(chips: int):
    """The number of cards, or a reason that the run cannot measure."""
    import torch
    if not torch.cuda.is_available():
        return "no CUDA device: the benchmark measures the card and has no CPU fallback"
    if torch.cuda.device_count() < chips:
        return f"the cell asks for {chips} cards and {torch.cuda.device_count()} are visible"
    return None


def per_layer(cell, ctx: dict) -> dict:
    out = {}
    for m in cell.per_layer:
        read, data = cells.reader(m["name"])
        value = read(ctx, data)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell, res: dict, trace: bool, kind: str) -> dict:
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    if trace:
        metrics = per_layer(cell, res["ctx"])
    else:
        metrics = {k: {"value": v, "unit": units[k]} for k, v in res["e2e"].items() if k in units}
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": None, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if trace:
        ctx = res["ctx"]
        busy = ctx.get("busy_per_chip") or [ctx["trace"].busy_s]
        window = ctx.get("window_per_chip") or [ctx["window_s"]]
        device["busy_s"] = sum(busy) / len(busy)
        device["window_s"] = sum(window) / len(window)
        line["breakdown"] = {"device_ops": ctx["trace"].top_ops(10),
                             "idle_gaps": [[name, s] for s, name in ctx["trace"].gaps[:10]]}
    checks = {k: {"value": res["checks"][k], "limit": lim} for k, lim in cell.limits.items()}
    line["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    line["checks"] = checks
    return line


def measure(args, cell, world=None) -> int:
    import torch
    # one process a card with few threads: the host's cores are shared
    torch.set_num_threads(2)
    device = torch.device("cuda", torch.cuda.current_device())
    res = cell.driver().run(cell, args.seed, args.seconds, bool(args.trace), device,
                            args.t0 or T0, world)
    found = support.forbidden_modules()
    if found:
        return fail("the process holds modules of the JAX stack or package: " + ", ".join(found),
                    3)
    if world is not None and world.rank != 0:
        return 0
    line = result_line(cell, res, bool(args.trace), torch.cuda.get_device_name(device))
    rest = {k: v for k, v in res["checks"].items() if k not in cell.limits}
    if rest:
        print("not compared: " + json.dumps(rest), file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def spawn(args, cell) -> int:
    """One process per card; rank 0's result is this run's."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    argv = [sys.executable, os.path.abspath(__file__), "--workload", args.workload,
            "--seed", str(args.seed), "--seconds", str(args.seconds),
            "--trace", str(args.trace), "--t0", repr(T0)]
    try:
        for r in range(cell.chips):
            env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(r),
                       WORLD_SIZE=str(cell.chips), LOCAL_RANK=str(r))
            out = tempfile.TemporaryFile("w+")
            err = tempfile.TemporaryFile("w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(argv + ["--rank", str(r)], env=env, stdout=out,
                                          stderr=err))
        deadline = time.time() + RUN_LIMIT_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    texts = []
    for out, err in logs:
        out.seek(0)
        err.seek(0)
        texts.append((out.read(), err.read()))
        out.close()
        err.close()
    for r in range(1, len(texts)):
        sys.stderr.write(texts[r][0] + texts[r][1])
    sys.stderr.write(texts[0][1])
    sys.stderr.flush()
    if any(codes):
        return fail(f"rank exit codes {codes}", max(c if c > 0 else 1 for c in codes if c))
    found = support.forbidden_modules()
    if found:
        return fail("the process holds modules of the JAX stack or package: " + ", ".join(found),
                    3)
    sys.stdout.write(texts[0][0])
    sys.stdout.flush()
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    cell = cells.load(args.workload)
    why = card_count(cell.chips)
    if why:
        return fail(why)
    if cell.chips > 1 and args.rank is None:
        return spawn(args, cell)
    world = None
    if cell.chips > 1:
        from diffusesg_torch.parallel import distributed, mesh
        distributed.maybe_initialize_distributed("cuda")
        distributed.load_kernels()
        world = mesh.current_world()
    else:
        import torch
        torch.cuda.set_device(0)
        from diffusesg_torch.ops import cuda_build
        cuda_build.lib()
    return measure(args, cell, world)


if __name__ == "__main__":
    sys.exit(main())
