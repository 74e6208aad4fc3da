"""What the drivers share: the program's configuration and model from the
cell's data, the traced sub-window, the guard against the JAX package, and
the comparison of norms leaf by leaf."""
from __future__ import annotations

import gc
import os
import sys
import tempfile
import time

import torch

# top-level module names that no process of the benchmark may hold: the
# JAX stack and the JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "diffusesg_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is forbidden (compared whole)."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


def check_guard(where: str) -> None:
    """Stop the run, printing no result, if a forbidden module is loaded."""
    found = forbidden_modules()
    if found:
        print(f"benchmark: {where}, the process holds " + ", ".join(found), file=sys.stderr)
        raise SystemExit(3)


def program_config(model_config: dict):
    """The program's ConfigDict of ``model_config``, as its loader makes it."""
    from diffusesg_torch.config import ConfigDict
    cfg = ConfigDict(model_config).lock()
    with cfg.unlocked():
        cfg.flag_sg = any(k in cfg.dataset.name for k in ("visual_genome", "coco_stuff"))
    return cfg


def param_shapes(cfg) -> dict:
    """name -> shape of the program's model for ``cfg`` (built on the meta
    device: nothing is allocated or initialised)."""
    from diffusesg_torch.models import make_model
    with torch.device("meta"):
        model = make_model(cfg)
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def build_model(cfg, weights: dict, device):
    """The program's model for ``cfg`` on ``device`` holding ``weights``
    (its constructor's own initialisation runs on the device, then is
    overwritten)."""
    from diffusesg_torch.models import make_model
    with torch.device(device):
        model = make_model(cfg)
    model = model.to(device)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    return model


def free_cuda() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def profiled(fn):
    """Run ``fn`` under torch.profiler (host and device) and reduce the
    trace: (Summary, window seconds by the host clock to a synchronise,
    fn's result).  The trace is written under TMPDIR and deleted."""
    from torch.profiler import ProfilerActivity, profile

    from yardstick import trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        summary = trace.summarize(trace.load(path))
    finally:
        os.remove(path)
    return summary, window, out


def _leaf_gaps(prog: dict, ref: dict) -> dict:
    """Per leaf |‖prog‖ - ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖)."""
    rn = {k: float(ref[k].double().norm()) for k in ref}
    pn = {k: float(prog[k].double().norm()) for k in ref}
    med = sorted(rn.values())[len(rn) // 2]
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in ref}


def leaf_gap(prog: dict, ref: dict) -> tuple[float, str]:
    """The worst leaf's gap of norms: (gap, leaf)."""
    gaps = _leaf_gaps(prog, ref)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def median_leaf_gap(prog: dict, ref: dict) -> float:
    """The median over the leaves of their gaps of norms."""
    gaps = sorted(_leaf_gaps(prog, ref).values())
    return gaps[len(gaps) // 2]
