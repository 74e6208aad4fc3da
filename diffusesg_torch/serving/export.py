"""The serving core, its numpy contract, serving across devices, the
sampler artifact and the compiled sampler's cache.

Counterpart of diffusesg_tpu/serving/export.py.  The core is end to end,
sampling and decode:

    (seed, node_flags[B, N]) -> (adj_types int32[B, N, N], node_types int32[B, N],
                                 bboxes float32[B, N, 4])

decoded integer scene graphs with [0, 1] cxcywh boxes (the decode of
``sampling/decode.py``); padded slots decode to zeros.  ``make_serving_fn``
and ``make_completion_fn`` return it on tensors (``serving/generate.py``
and the tests call those); ``fixed_batch`` binds either to one batch size,
device and numpy in and out, the contract ``serving/server.py`` calls, as
the JAX package's compiled program is bound to one batch.  The cores run
the compiled sampler (``sampling/compiled.py``, the counterpart of the JAX
package's ``jax.jit``): on a card every sampler step is a replay of a
captured CUDA graph; ``compiled=False`` runs the eager sampler.

``make_sharded_serving_fn`` / ``make_sharded_completion_fn`` serve one batch
across several devices of this process: a replica of the model on each, the
batch split into contiguous row blocks in device order (``P("data")``), each
block through the single-device core on its device, one thread stepping
every block's sampler in turn, the blocks joined in row order.  They return
``fixed_batch``'s numpy contract.
``spmd_mode`` keeps the JAX package's two semantics: ``gspmd``, each block's
draws are its rows of the whole batch's (the single-device function over
the whole batch); ``shard_map``, block i draws from the seed's stream folded
with i.

The artifact is a directory: ``sampler.pt`` (the served weights, the chosen
EMA in the model's dtype, and the resolved config) and ``meta.json`` (the JAX
artifact's keys, ``format`` ``diffusesg_torch.serving/1``).  It differs from
the JAX artifact: that one is a compiled program (``jax.export``) that runs
without the model code; this one carries weights and config, not a program,
because the kernels launch through ctypes and no torch serialization carries
them.  The serving host therefore needs ``diffusesg_torch`` installed, and
``load_artifact`` rebuilds the model and the sampler from the config; an
artifact over N > 1 devices (``num_devices``, ``spmd_mode``) is served by the
sharded function on N devices.

Each batch through ``fixed_batch`` is one ``serve.call`` span
(utils/tracing.py) of its own ``batch`` group, holding ``serve.copy_in``,
the sampler's ``sampler.step`` spans, ``serve.decode``, ``serve.wait``
(traced only: the stream synchronised before the copy back, so that the
wait for the card and the copy lie apart) and ``serve.copy_back``.

``save_compiled`` / ``load_compiled`` (export.py:352-400) persist the
serving core bound to one batch with its sampler compiled.  A CUDA graph
cannot be serialized, so ``save_compiled`` writes the artifact of
``export_sampler`` (what rebuilds the program: weights, config, batch and
flag shapes, devices, ``spmd_mode``) and ``compiled.json``, the caller's
``meta`` and the kernel library's source hash, nvcc release and
architecture; beside it ``kernels/`` holds a copy of the built library.
``load_compiled`` refuses a library whose hash is not the tree's sources',
installs it where the build looks (so no ``nvcc`` runs), loads the artifact
and warms it up, which captures the graphs.
"""
from __future__ import annotations

import contextlib
import copy
import itertools
import json
import os
import shutil
from functools import partial

import numpy as np
import torch

from ..models.channels import resolve_sampling_channels
from ..models.precond import precond_forward
from ..ops.attribute_code import attribute_converter
from ..sampling.compiled import CompiledSampler
from ..sampling.decode import decode_samples
from ..sampling.edm_sampler import NodeAdjEDMSampler, TorchNoise, run_steps
from ..utils import tracing
from ..utils.device import resolve_device

ARTIFACT_WEIGHTS = "sampler.pt"
ARTIFACT_META = "meta.json"
ARTIFACT_FORMAT = "diffusesg_torch.serving/1"
COMPILED_META = "compiled.json"
COMPILED_LIB = os.path.join("kernels", "libdsg_kernels.so")
# the id of each batch through fixed_batch, its spans' group
_BATCHES = itertools.count()


def make_denoiser(model, config, node_flags):
    """The preconditioned model (adjs, nodes, sigmas, sc_a, sc_x) -> (D_a, D_x)."""
    precond = config.mcmc.get("precond", "edm")

    def denoiser(a, x, sigmas, sc_a, sc_x):
        return precond_forward(model, precond, a, x, node_flags, sigmas, sc_a, sc_x)
    return denoiser


def _decoder(config, what: str):
    info = resolve_sampling_channels(config)
    if info["flag_node_only"]:
        raise NotImplementedError(f"{what} supports the joint node+edge+bbox configs; "
                                  "node_only ablation models are eval-only")
    n_edge_type = info["raw_num_adj_type"] if not info["flag_binary_edge"] else 2
    decode = partial(
        decode_samples, node_encoding=config.train.node_encoding,
        edge_encoding=config.train.edge_encoding, num_node_type=info["raw_num_node_type"],
        num_adj_type=n_edge_type, flag_bbox=True, flag_node_only=False)
    return info, n_edge_type, decode


def _serving_steps(model, sampler: NodeAdjEDMSampler, config, chunk_steps: int | None = None,
                   compiled: bool = True):
    """The serving core as a generator of sampler steps (``sample_steps``)
    that returns (adj_types, node_types, bboxes)."""
    info, _, decode = _decoder(config, "serving")
    runner, denoiser_for = CompiledSampler(sampler, compiled), partial(make_denoiser, model, config)

    def steps(seed: int, node_flags: torch.Tensor, noise=None):
        adjs, nodes = yield from runner.sample_steps(
            denoiser_for, node_flags, info["num_node_chan"], info["num_adj_chan"], noise=noise,
            seed=seed, chunk_steps=chunk_steps)
        with tracing.span("serve.decode"):
            dec = decode(adjs, nodes, node_flags)
        return dec.adj_types, dec.node_types, dec.bboxes
    return steps


def _completion_steps(model, sampler: NodeAdjEDMSampler, config, compiled: bool = True):
    """The completion core (``make_completion_fn``) as a generator of
    sampler steps."""
    info, n_edge_type, decode = _decoder(config, "completion serving")
    runner, denoiser_for = CompiledSampler(sampler, compiled), partial(make_denoiser, model, config)
    node_enc, edge_enc = config.train.node_encoding, config.train.edge_encoding
    n_node_type = info["raw_num_node_type"]

    def steps(seed: int, node_flags, known_node, mask_node, known_bbox, mask_bbox,
              known_adj, mask_adj, noise=None):
        x = attribute_converter(known_node.float(), node_flags, "int", node_enc, n_node_type,
                                flag_nodes=True, flag_in_ddpm_range=False,
                                flag_out_ddpm_range=True)
        if x.ndim == 2:  # ddpm encodes channel-less; bits / one_hot carry C
            x = x[..., None]
        gt_x = torch.cat([x, (known_bbox.float() - 0.5) * 2.0], dim=-1)
        gt_a = attribute_converter(known_adj.float(), node_flags, "int", edge_enc,
                                   n_edge_type, flag_adjs=True, flag_in_ddpm_range=False,
                                   flag_out_ddpm_range=True)
        type_chan = gt_x.shape[-1] - 4
        m_x = torch.cat([mask_node[..., None].expand(*mask_node.shape, type_chan),
                         mask_bbox[..., None].expand(*mask_bbox.shape, 4)], dim=-1)
        inpaint = {"gt_adjs": gt_a, "gt_nodes": gt_x, "mask_adjs": mask_adj,
                   "mask_nodes": m_x}
        adjs, nodes = yield from runner.sample_steps(
            denoiser_for, node_flags, info["num_node_chan"], info["num_adj_chan"], noise=noise,
            seed=seed, inpaint=inpaint)
        dec = decode(adjs, nodes, node_flags)
        return dec.adj_types, dec.node_types, dec.bboxes
    return steps


def _run(steps):
    """Run a core's generator of steps to its end."""
    # inference mode is thread-local: entered here, so a serving worker
    # thread runs the model under it too
    with torch.inference_mode():
        return run_steps(steps)


def make_serving_fn(model, sampler: NodeAdjEDMSampler, config, chunk_steps: int | None = None,
                    compiled: bool = True):
    """(seed, node_flags, noise=None) -> (adj_types, node_types, bboxes) on
    the flags' device.  ``noise`` replaces the default ``TorchNoise(seed)``;
    ``chunk_steps`` is the sampler's (bit-equal output).  On a card the
    sampler runs compiled (CUDA graph replays) unless ``compiled=False``;
    the output is the same bit for bit."""
    steps = _serving_steps(model, sampler, config, chunk_steps, compiled)

    def serve(seed: int, node_flags: torch.Tensor, noise=None):
        return _run(steps(seed, node_flags, noise=noise))
    return serve


def make_completion_fn(model, sampler: NodeAdjEDMSampler, config, compiled: bool = True):
    """Conditional completion over the serving surface (export.py:136-220).

    Known parts arrive in user space (integer types, [0, 1] cxcywh boxes),
    are encoded as the dataset pipeline encodes them and held through the
    reverse diffusion by the sampler's ``inpaint``, so they come back
    verbatim.  The returned function is

        (seed, node_flags[B, N], known_node int[B, N], mask_node bool[B, N],
         known_bbox float[B, N, 4], mask_bbox bool[B, N],
         known_adj int[B, N, N], mask_adj bool[B, N, N], noise=None)
          -> (adj_types, node_types, bboxes)

    Node-type and box knowledge are masked independently (a per-channel
    node mask).  ``compiled`` as in ``make_serving_fn``."""
    steps = _completion_steps(model, sampler, config, compiled)

    def complete(seed: int, node_flags, known_node, mask_node, known_bbox, mask_bbox,
                 known_adj, mask_adj, noise=None):
        return _run(steps(seed, node_flags, known_node, mask_node, known_bbox, mask_bbox,
                          known_adj, mask_adj, noise=noise))
    return complete


_ARG_DTYPES = (torch.bool, torch.int32, torch.bool, torch.float32, torch.bool, torch.int32,
               torch.bool)


def _to_device(arrays, device):
    """The numpy batch arguments as tensors of the contract's dtypes on
    ``device``."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)
            for a, dt in zip(arrays, _ARG_DTYPES)]


def _to_numpy(out):
    adj, node, bbox = out
    return (adj.to(torch.int32).cpu().numpy(), node.to(torch.int32).cpu().numpy(),
            bbox.float().cpu().numpy())


def fixed_batch(fn, batch_size: int, max_node_num: int, device):
    """Bind a core of ``make_serving_fn`` / ``make_completion_fn`` to one
    batch size and device, numpy in and out: ``(seed, node_flags bool[B, N])``
    or the 8-argument completion form -> numpy (adj int32[B, N, N],
    node int32[B, N], bbox float32[B, N, 4]).  Flags of another batch or
    width raise ``ValueError``, as the JAX package's compiled program does."""
    dev = torch.device(device)

    def call(seed, node_flags, *known, noise=None):
        flags = np.asarray(node_flags)
        if flags.shape != (batch_size, max_node_num):
            raise ValueError(f"this sampler serves node flags of shape "
                             f"({batch_size}, {max_node_num}), got {flags.shape}")
        with tracing.span("serve.call", batch=next(_BATCHES)):
            with tracing.span("serve.copy_in"):
                args = _to_device((flags, *known), dev)
            out = fn(int(seed), *args, noise=noise)
            if dev.type == "cuda" and tracing.enabled():
                # traced only: the wait for the card apart from the copy back
                with tracing.span("serve.wait"):
                    torch.cuda.current_stream(dev).synchronize()
            with tracing.span("serve.copy_back"):
                return _to_numpy(out)
    return call


class _SharedDraws:
    """The whole batch's draws for the shards of one ``gspmd`` call: each
    made once from ``noise``, when the first shard asks for it (shard 0,
    which steps first, so in the sampler's order and the stream is the
    single-device function's), and dropped once every shard has taken it.
    A draw on a card is made on the stream of the shard that asks first;
    an event recorded there orders the other shards' reads after it."""

    def __init__(self, noise, shards: int):
        self.noise, self.shards = noise, shards
        self.cache: dict = {}

    def take(self, method: str, step, kind, arg):
        key = (method, step, kind)
        entry = self.cache.get(key)
        if entry is None:
            value = getattr(self.noise, method)(step, kind, arg)
            ready = None
            if isinstance(value, torch.Tensor) and value.is_cuda:
                ready = torch.cuda.current_stream(value.device).record_event()
            entry = self.cache[key] = [value, ready, 0]
        entry[2] += 1
        if entry[2] == self.shards:
            del self.cache[key]
        return entry[0], entry[1]


class _DrawsOn:
    """The shared draws as one shard's device and stream see them."""

    def __init__(self, shared: _SharedDraws, device: torch.device):
        self.shared, self.device = shared, device

    def _tensor(self, method, step, kind, shape):
        value, ready = self.shared.take(method, step, kind, tuple(shape))
        if ready is not None:
            # this shard's stream on the draw's card waits for the draw, and
            # the allocator keeps its memory until this stream is done with it
            stream = torch.cuda.current_stream(value.device)
            stream.wait_event(ready)
            value.record_stream(stream)
        return value.to(self.device)

    def normal(self, step, kind, shape):
        return self._tensor("normal", step, kind, shape)

    def uniform(self, step, kind, shape):
        return self._tensor("uniform", step, kind, shape)

    def bernoulli(self, step, kind, p):
        return self.shared.take("bernoulli", step, kind, p)[0]


def _shard_noise(spmd_mode: str, noise, seed: int, devices, index: int):
    """The draws of shard ``index`` of ``len(devices)``: under ``gspmd`` its
    rows of the whole batch's draws (``noise`` a ``_SharedDraws``), under
    ``shard_map`` ``noise`` (default ``TorchNoise(seed)`` on its device)
    folded with ``index`` (export.py:114-120)."""
    from ..parallel.mesh import GlobalRows, World
    dev = torch.device(devices[index])
    if spmd_mode == "gspmd":
        return GlobalRows(_DrawsOn(noise, dev), World(rank=index, size=len(devices), device=dev))
    return (noise if noise is not None else TorchNoise(seed, dev)).fold_in(index)


def _devices(devices) -> list[torch.device]:
    """``devices`` as torch devices, a card without an index as the
    current one."""
    out = [torch.device(d) for d in devices]
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in out]


def _on(device: torch.device, stream):
    """Make ``device`` and ``stream`` current (nothing on the CPU)."""
    ctx = contextlib.ExitStack()
    if device.type == "cuda":
        ctx.enter_context(torch.cuda.device(device))
        ctx.enter_context(torch.cuda.stream(stream))
    return ctx


def _sharded(cores, devices, batch_args: int, spmd_mode: str):
    """The numpy contract of ``cores`` (one core of steps per device, on
    that device's replica) over the batch split across ``devices``.  One
    thread advances every shard a sampler step in turn, each on its device
    and on a stream of its own: the launches are asynchronous, so the cards
    work at once, and no second thread contends for the interpreter lock."""
    if spmd_mode not in ("gspmd", "shard_map"):
        raise ValueError(f"unknown spmd_mode {spmd_mode!r}")
    devices = _devices(devices)
    n = len(devices)
    streams = [torch.cuda.Stream(d) if d.type == "cuda" else None for d in devices]

    def call(seed, node_flags, *known, noise=None):
        flags = np.asarray(node_flags)
        batch = flags.shape[0]
        if batch % n:
            raise ValueError(f"a batch of {batch} does not split over {n} devices")
        if len(known) != batch_args - 1:
            raise TypeError(f"expected {batch_args} batch arguments, got {1 + len(known)}")
        per = batch // n
        base = noise
        if spmd_mode == "gspmd":
            base = _SharedDraws(noise if noise is not None else TorchNoise(seed, devices[0]), n)
        arrays = [flags, *(np.asarray(a) for a in known)]
        runs, outs = [], [None] * n
        with torch.inference_mode():
            for i, dev in enumerate(devices):
                with _on(dev, streams[i]):
                    rows = _to_device([a[i * per:(i + 1) * per] for a in arrays], dev)
                runs.append(cores[i](int(seed), *rows,
                                     noise=_shard_noise(spmd_mode, base, int(seed), devices, i)))
            pending = list(range(n))
            while pending:
                for i in list(pending):
                    with _on(devices[i], streams[i]):
                        try:
                            next(runs[i])
                        except StopIteration as done:
                            outs[i] = done.value
                            pending.remove(i)
            parts = []
            for i, out in enumerate(outs):
                with _on(devices[i], streams[i]):
                    parts.append(_to_numpy(out))
        return tuple(np.concatenate([p[k] for p in parts]) for k in range(3))
    return call


def _replicas(model, devices):
    """One copy of ``model`` per distinct device of ``devices`` (``model``
    itself where it already lies), in the order of ``devices``."""
    home = next(model.parameters()).device
    devices = _devices(devices)
    copies = {}
    for d in devices:
        if d not in copies:
            copies[d] = model if d == home else copy.deepcopy(model).to(d)
    return [copies[d] for d in devices]


def make_sharded_serving_fn(model, sampler: NodeAdjEDMSampler, config, devices,
                            spmd_mode: str = "gspmd", compiled: bool = True):
    """Serving across ``devices`` (export.py:93-133): ``(seed, node_flags
    bool[B, N], noise=None)`` -> numpy (adj, node, bbox), B a multiple of
    ``len(devices)``; a replica of ``model`` on each device.  ``gspmd``
    equals the single-device function over the whole batch (``noise`` its
    draws, default ``TorchNoise(seed)`` on the first device); ``shard_map``
    runs block i on ``noise.fold_in(i)`` (default ``TorchNoise(seed)`` on its
    device).  A device may be listed twice: its blocks share its replica."""
    cores = [_serving_steps(m, sampler, config, compiled=compiled)
             for m in _replicas(model, devices)]
    return _sharded(cores, devices, 1, spmd_mode)


def make_sharded_completion_fn(model, sampler: NodeAdjEDMSampler, config, devices,
                               spmd_mode: str = "gspmd"):
    """Completion across ``devices`` (export.py:223-254), as
    ``make_sharded_serving_fn``: the 8-argument form of ``fixed_batch``
    (every tensor argument batch-major)."""
    cores = [_completion_steps(m, sampler, config) for m in _replicas(model, devices)]
    return _sharded(cores, devices, 7, spmd_mode)


def _aval(dtype: str, shape) -> str:
    return f"{dtype}[{','.join(str(int(d)) for d in shape)}]"


def export_sampler(model, sampler: NodeAdjEDMSampler, config, batch_size: int,
                   num_devices: int = 1, spmd_mode: str = "gspmd") -> dict:
    """The artifact's contents at a fixed batch size: the model's weights
    (whatever weights it holds: load the chosen EMA first), the resolved
    config, the platform the model sits on and the contract's shapes.  The
    artifact rebuilds its sampler from the config, so ``sampler`` must be
    the one ``get_mc_sampler(config)`` gives.  ``num_devices`` > 1 makes an
    artifact served across that many devices in ``spmd_mode``
    (export.py:257-275); the batch must split over them."""
    from ..sampling import get_mc_sampler

    if get_mc_sampler(config) != sampler:
        raise ValueError("the artifact rebuilds its sampler from the config, and this "
                         "sampler differs from the config's")
    if num_devices > 1 and batch_size % num_devices:
        raise ValueError(f"batch_size {batch_size} must divide over the {num_devices} devices")
    n = int(config.dataset.max_node_num)
    return {
        "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "config": config.to_dict(),
        "platforms": [next(model.parameters()).device.type],
        "num_devices": int(num_devices),
        "spmd_mode": spmd_mode,
        "batch_size": int(batch_size),
        "in_avals": [_aval("int32", ()), _aval("bool", (batch_size, n))],
        "out_avals": [_aval("int32", (batch_size, n, n)), _aval("int32", (batch_size, n)),
                      _aval("float32", (batch_size, n, 4))],
    }


def save_artifact(path: str, exported: dict, config, batch_size: int) -> None:
    """Write ``sampler.pt`` (weights, config and ``spmd_mode``) and
``meta.json`` (the JAX artifact's keys) to ``path``/."""
    os.makedirs(path, exist_ok=True)
    torch.save({"state_dict": exported["state_dict"], "config": exported["config"],
                "spmd_mode": exported.get("spmd_mode", "gspmd")},
               os.path.join(path, ARTIFACT_WEIGHTS))
    meta = {
        "format": ARTIFACT_FORMAT,
        "platforms": list(exported["platforms"]),
        "num_devices": int(exported["num_devices"]),
        "batch_size": batch_size,
        "max_node_num": int(config.dataset.max_node_num),
        "dataset": config.dataset.name,
        "node_encoding": config.train.node_encoding,
        "edge_encoding": config.train.edge_encoding,
        "num_steps": int(config.mcmc.num_steps),
        "in_avals": list(exported["in_avals"]),
        "out_avals": list(exported["out_avals"]),
    }
    with open(os.path.join(path, ARTIFACT_META), "w") as f:
        json.dump(meta, f, indent=2)


def load_artifact(path: str, device: str | torch.device = "cuda", devices=None):
    """Load an artifact -> (callable, meta): the numpy contract
    ``(seed, node_flags bool[B, N]) -> (adj, node, bbox)`` at the artifact's
    batch, on ``device`` (``cuda`` unless the caller asks for the CPU).
    Raises when the artifact was exported for another platform or for more
    devices than this process sees (export.py:313-330).  An artifact over N
    > 1 devices is served across the first N of ``devices`` (default: the
    process's cards, or the one CPU)."""
    from ..config import ConfigDict
    from ..models import make_model
    from ..sampling import get_mc_sampler

    dev = resolve_device(device)
    with open(os.path.join(path, ARTIFACT_META)) as f:
        meta = json.load(f)
    platforms = [p.lower() for p in meta.get("platforms", [])]
    if dev.type not in platforms:
        raise RuntimeError(f"serving artifact at {path} was exported for platforms "
                           f"{meta.get('platforms')} but this process runs on '{dev.type}'; "
                           "re-export on the target platform")
    ndev = int(meta.get("num_devices", 1))
    visible = list(devices) if devices is not None else local_devices(dev)
    if ndev > len(visible):
        raise RuntimeError(f"serving artifact at {path} spans {ndev} devices but this "
                           f"process has {len(visible)}; re-export for {len(visible)}")
    blob = torch.load(os.path.join(path, ARTIFACT_WEIGHTS), map_location="cpu",
                      weights_only=True)
    config = ConfigDict(blob["config"]).lock()
    model = make_model(config)
    model.load_state_dict(blob["state_dict"], strict=True)
    batch, n = int(meta["batch_size"]), int(meta["max_node_num"])
    if ndev > 1:
        model = model.to(visible[0]).eval()
        fn = make_sharded_serving_fn(model, get_mc_sampler(config), config, visible[:ndev],
                                     blob.get("spmd_mode", "gspmd"))
        return fixed_sharded_batch(fn, batch, n), meta
    model = model.to(dev).eval()
    fn = make_serving_fn(model, get_mc_sampler(config), config)
    return fixed_batch(fn, batch, n, dev), meta


def local_devices(device: str | torch.device = "cuda") -> list[torch.device]:
    """The devices a serving process drives (the JAX package's
    ``jax.local_devices()``): every card of this process for ``cuda``, the
    one CPU for ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def fixed_sharded_batch(fn, batch_size: int, max_node_num: int):
    """A sharded numpy contract bound to one batch size, as ``fixed_batch``."""
    def call(seed, node_flags, *known, noise=None):
        shape = np.shape(node_flags)
        if shape != (batch_size, max_node_num):
            raise ValueError(f"this sampler serves node flags of shape "
                             f"({batch_size}, {max_node_num}), got {shape}")
        return fn(seed, node_flags, *known, noise=noise)
    return call


def save_compiled(path: str, exported: dict, meta: dict) -> None:
    """Persist ``exported`` (``export_sampler``'s output: the serving core
    at one batch, the counterpart of the JAX package's compiled executable)
    and the caller's ``meta`` to ``path``/ (export.py:352-376):
    ``save_artifact``'s files and ``compiled.json``; on a card with the
    kernels on, also ``kernels/`` with the built library, and its source
    hash, nvcc release and architecture in ``compiled.json``.  Staleness
    against ``meta`` is the caller's to check."""
    from ..config import ConfigDict
    from ..models.factory import use_kernels
    from ..ops import cuda_build

    config = ConfigDict(exported["config"])
    save_artifact(path, exported, config, exported["batch_size"])
    kernels = None
    if exported["platforms"][0] == "cuda" and use_kernels(config):
        lib_path = os.path.join(path, COMPILED_LIB)
        os.makedirs(os.path.dirname(lib_path), exist_ok=True)
        shutil.copyfile(cuda_build.build(), lib_path)
        kernels = {"source_hash": cuda_build.source_hash(), "nvcc": cuda_build.nvcc_version(),
                   "arch": "sm_90a"}
    with open(os.path.join(path, COMPILED_META), "w") as f:
        json.dump({"meta": meta, "kernels": kernels}, f, indent=2)


def load_compiled(path: str, device: str | torch.device = "cuda"):
    """(callable, meta) from ``save_compiled``'s output (export.py:379-400):
    ``load_artifact``'s numpy contract on ``device`` (``cuda`` unless the
    caller asks for the CPU), on a card warmed up by one call, which
    captures the step variants that call takes (a refresh variant it does
    not draw is captured at its first use).  Raises FileNotFoundError when
    the file is absent, RuntimeError when the saved library was built from
    other sources than this tree's or the artifact spans more devices than
    the process has.  Staleness against ``meta`` is the caller's to check."""
    from ..ops import cuda_build

    dev = resolve_device(device)
    with open(os.path.join(path, COMPILED_META)) as f:
        blob = json.load(f)
    kernels = blob["kernels"]
    if kernels is not None:
        if kernels["source_hash"] != cuda_build.source_hash():
            raise RuntimeError(f"compiled artifact at {path} carries a kernel library built "
                               f"from sources of hash {kernels['source_hash']} (nvcc "
                               f"{kernels['nvcc']}, {kernels['arch']}); this tree's hash "
                               f"{cuda_build.source_hash()}: re-save it from this tree")
        if dev.type == "cuda":
            cuda_build.install(os.path.join(path, COMPILED_LIB), kernels["source_hash"])
    fn, art = load_artifact(path, dev)
    if dev.type == "cuda":
        fn(0, np.ones((art["batch_size"], art["max_node_num"]), bool))
    return fn, blob["meta"]
