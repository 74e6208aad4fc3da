"""The compiled training step: the training and test steps as replays of
captured CUDA graphs.

Counterpart of the JAX package's jitted steps: ``jax.jit`` with donation
over ``make_train_step`` / ``make_eval_step``
(diffusesg_tpu/parallel/sharded_step.py:91,117, which the JAX trainer wraps
around its steps even on one device, diffusesg_tpu/train/trainer.py:79-87),
over the ``shard_map`` steps (diffusesg_tpu/parallel/shardmap_dp.py:67,83)
and over the ``gspmd`` and tensor-parallel steps
(diffusesg_tpu/parallel/sharded_step.py:61-118).  ``CompiledTrainStep``
and ``CompiledEvalStep`` take the eager steps' arguments and give their
results, bit for bit; on the CPU, or with ``compiled=False``, they call the
eager step.

On a card a *program* holds what one step over one set of shapes needs,
keyed by the device and the shapes and dtypes of adjs, nodes and flags (an
eval program also by its parameters' addresses: ``ema_slice`` builds a new
dict at each call over the same live EMA tensors; at most 4 programs):

* static input buffers, which each call's batch is copied into; the draw
  buffers (``train_step.draw_plan``, and the ``gspmd`` step's global count
  of valid nodes); the buffers of the step's metrics;
* one CUDA graph per *variant* of each stage that holds the backward, the
  self-conditioning coin (with or without the conditioning pass; one
  variant where the config has no self-conditioning), and one graph of
  each other stage, captured at its first use into the program's pool
  after that use ran eagerly on the program's side stream
  (utils/cuda_graphs.py ``warm_and_capture``; the first use is the step's
  own work).

The draws stay outside the graphs: before each call the caller's noise
source makes them in the eager step's order (sigma, noise_adj, noise_node,
then the coin; a ``gspmd`` step draws the global batch's rows), and they
are copied into the draw buffers, so every source works (``TorchNoise``,
``GlobalRows``, a test's JAX draws).  Inside, the step reads them through
``StaticDraws``, an adapter with the same protocol.  So does the ``gspmd``
step's count of valid nodes, all-reduced over the data group before the
graphs.  The learning rate and the EMAs' lerp weights are written into
their device tensors before the replays (``TrainStep.prepare``).

The graphs are the step's stages (``TrainStep.stages``): one graph per
variant from the zeroing of the gradients to the EMAs on one device; with a
data group, (a) the zeroing, forward, backward and local metrics, per
variant, and (b) clip, Adam and the EMAs, with the data group's
collectives between and after them on the caller's stream: the all-reduce
of the gradients (``reduce``), under ZeRO-1 the all-gather of the
parameters (``gather``), and after all the all-reduce of the scalar
metrics.  No data-group collective is captured.  The tensor-parallel step's
model-group collectives (Megatron's f and g, ``tp.finish_grads``' sums) are
inside its stages and captured with them as NCCL work: its first use runs
them eagerly, which creates the model group's communicator before the
capture; autograd's backward thread issues its all-reduces into the
capture stream; ``ProcessGroupNCCL`` keeps a captured collective out of
its watchdog's queue.  PyTorch 2.11 with NCCL 2.28.9 needs no setting for
it: with the default asynchronous error handling the collectives capture
and replay (chip_smoke.py phase 11 (c) at one rank; at two, the two-card
case of tests/test_torch_cuda_kernels.py).  A stage captured with
collectives reads nothing on the host: a boolean mask's count, for one,
is a read that the capture refuses (parallel/tp.py).  On a group of one
process NCCL issues no device work for a sum in place, so the graph holds
no node for those collectives there.

A graph ends by copying its metrics into static buffers, which the next
replay overwrites: each call returns copies.

The spans of a training step (utils/tracing.py): ``step.call`` around
the whole call, its ``step`` group the state's step, holding
``step.draws``, ``step.load`` (the copies into the static buffers), a
``graph.replay`` per stage graph (``graph.first_use`` and
``graph.capture`` at a first use), ``step.collective`` around each
collective stage and ``step.metrics`` (the metrics' copies; the
reduction of ``finish_metrics`` lies outside it, in ``step.call``).  Each
program built counts one ``programs.built``.

The graphs read and write the training state where it lies: the
parameters, their gradients (made by the first backward, then zeroed in
place; under ZeRO-1 views of flat buffers from the start), Adam's moments,
step counts and learning rate, the EMAs and their lerp weights.  A program
binds those tensors' addresses at its first capture and checks them at
each call; where they moved (a restore that replaced Adam's state,
gradients set to None) it is made anew.  A program runs one step at a
time.  A capture or replay that fails raises; nothing falls back to eager.
"""
from __future__ import annotations

import torch

from ..utils import cuda_graphs, tracing
from .train_state import TrainState
from .train_step import COLLECTIVE, EvalStep, TrainStep, draw_plan, finish_metrics

MAX_PROGRAMS = 4
# a graph's name by the coin of its variant (None: no self-conditioning)
VARIANT = {True: "cond", False: "no_cond", None: "plain"}
# the draw buffer of the gspmd loss's global count of valid nodes
TOTAL_VALID = "total_valid"


class StaticDraws:
    """The noise protocol over a program's draw buffers: ``normal`` and
    ``uniform`` give the buffer of their kind, ``bernoulli`` the variant's
    coin."""

    def __init__(self, buffers: dict, coin: bool | None):
        self.buffers, self.coin = buffers, coin

    def normal(self, step, kind, shape):
        buf = self.buffers[kind]
        if tuple(buf.shape) != tuple(shape):
            raise ValueError(f"the step draws {kind} at {tuple(shape)}, the program holds "
                             f"{tuple(buf.shape)}")
        return buf

    uniform = normal

    def bernoulli(self, step, kind, p):
        return self.coin


def make_draws(noise, step: int, cfg, adjs, nodes) -> tuple[dict, bool | None]:
    """The draws of one step from ``noise``, in the eager step's order:
    {kind: tensor} of ``draw_plan``, then the coin (None without
    self-conditioning)."""
    draws = {kind: getattr(noise, method)(step, kind, shape)
             for method, kind, shape in draw_plan(cfg, adjs.shape, nodes.shape)}
    coin = bool(noise.bernoulli(step, "self_cond", 0.5)) if cfg.self_condition else None
    return draws, coin


def _spec(t):
    return tuple(t.shape), t.dtype


def _copies(metrics: dict) -> dict:
    return {k: v.clone() for k, v in metrics.items()}


def _keep(out: dict, local: dict) -> dict:
    """The step's metrics into the static buffers ``out`` (made at the
    first use, outside any capture).  A graph's body refers to its
    program's buffers and not to the program, so that a dropped program is
    freed at once (a reference cycle would hold its graphs and pool until
    the garbage collector ran)."""
    if not out:
        out.update({k: torch.empty_like(v) for k, v in local.items()})
    for k, v in local.items():
        out[k].copy_(v)
    return out


def _addresses(state: TrainState) -> tuple:
    """Where the tensors a training graph reads and writes lie: the
    parameters and their gradients (under ZeRO-1 views of the flat
    buffers), what Adam steps (the parameters, or ZeRO-1's owned ranges)
    with its state and learning rate, the EMAs and their weights."""
    tensors = [t for p in state.params() for t in (p, p.grad)]
    for group in state.opt.param_groups:
        for p in group["params"]:
            tensors += [p, p.grad] + [v for v in state.opt.state.get(p, {}).values()
                                      if isinstance(v, torch.Tensor)]
        tensors.append(group["lr"] if isinstance(group["lr"], torch.Tensor) else None)
    tensors += [e for ema in state.ema_params for e in ema]
    if state.ema_weights is not None:
        tensors += list(state.ema_weights.bufs.values())
    return tuple(0 if t is None else t.data_ptr() for t in tensors)


def _graph_name(stage: str, coin) -> str:
    """A stage's graph: the whole step's by its variant, the backward's per
    variant, another stage's by its name."""
    if stage == "step":
        return VARIANT[coin]
    return f"backward:{VARIANT[coin]}" if stage == "backward" else stage


class _Program:
    """The static buffers and graphs of one step over one set of shapes on
    one card (see the module docstring)."""

    def __init__(self, cfg, batch):
        dev = batch[0].device
        self.device, self.busy, self.bound = dev, False, None
        with torch.cuda.device(dev):
            self.stream = torch.cuda.Stream(dev)
            self.pool = torch.cuda.graph_pool_handle()
            self.batch = tuple(torch.empty_like(t) for t in batch)
            self.draws = {kind: torch.empty(shape, dtype=torch.float32, device=dev)
                          for _, kind, shape in draw_plan(cfg, batch[0].shape, batch[1].shape)}
            self.draws[TOTAL_VALID] = torch.empty((), dtype=torch.float32, device=dev)
        self.out: dict = {}
        # graph name -> (graph, its launch record), its body (chip_smoke.py runs
        # it eagerly beside a replay), seconds of its first use and capture
        self.graphs: dict[str, tuple] = {}
        self.bodies: dict = {}
        self.seconds: dict[str, tuple[float, float]] = {}

    def load(self, batch, draws: dict) -> None:
        """Copy one call's batch and draws (the count of valid nodes among
        them) into the static buffers."""
        if self.busy:
            raise RuntimeError("a compiled step's program runs one step at a time")
        for dst, src in zip(self.batch, batch):
            dst.copy_(src)
        for kind, t in draws.items():
            self.draws[kind].copy_(t)

    def run(self, name: str, body) -> None:
        """Replay graph ``name``, or run ``body`` for its first use and
        capture it."""
        entry = self.graphs.get(name)
        if entry is not None:
            cuda_graphs.replay(*entry)
            return
        graph, record, seconds = cuda_graphs.warm_and_capture(body, self.pool, self.stream,
                                                              self.device)
        self.graphs[name], self.bodies[name], self.seconds[name] = (graph, record), body, seconds

    def stats(self) -> dict:
        return {"device": str(self.device), "variants": sorted(self.graphs),
                "seconds": dict(self.seconds), "pool_bytes": cuda_graphs.pool_bytes(self.pool)}


class _Compiled:
    """The program cache of a compiled step."""

    def __init__(self, compiled: bool):
        self.compiled = compiled
        self._programs: dict = {}

    def _compiles(self, device: torch.device) -> bool:
        return cuda_graphs.compiles(self.compiled, device)

    def _program(self, key, cfg, batch) -> _Program:
        program = self._programs.get(key)
        if program is None:
            if len(self._programs) >= MAX_PROGRAMS:
                self._programs.clear()
            program = self._programs[key] = _Program(cfg, batch)
            tracing.count("programs.built")
        return program

    def stats(self) -> list[dict]:
        """Per program: its graphs, the seconds of each one's first use and
        capture (wall-clock, ``cuda_graphs.warm_and_capture``), and its
        pool's bytes."""
        return [p.stats() for p in self._programs.values()]


def _draws(step, noise, count: int, batch) -> tuple[dict, bool | None]:
    """One call's draws from the caller's ``noise`` and, for a ``gspmd``
    step, the global count of valid nodes (COLLECTIVE there)."""
    adjs, nodes, flags = batch
    draws, coin = make_draws(step.source(noise), count, step.cfg, adjs, nodes)
    total_valid = step.count(flags)
    if total_valid is not None:
        draws[TOTAL_VALID] = total_valid
    return draws, coin


class CompiledTrainStep(_Compiled):
    """``step`` (a ``TrainStep``: on one device, on the ranks of a
    ``shard_map`` or ``gspmd`` world, tensor parallel) with its device work
    replayed from CUDA graphs on a card; ``compiled=False`` runs the eager
    step everywhere (the comparison the checks make)."""

    def __init__(self, step: TrainStep, compiled: bool = True):
        super().__init__(compiled)
        self.step = step

    def __call__(self, state: TrainState, noise, adjs_gt, nodes_gt, node_flags):
        with tracing.span("step.call", step=state.step):
            if not self._compiles(node_flags.device):
                return self.step(state, noise, adjs_gt, nodes_gt, node_flags)
            return self._call(state, noise, (adjs_gt, nodes_gt, node_flags))

    def _call(self, state: TrainState, noise, batch):
        step, node_flags = self.step, batch[2]
        with tracing.span("step.draws"):
            draws, coin = _draws(step, noise, state.step, batch)
        key = (node_flags.device,) + tuple(_spec(t) for t in batch)
        program = self._program(key, step.cfg, batch)
        if program.bound is not None and program.bound != _addresses(state):
            del self._programs[key]  # the state's tensors moved: capture anew
            program = self._program(key, step.cfg, batch)
        with torch.cuda.device(program.device):
            with tracing.span("step.load"):
                program.load(batch, draws)
            program.busy = True
            try:
                local = self._run(program, state, coin, TOTAL_VALID in draws)
            finally:
                program.busy = False
        state.step += 1
        return state, finish_metrics(local, step.world, step.reduce)

    def _run(self, program: _Program, state: TrainState, coin, counted: bool) -> dict:
        """The step's stages: a graph each, the collective ones on the
        caller's stream between them.  Returns copies of the local
        metrics."""
        step, out, batch = self.step, program.out, program.batch
        noise = StaticDraws(program.draws, coin)
        total_valid = program.draws[TOTAL_VALID] if counted else None
        step.prepare(state)
        for stage in step.stages(state):
            def body(stage=stage):
                local = step.run(stage, state, noise, batch, total_valid)
                return None if local is None else _keep(out, local)

            if stage in COLLECTIVE:
                self._bind(program, state)
                with tracing.span("step.collective", stage=stage):
                    body()
            else:
                program.run(_graph_name(stage, coin), body)
        self._bind(program, state)
        with tracing.span("step.metrics"):
            return _copies(program.out)

    @staticmethod
    def _bind(program: _Program, state: TrainState) -> None:
        if program.bound is None:
            program.bound = _addresses(state)


class CompiledEvalStep(_Compiled):
    """``step`` (an ``EvalStep``) with its device work replayed from CUDA
    graphs on a card; ``compiled=False`` runs the eager step everywhere."""

    def __init__(self, step: EvalStep, compiled: bool = True):
        super().__init__(compiled)
        self.step = step

    def __call__(self, params, noise, count: int, adjs_gt, nodes_gt, node_flags):
        if not self._compiles(node_flags.device):
            return self.step(params, noise, count, adjs_gt, nodes_gt, node_flags)
        step, batch = self.step, (adjs_gt, nodes_gt, node_flags)
        draws, coin = _draws(step, noise, count, batch)
        held = None if params is None else tuple(t.data_ptr() for t in params.values())
        key = (node_flags.device, held) + tuple(_spec(t) for t in batch)
        program = self._program(key, step.cfg, batch)
        with torch.cuda.device(program.device):
            program.load(batch, draws)
            program.busy = True
            try:
                noise, out, static = StaticDraws(program.draws, coin), program.out, program.batch
                total_valid = program.draws[TOTAL_VALID] if TOTAL_VALID in draws else None
                program.run(VARIANT[coin], lambda: _keep(
                    out, step.local(params, noise, count, *static, total_valid)))
                local = _copies(out)
            finally:
                program.busy = False
        return finish_metrics(local, step.world, step.reduce)
