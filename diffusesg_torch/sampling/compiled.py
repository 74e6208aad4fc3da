"""The compiled sampler: the sampler's steps as replays of captured CUDA graphs.

Counterpart of the JAX package's jitted sampler: ``jax.jit`` over the
``lax.scan`` of ``NodeAdjEDMSampler.sample``
(diffusesg_tpu/sampling/edm_sampler.py:340-343) and its cached chunk runner
(``_chunk_runner``, :545-566).  ``CompiledSampler.sample`` /
``sample_steps`` take the sampler's arguments and give its outputs, bit for
bit; the denoiser comes as ``denoiser_for(node_flags, *operands)``, which
builds it over the tensors it reads, because a graph reads the tensors it
was captured on and every call's flags and operands are copied into those.

On a card, a *program* holds what one denoiser over one set of shapes needs
(cached on the JAX key: the denoiser, whether interim snapshots are on,
which inpaint tensors are set; and the shapes and device; at most 4):

* static buffers for the carry (adjs, nodes, sc_a, sc_x), the node flags,
  the operands, the inpaint tensors, the step's coefficient row and its
  draws; the coefficient table on the device;
* one CUDA graph per step variant (``StepVariant``: whether the churn
  draws, Heun or Euler, the refresh at each evaluation), captured at the
  variant's first use into the program's own memory pool.  The first use
  itself runs eagerly on the program's side stream, on the static buffers,
  and is the step's own work: every kernel's first launch (module load, the
  shared-memory opt-in of csrc/common.cuh's ``PerDevice``, the tile and
  occupancy queries of ``cuda_build``) happens outside any capture.  Later
  uses replay.  A graph ends by copying the new carry into the static one.

Per step, before the replay, the row and the draws are copied into their
static buffers in the caller's stream order.  The draws stay outside the
graph: the caller's noise source makes them in the eager sampler's order,
so every source works (``TorchNoise``, the shared draws of sharded
serving, a test's injected draws).  Interim snapshots and the
``chunk_steps`` synchronize happen between replays.

The first use, the capture and the replay are utils/cuda_graphs.py's,
which the compiled training step (train/compiled.py) shares.  Captures run
in ``thread_local`` error mode: another thread of the process
(an HTTP handler, a checkpoint writer) may call CUDA while a capture is
open, which is safe because no such call touches the capture stream and
the allocator routes only the capturing stream's allocations to the pool.
A capture or replay that fails raises; nothing falls back to eager.

Each program has its own pool, shared by its variants: their graphs run
one after another on one stream, and every tensor they leave alive is a
static buffer outside the pool.  Two programs never share a pool, because
two of them may replay at once on one card (the shards of
``serving/export.py`` on their own streams).

The spans of a step (utils/tracing.py): ``sampler.copy_in`` around the
copies of the row and the draws, then ``graph.replay``, or at a variant's
first use ``graph.first_use`` and ``graph.capture``; all inside the
sampler's ``sampler.step``, and none inside a captured body.  Each program
built counts one ``programs.built``.

A captured kernel launch is counted once per replay: the wrappers' counts
during a capture go to the variant's record (``cuda_build.capturing``) and
each replay adds that record to ``cuda_build.LAUNCHES``.  With the eager
first use, the counts of a compiled sampling equal the eager sampler's.
chip_smoke.py holds each record against the kernels a profiled replay of
its graph launches.

On the CPU the runner runs the eager sampler: the plain version, for the
caller that asks for the CPU.
"""
from __future__ import annotations

import torch

from ..utils import cuda_graphs, tracing
from .edm_sampler import (NodeAdjEDMSampler, StepVariant, TorchNoise, inpaint_tuple,
                          run_steps)

MAX_PROGRAMS = 4


def _spec(t):
    return None if t is None else (tuple(t.shape), t.dtype)


class CompiledSampler:
    """``sampler``'s ``sample`` / ``sample_steps`` with the steps replayed
    from CUDA graphs on a card; ``compiled=False`` runs the eager sampler
    everywhere (the comparison the checks make)."""

    def __init__(self, sampler: NodeAdjEDMSampler, compiled: bool = True):
        self.sampler, self.compiled = sampler, compiled
        self._programs: dict = {}

    def sample(self, denoiser_for, node_flags, num_node_chan: int, num_edge_chan: int,
               noise=None, seed: int = 0, init_adjs=None, init_nodes=None, num_interim: int = 0,
               inpaint: dict | None = None, chunk_steps: int | None = None, operands=()):
        """``NodeAdjEDMSampler.sample`` with the denoiser
        ``denoiser_for(node_flags, *operands)``."""
        return run_steps(self.sample_steps(
            denoiser_for, node_flags, num_node_chan, num_edge_chan, noise=noise, seed=seed,
            init_adjs=init_adjs, init_nodes=init_nodes, num_interim=num_interim,
            inpaint=inpaint, chunk_steps=chunk_steps, operands=operands))

    @torch.no_grad()
    def sample_steps(self, denoiser_for, node_flags, num_node_chan: int, num_edge_chan: int,
                     noise=None, seed: int = 0, init_adjs=None, init_nodes=None,
                     num_interim: int = 0, inpaint: dict | None = None,
                     chunk_steps: int | None = None, operands=()):
        """``NodeAdjEDMSampler.sample_steps``, compiled on a card."""
        operands = tuple(operands)
        if not self._compiles(node_flags.device):
            return (yield from self.sampler.sample_steps(
                denoiser_for(node_flags, *operands), node_flags, num_node_chan, num_edge_chan,
                noise=noise, seed=seed, init_adjs=init_adjs, init_nodes=init_nodes,
                num_interim=num_interim, inpaint=inpaint, chunk_steps=chunk_steps))
        s = self.sampler
        noise = noise if noise is not None else TorchNoise(seed, node_flags.device)
        init_adjs, init_nodes = s.initial_sample(noise, node_flags, num_node_chan,
                                                 num_edge_chan, init_adjs, init_nodes)
        ip = inpaint_tuple(inpaint)
        program = self._program(denoiser_for, node_flags, init_adjs, init_nodes,
                                num_interim > 0, ip, operands)
        steps = program.bind(node_flags, operands, ip)
        try:
            return (yield from s.run_loop(steps, noise, node_flags, init_adjs, init_nodes,
                                          num_interim, ip, chunk_steps))
        finally:
            program.busy = False

    def _compiles(self, device: torch.device) -> bool:
        return cuda_graphs.compiles(self.compiled, device)

    def _program(self, denoiser_for, node_flags, init_adjs, init_nodes, has_interim, ip,
                 operands):
        key = (denoiser_for, has_interim, tuple(v is not None for v in ip), node_flags.device,
               _spec(node_flags), _spec(init_adjs), _spec(init_nodes),
               tuple(_spec(t) for t in ip), tuple(_spec(t) for t in operands))
        program = self._programs.get(key)
        if program is None:
            if len(self._programs) >= MAX_PROGRAMS:
                self._programs.clear()
            program = self._programs[key] = _Program(
                self.sampler, denoiser_for, node_flags, init_adjs, init_nodes, ip, operands)
            tracing.count("programs.built")
        return program

    def stats(self) -> list[dict]:
        """Per program: its variants, the seconds of each one's eager first
        use and capture (wall-clock, ``cuda_graphs.warm_and_capture``), and
        its pool's bytes (None where the allocator's snapshot does not tell
        pools apart)."""
        return [p.stats() for p in self._programs.values()]


class _Program:
    """The static buffers and graphs of one denoiser over one set of shapes
    on one card (see the module docstring)."""

    def __init__(self, sampler, denoiser_for, node_flags, init_adjs, init_nodes, ip, operands):
        dev = node_flags.device
        self.sampler, self.device = sampler, dev
        self.busy = False
        with torch.cuda.device(dev), torch.inference_mode(False):
            self.stream = torch.cuda.Stream(dev)
            self.pool = torch.cuda.graph_pool_handle()
            self.flags = torch.empty_like(node_flags)
            self.operands = tuple(torch.empty_like(t) for t in operands)
            self.ip = tuple(None if t is None else torch.empty_like(t) for t in ip)
            a, x = (torch.zeros(t.shape, dtype=t.dtype, device=dev)
                    for t in (init_adjs, init_nodes))
            self.carry = (a, x, torch.zeros_like(a), torch.zeros_like(x))
            self.row = torch.zeros(12, dtype=torch.float32, device=dev)
            self.draws = (torch.zeros_like(a), torch.zeros_like(x),
                          None if ip[0] is None or ip[1] is None else torch.zeros_like(a),
                          None if ip[2] is None or ip[3] is None else torch.zeros_like(x))
            self.table = sampler.coefficient_table(dev)
        self.denoiser = denoiser_for(self.flags, *self.operands)
        # variant -> (graph, its launch record); seconds of first use, capture
        self.graphs: dict[StepVariant, tuple] = {}
        self.seconds: dict[StepVariant, tuple[float, float]] = {}

    def bind(self, node_flags, operands, ip) -> "_Program":
        """Copy one call's flags, operands and inpaint tensors into the
        static buffers; the program then runs that call's steps."""
        if self.busy:
            raise RuntimeError("a compiled sampler program runs one sampling at a time")
        self.busy = True
        with torch.cuda.device(self.device):
            self.flags.copy_(node_flags)
            for dst, src in zip(self.operands + self.ip, operands + ip):
                if dst is not None:
                    dst.copy_(src)
        return self

    # the steps interface of edm_sampler.EagerSteps
    def start(self, adjs, nodes):
        with torch.cuda.device(self.device):
            self.carry[0].copy_(adjs)
            self.carry[1].copy_(nodes)
            self.carry[2].zero_()
            self.carry[3].zero_()

    def step(self, i: int, variant: StepVariant, draws) -> None:
        with torch.cuda.device(self.device):
            with tracing.span("sampler.copy_in"):
                self.row.copy_(self.table[i])
                for dst, src in zip(self.draws, draws):
                    if src is not None:
                        dst.copy_(src)
            entry = self.graphs.get(variant)
            if entry is not None:
                cuda_graphs.replay(*entry)
            else:
                self._first_use(variant)

    def current(self):
        return self.carry[:2]

    def finish(self):
        with torch.cuda.device(self.device):
            return self.carry[0].clone(), self.carry[1].clone()

    def _body(self, variant: StepVariant) -> None:
        out = self.sampler.step(self.denoiser, self.flags, self.ip, self.carry, self.row,
                                self.draws, variant)
        for dst, src in zip(self.carry, out):
            if src is not dst:
                dst.copy_(src)

    def _first_use(self, variant: StepVariant) -> None:
        """Run the step eagerly on the side stream, then capture it there."""
        graph, record, seconds = cuda_graphs.warm_and_capture(
            lambda: self._body(variant), self.pool, self.stream, self.device)
        self.graphs[variant] = (graph, record)
        self.seconds[variant] = seconds

    def stats(self) -> dict:
        pool = cuda_graphs.pool_bytes(self.pool)
        names = {v: "+".join(k for k, on in v._asdict().items() if on) or "euler"
                 for v in self.seconds}
        return {"device": str(self.device), "variants": len(self.graphs),
                "seconds": {names[v]: s for v, s in self.seconds.items()}, "pool_bytes": pool}
