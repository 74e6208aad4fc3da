"""What the compiled sampler and the compiled training step share: the
capture of a step as a CUDA graph and the test of whether a call compiles.

Counterpart of the JAX package's ``jax.jit``: a compiled step is a body run
eagerly once and then captured (``warm_and_capture``), and replayed after.

* ``compiles(compiled, device)``: whether a call on ``device`` runs its
  graphs; only a card does (the CPU runs the eager step, the plain
  version for the caller that asks for the CPU).
* ``warm_and_capture(body, pool, stream, device)``: the body's first use,
  run eagerly on the program's side stream (the step's own work: every
  kernel's first launch, module load and shared-memory opt-in, the tile
  and occupancy queries, autograd's and cuBLAS's first allocations happen
  outside any capture), then its capture on that stream into ``pool`` in
  ``thread_local`` error mode.  The wrappers' launch counts during the
  capture go to the graph's record (``cuda_build.capturing``, the capture
  stream's launches from any thread: the autograd engine runs a backward's
  CUDA nodes on a thread of its own); whoever replays the graph adds that
  record to ``cuda_build.LAUNCHES`` at each replay.
* ``capture(body, pool, stream)``: the capture alone.  With ``KEEP_NODES``
  set, each graph keeps its nodes after it is instantiated, for
  ``CUDAGraph.debug_dump`` (chip_smoke.py reads the kernels of a graph so).
* The spans ``graph.first_use``, ``graph.capture`` and ``graph.replay``
  (utils/tracing.py) lie around the calls into a graph, never inside its
  body, and the counters ``graph.captures`` and ``graph.replays`` count
  them.  The seconds ``warm_and_capture`` returns are its spans' readings.

These two functions are the seam a CPU test replaces (tests/helpers/
graph_stand_in.py): a "graph" that calls its body at each replay.
"""
from __future__ import annotations

import collections
import gc

import torch

from ..ops import cuda_build
from . import tracing

# keep each captured graph's nodes for CUDAGraph.debug_dump (off: they are
# freed once the graph is instantiated)
KEEP_NODES = False


def compiles(compiled: bool, device: torch.device) -> bool:
    """Whether a call on ``device`` runs captured graphs."""
    return compiled and device.type == "cuda"


def capture(body, pool, stream) -> torch.cuda.CUDAGraph:
    """``body()`` captured as a CUDA graph on ``stream`` into ``pool``.
    Python's garbage collector is off during the capture: a collection
    inside it may destroy a CUDA object of a dead reference cycle (a graph,
    an event), which the capture does not survive (chip_smoke.py phase 13
    (d) failed so until it was off)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=KEEP_NODES)
        if KEEP_NODES:
            graph.enable_debug_mode()
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            body()
        if KEEP_NODES:  # kept graphs are instantiated at the first replay otherwise
            graph.instantiate()
    finally:
        if enabled:
            gc.enable()
    return graph


def warm_and_capture(body, pool, stream, device) -> tuple:
    """Run ``body`` eagerly on ``stream``, then capture it there:
    (graph, its launch record, (seconds of the first use, of the capture)).
    The seconds are the readings of the spans ``graph.first_use`` and
    ``graph.capture``, on the profiler's clock: wall-clock time
    (``CLOCK_REALTIME``), which a step of the system's clock would move.
    The caller's stream waits for both."""
    caller = torch.cuda.current_stream(device)
    stream.wait_stream(caller)
    with tracing.timed("graph.first_use") as first, torch.cuda.stream(stream):
        body()
    with tracing.timed("graph.capture") as captured, \
            cuda_build.capturing(collections.Counter(), stream) as record:
        graph = capture(body, pool, stream)
    tracing.count("graph.captures")
    caller.wait_stream(stream)
    return graph, record, (first.seconds, captured.seconds)


def replay(graph, record) -> None:
    """One replay of ``graph``, its launch record added to the counts."""
    with tracing.span("graph.replay"):
        graph.replay()
    cuda_build.LAUNCHES.update(record)
    tracing.count("graph.replays")


def pool_bytes(pool) -> int | None:
    """Bytes the allocator holds in ``pool``'s segments (None where its
    snapshot does not tell pools apart)."""
    segments = torch.cuda.memory_snapshot() if torch.cuda.is_available() else []
    if not segments or "segment_pool_id" not in segments[0]:
        return None
    return sum(s["total_size"] for s in segments if tuple(s["segment_pool_id"]) == tuple(pool))
