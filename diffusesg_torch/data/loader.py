"""Batch iteration over packed arrays, with per-process sharding.

Counterpart of diffusesg_tpu/data/loader.py (the reference's DataLoader +
DistributedSampler): data already lives in dense numpy arrays, so batching
is pure indexing; with several processes each iterates its own strided
shard, and ``shard_for_process`` gives each its strided shard of the eval
set; ``split_eval_set`` picks the sampling orchestrator's eval set.  The
row gather runs in the C++ batch assembler of ``data/native`` where the
host has a CPU to spare for it (the JAX package's rule), in numpy otherwise.
"""
from __future__ import annotations

import collections
import dataclasses
import os
from typing import Iterator

import numpy as np
import torch

from ..utils import tracing
from .dataset import SceneGraphData


@dataclasses.dataclass
class Batches:
    """Epoch iterator yielding (adjs, nodes, node_flags, image_ids) numpy slabs.

    ``repeat_to_batch`` mirrors the reference's repeat-to-fill trick for small
    datasets (reference: trainer_node_adj.py:56-65): when the dataset is
    smaller than one batch and divides it, graphs are tiled to fill the batch.
    """
    data: SceneGraphData
    batch_size: int
    shuffle: bool = True
    seed: int = 0
    drop_remainder: bool = False
    repeat_to_batch: bool = True
    process_index: int = 0
    process_count: int = 1
    # gather the rows in the C++ engine of data/native (bit-equal batches,
    # assembled by threads off the interpreter lock a few batches ahead).
    # None = auto: on when more than one CPU is available to this process
    # (on one CPU its thread only takes the consumer's cycles); numpy when
    # the library does not build or DSG_NATIVE_LOADER=0 (JAX loader.py:37-45)
    native: bool | None = None

    def __post_init__(self):
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _host_indices(self) -> np.ndarray:
        n = len(self.data)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        if self.process_count > 1:
            # wrap-pad so every process gets the SAME shard length, like the
            # reference DistributedSampler: unequal shards would make the
            # processes run different numbers of collective steps
            total = -(-n // self.process_count) * self.process_count
            if total > n:
                idx = np.concatenate([idx, idx[: total - n]])
        return idx[self.process_index::self.process_count]

    def _filled(self, idx: np.ndarray) -> np.ndarray:
        n, bs = len(idx), self.batch_size
        if 0 < n < bs and self.repeat_to_batch and bs % n == 0:
            return np.tile(idx, bs // n)
        return idx

    def _use_native(self) -> bool:
        use = self.native
        if use is None:
            try:
                use = len(os.sched_getaffinity(0)) > 1
            except AttributeError:  # no affinity outside Linux
                use = (os.cpu_count() or 1) > 1
        if not use:
            return False
        from .native import get_lib
        return get_lib() is not None

    def __iter__(self) -> Iterator[tuple]:
        idx = self._filled(self._host_indices())
        bs = self.batch_size
        if self._use_native():
            from .native import iter_batches_native
            if self.drop_remainder:
                idx = idx[:len(idx) // bs * bs]
            yield from iter_batches_native([self.data.adjs, self.data.nodes,
                                            self.data.node_flags, self.data.image_ids], idx, bs)
            return
        for start in range(0, len(idx), bs):
            sel = idx[start:start + bs]
            if self.drop_remainder and len(sel) < bs:
                break
            yield (self.data.adjs[sel], self.data.nodes[sel],
                   self.data.node_flags[sel], self.data.image_ids[sel])

    def __len__(self):
        n = len(self._filled(self._host_indices()))
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)


def shard_for_process(data: SceneGraphData, process_index: int,
                      process_count: int) -> SceneGraphData:
    """This process's strided shard of a packed dataset (the eval-side
    DistributedSampler, reference: utils/dataloader.py:26-29;
    diffusesg_tpu/data/loader.py:178-198).  Every process gets exactly
    ceil(n / process_count) rows: a shorter shard is wrap-padded at its end
    with its own first rows, so the gathered results have one shape on every
    rank and the orchestrator's trim can drop the pads."""
    if process_count <= 1:
        return data
    per = -(-len(data) // process_count)
    sel = np.arange(process_index, len(data), process_count)
    if len(sel) < per:
        sel = np.concatenate([sel, sel[: per - len(sel)]])
    return SceneGraphData(
        adjs=data.adjs[sel], nodes=data.nodes[sel], node_flags=data.node_flags[sel],
        image_ids=data.image_ids[sel],
        pkl_data=[data.pkl_data[i] for i in sel] if data.pkl_data else [],
        num_node_type=data.num_node_type, num_edge_type=data.num_edge_type)


def split_eval_set(data: SceneGraphData, total_samples: int, seed: int = 0) -> SceneGraphData:
    """Subset (a seeded permutation) or repeat the test set to hit
    ``total_samples`` (reference: runner/sampler/sampler_utils.py:8-41)."""
    n = len(data)
    if total_samples < n:
        sel = np.random.RandomState(seed).permutation(n)[:total_samples]
    elif total_samples == n:
        sel = np.arange(n)
    else:
        sel = np.tile(np.arange(n), -(-total_samples // n))[:total_samples]
    return SceneGraphData(
        adjs=data.adjs[sel], nodes=data.nodes[sel], node_flags=data.node_flags[sel],
        image_ids=data.image_ids[sel],
        pkl_data=[data.pkl_data[i % len(data.pkl_data)] for i in sel] if data.pkl_data else [],
        num_node_type=data.num_node_type, num_edge_type=data.num_edge_type)


def pad_batch(arrays, batch_size: int):
    """Repeat-pad a trailing partial batch to the full size (so every step
    sees the same shapes); returns (arrays, number of real rows)."""
    n = arrays[0].shape[0]
    if n == batch_size:
        return tuple(arrays), n
    reps = -(-batch_size // n)
    return tuple(np.concatenate([a] * reps, 0)[:batch_size] for a in arrays), n


def prefetch_to_device(iterator, device, size: int = 2, transform=None) -> Iterator[tuple]:
    """Keep ``size`` batches in flight ahead of consumption.

    Each item of ``iterator`` is a tuple of numpy arrays (after ``transform``,
    if given).  On a CUDA device the arrays are staged in pinned memory and
    copied on a side stream, so the next batch's host-to-device copy overlaps
    the current step's compute; the consumer's stream waits on the copy's
    event before the tensors are handed over.  On the CPU it only converts.
    Spans (utils/tracing.py): ``data.batch`` around the source's next item
    and ``transform``, ``data.stage`` around the pinning and the copy's
    enqueue.
    """
    device = torch.device(device)
    on_card = device.type == "cuda"
    side = torch.cuda.Stream(device) if on_card else None

    def put(arrays):
        tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if not on_card:
            return tuple(tensors), None
        with torch.cuda.stream(side):
            out = tuple(t.pin_memory().to(device, non_blocking=True) for t in tensors)
            return out, side.record_event()

    buf: collections.deque = collections.deque()
    it = iter(iterator)

    def fill(n):
        nonlocal it
        for _ in range(n):
            if it is None:  # the source has ended
                return
            with tracing.span("data.batch"):
                item = next(it, None)
                if item is None:
                    it = None
                    return
                arrays = transform(item) if transform is not None else item
            with tracing.span("data.stage"):
                buf.append(put(arrays))

    fill(size)
    while buf:
        tensors, event = buf.popleft()
        fill(1)
        if event is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for t in tensors:
                t.record_stream(current)
        yield tensors
