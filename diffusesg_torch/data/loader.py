"""Batch iteration over packed arrays, with per-process sharding.

Counterpart of diffusesg_tpu/data/loader.py (the reference's DataLoader +
DistributedSampler): data already lives in dense numpy arrays, so batching
is pure indexing; with several processes each iterates its own strided
shard.  The C++ batch assembler of the JAX package (data/native) waits.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Iterator

import numpy as np
import torch

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

    def __iter__(self) -> Iterator[tuple]:
        idx = self._filled(self._host_indices())
        bs = self.batch_size
        for start in range(0, len(idx), bs):
            sel = idx[start:start + bs]
            if self.drop_remainder and len(sel) < bs:
                break
            yield (self.data.adjs[sel], self.data.nodes[sel],
                   self.data.node_flags[sel], self.data.image_ids[sel])

    def __len__(self):
        n = len(self._filled(self._host_indices()))
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)


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
    """
    device = torch.device(device)
    on_card = device.type == "cuda"
    side = torch.cuda.Stream(device) if on_card else None

    def put(item):
        arrays = transform(item) if transform is not None else item
        tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if not on_card:
            return tuple(tensors), None
        with torch.cuda.stream(side):
            out = tuple(t.pin_memory().to(device, non_blocking=True) for t in tensors)
            return out, side.record_event()

    buf: collections.deque = collections.deque()
    it = iter(iterator)

    def fill(n):
        for item in itertools.islice(it, n):
            buf.append(put(item))

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
