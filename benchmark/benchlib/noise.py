"""The draws both sides are handed: keyed by seed, stream, step and kind.

``KeyedNoise`` has the noise protocol of the program's sampler and training
step (``normal(step, kind, shape)``, ``uniform``, ``bernoulli``).  Each draw
is made from a generator seeded with its key on the given device, so the
reference makes the same draw again, in any order, and slices the rows it
checks.  The self-conditioning coin is drawn in blocks: in each block of
2^W steps every one of the 2^W patterns of the W ranks' coins comes once, in
an order drawn from the seed.  Each coin is then true half of the time, as
the published p = 0.5 asks, and a window of whole blocks holds the same
mix of steps with and without the conditioning pass whatever the seed: the
seed changes the order of the work, not its amount.  The set-up's steps
alternate their coins instead, so that each variant is captured there.
"""
from __future__ import annotations

import numpy as np
import torch

KINDS = {"init_adj": 1, "init_node": 2, "churn_adj": 3, "churn_node": 4, "sigma": 5,
         "noise_adj": 6, "noise_node": 7, "inpaint_adj": 8, "inpaint_node": 9}
COIN_STREAM = 1 << 20


def key(*parts: int) -> int:
    """A 63-bit key of whole numbers of any size and sign."""
    words = [2 * int(p) if int(p) >= 0 else -2 * int(p) - 1 for p in parts]
    a, b = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return ((int(a) << 32) | int(b)) & ((1 << 63) - 1)


def coin(seed: int, step: int, rank: int = 0, ranks: int = 1, start: int = 0) -> bool:
    """Rank ``rank``'s self-conditioning coin at ``step``.  Before ``start``
    (set-up) the coins alternate, so that every rank meets both variants
    there; from ``start`` on they come in the seeded blocks, so that a
    window that starts there and holds whole blocks holds the same work on
    every seed."""
    if step < start:
        return bool((step + rank) % 2)
    size = 2 ** ranks
    block, at = divmod(step - start, size)
    order = np.random.default_rng(key(seed, COIN_STREAM, block)).permutation(size)
    return bool((int(order[at]) >> rank) & 1)


class KeyedNoise:
    """Draws of stream ``stream`` (a sampling batch, or a training rank) of
    the run ``seed`` on ``device``; ``rank`` of ``ranks`` picks the coin."""

    def __init__(self, seed: int, device, stream: int = 0, rank: int = 0, ranks: int = 1,
                 start: int = 0):
        self.seed, self.stream, self.rank, self.ranks = int(seed), int(stream), rank, ranks
        self.start = start
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)

    def _gen(self, step: int, kind: str) -> torch.Generator:
        return self.gen.manual_seed(key(self.seed, self.stream, step + 1, KINDS[kind]))

    def normal(self, step: int, kind: str, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self._gen(step, kind), device=self.device)

    def uniform(self, step: int, kind: str, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self._gen(step, kind), device=self.device)

    def bernoulli(self, step: int, kind: str, p: float) -> bool:
        if kind != "self_cond" or p != 0.5:
            raise ValueError(f"the benchmark's cells draw no {kind} coin at p={p}")
        return coin(self.seed, step, self.rank, self.ranks, self.start)
