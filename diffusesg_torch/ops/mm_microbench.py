"""Accumulated matrix products, bf16 against int8: a tensor-core micro-benchmark.

Counterpart of scripts/microbench_int8.py::mm_kernel: ``repeats`` products
``a[m, k] @ b[k, n]`` accumulated, so the result is ``repeats * (a @ b)``:
bf16 operands give fp32, int8 operands give int32 (exact while |sum| < 2^31).
On a CUDA tensor it is the hand-written wgmma kernel ``mm_accumulate``
(csrc/mm_microbench.cu); on a CPU tensor the plain version.

The work is fixed by ``grid_plan``: the whole output is computed ``copies``
times, the count that makes 64 x 64 tiles x copies a multiple of the card's
SM count, as the TPU grid of 16 programs computes it 16 times; so
``operations`` and the T(FL)OP/s of ``scripts/microbench_int8_torch.py``
keep their meaning whatever tile the kernel runs.  The kernel's own tile
(``kernel_tile``, from the library) and its persistent grid over the work
items (tile, copy) are ``kernel_plan``'s.
"""
from __future__ import annotations

import torch

from . import cuda_build

NAME = "mm_accumulate"
TILE = 64  # the tile that defines the work (copies), not the kernel's
SHAPES = ((512, 768, 768), (1024, 96, 96), (1024, 96, 288), (2048, 128, 128))


def mm_accumulate_plain(a, b, repeats: int = 64):
    """``repeats * (a @ b)``: fp32 from floating operands, int32 from int8."""
    if a.dtype == torch.int8:
        return repeats * (a.int().cpu() @ b.int().cpu()).to(a.device)
    return repeats * (a.float() @ b.float())


def grid_plan(m: int, n: int, sm_count: int) -> tuple[int, int]:
    """(tiles, copies): 64 x 64 tiles of one product, and how often the whole
    product is computed so that tiles x copies is a multiple of ``sm_count``."""
    tiles = -(-m // TILE) * -(-n // TILE)
    copies = 1
    while (tiles * copies) % sm_count:
        copies += 1
    return tiles, copies


def operations(m: int, k: int, n: int, repeats: int, copies: int) -> int:
    """Multiply-adds counted as two operations, over every copy."""
    return 2 * m * k * n * repeats * copies


def kernel_tile(device, n: int, k: int, is_int8: bool) -> tuple[int, ...]:
    """The kernel's tile at these widths, from the library: (rows, columns,
    blocks an SM holds, dynamic shared memory bytes a block); ValueError
    where no tile divides ``n``."""
    return cuda_build.tile_of(device, "dsg_mm_accumulate_tile", n, k, int(is_int8))


def kernel_plan(m: int, n: int, tile: tuple[int, ...], sms: int) -> dict[str, int]:
    """The kernel's grid (csrc/mm_microbench.cu, dsg_mm_accumulate): ``tiles``
    output tiles of ``tile[0]`` x ``tile[1]``, ``copies`` from ``grid_plan``,
    ``items`` = tiles x copies, and ``grid`` persistent blocks (at most one
    wave of resident blocks) of which block x walks items x, x + grid, ...;
    item i is tile i % tiles of copy i // tiles."""
    rows, cols, per_sm = tile[:3]
    tiles = -(-m // rows) * (n // cols)
    copies = grid_plan(m, n, sms)[1]
    items = tiles * copies
    return dict(tiles=tiles, copies=copies, items=items, grid=min(items, sms * per_sm))


def mm_accumulate(a, b, repeats: int = 64):
    """a [m, k], b [k, n], both bf16 or both int8 -> [m, n] fp32 or int32."""
    if a.device.type == "cpu":
        return mm_accumulate_plain(a, b, repeats)
    if a.dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"mm_accumulate takes bf16 or int8 operands, got {a.dtype}")
    a = cuda_build.require(a, a.dtype, "a")
    b = cuda_build.require(b, a.dtype, "b")
    (m, k), n = a.shape, b.shape[1]
    is_int8 = a.dtype == torch.int8
    if b.shape[0] != k or m < 1 or k % 32 or repeats < 1:
        raise ValueError(f"mm_accumulate takes k a multiple of 32 and repeats >= 1; got "
                         f"a{tuple(a.shape)} b{tuple(b.shape)} x{repeats}")
    kernel_tile(a.device, n, k, is_int8)  # raises ValueError where no tile divides n
    out = torch.empty((m, n), dtype=torch.int32 if is_int8 else torch.float32, device=a.device)
    _, copies = grid_plan(m, n, cuda_build.sm_count(a.device))
    p = cuda_build.ptr
    cuda_build.launch(NAME, a.device, "dsg_mm_accumulate", p(a), p(b), p(out), m, n, k, copies,
                      repeats, int(is_int8))
    cuda_build.count_launch(NAME, f"{m}x{k}x{n} {'int8' if is_int8 else 'bf16'}")
    return out
