"""Accumulated matrix products, bf16 against int8: a tensor-core micro-benchmark.

Counterpart of scripts/microbench_int8.py::mm_kernel: ``repeats`` products
``a[m, k] @ b[k, n]`` accumulated into two independent accumulator sets and
summed, so the result is ``repeats * (a @ b)``: bf16 operands give fp32, int8
operands give int32 (exact while |sum| < 2^31).  On a CUDA tensor it is the
hand-written kernel ``mm_accumulate`` (csrc/mm_microbench.cu); on a CPU
tensor the plain version.  The kernel computes the whole output ``copies``
times over a grid of ``tiles * copies`` blocks, a multiple of the card's SM
count (``grid_plan``), as the TPU grid of 16 programs computes it 16 times;
``scripts/microbench_int8_torch.py`` turns its time into T(FL)OP/s.
"""
from __future__ import annotations

import torch

from . import cuda_build

NAME = "mm_accumulate"
TILE = 64  # output tile of one block (csrc/mm_microbench.cu kTile)
SHAPES = ((512, 768, 768), (1024, 96, 96), (1024, 96, 288), (2048, 128, 128))


def mm_accumulate_plain(a, b, repeats: int = 64):
    """``repeats * (a @ b)``: fp32 from floating operands, int32 from int8."""
    if a.dtype == torch.int8:
        return repeats * (a.int().cpu() @ b.int().cpu()).to(a.device)
    return repeats * (a.float() @ b.float())


def grid_plan(m: int, n: int, sm_count: int) -> tuple[int, int]:
    """(tiles, copies): output tiles of one product, and how often the whole
    product is computed so that the grid is a multiple of ``sm_count``."""
    tiles = -(-m // TILE) * -(-n // TILE)
    copies = 1
    while (tiles * copies) % sm_count:
        copies += 1
    return tiles, copies


def operations(m: int, k: int, n: int, repeats: int, copies: int) -> int:
    """Multiply-adds counted as two operations, over every copy."""
    return 2 * m * k * n * repeats * copies


def mm_accumulate(a, b, repeats: int = 64):
    """a [m, k], b [k, n], both bf16 or both int8 -> [m, n] fp32 or int32."""
    if a.device.type == "cpu":
        return mm_accumulate_plain(a, b, repeats)
    if a.dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"mm_accumulate takes bf16 or int8 operands, got {a.dtype}")
    a = cuda_build.require(a, a.dtype, "a")
    b = cuda_build.require(b, a.dtype, "b")
    (m, k), n = a.shape, b.shape[1]
    if b.shape[0] != k or m % 16 or n % 16 or k % 32 or repeats < 2 or repeats % 2:
        raise ValueError(f"mm_accumulate takes m, n multiples of 16, k a multiple of 32 and an "
                         f"even repeats; got a{tuple(a.shape)} b{tuple(b.shape)} x{repeats}")
    is_int8 = a.dtype == torch.int8
    out = torch.empty((m, n), dtype=torch.int32 if is_int8 else torch.float32, device=a.device)
    _, copies = grid_plan(m, n, torch.cuda.get_device_properties(a.device).multi_processor_count)
    p = cuda_build.ptr
    rc = cuda_build.lib().dsg_mm_accumulate(p(a), p(b), p(out), m, n, k, copies, repeats,
                                            int(is_int8), cuda_build.stream_ptr(a.device))
    cuda_build.check(rc, NAME)
    cuda_build.count_launch(NAME, f"{m}x{k}x{n} {'int8' if is_int8 else 'bf16'}")
    return out
