"""Peaks of the card and the least time of the Swin blocks' kernels.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the full 700 W limit.
A kernel's least time is the larger of its operations over the peak rate
and its bytes over the memory bandwidth; each input byte is counted read
once and each output byte written once, whatever a kernel reads again.
The counts follow the model's shapes (``reference.model.Shape.blocks``),
not the launches a program makes.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
BF16, FP32 = 2, 4


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def _halves(rows: int, res: int, c: int, heads: int, w: int):
    """(attention half, MLP half) of one block's forward: (flops, bytes)."""
    m, L = rows * res * res, w * w
    attn_flops = 2 * m * c * 3 * c + 2 * m * c * c + 2 * 2 * m * L * c
    # x in and y out (bf16), the weights (bf16), the conditioning row, bias
    # table and mask (fp32)
    attn_bytes = (2 * m * c * BF16 + 4 * c * c * BF16 + rows * 2 * c * FP32
                  + heads * L * L * FP32)
    mlp_flops = 2 * 2 * m * c * 4 * c
    mlp_bytes = 2 * m * c * BF16 + 8 * c * c * BF16
    return (attn_flops, attn_bytes), (mlp_flops, mlp_bytes)


def swin_forward_s(shape, rows: int) -> float:
    """Least time of every Swin block of one forward over ``rows`` graphs,
    the attention half and the MLP half each bounded on its own."""
    total = 0.0
    for _, res, c, heads, w, _ in shape.blocks():
        for flops, nbytes in _halves(rows, res, c, heads, w):
            total += bound_s(flops, nbytes)
    return total


def swin_backward_s(shape, rows: int) -> float:
    """Least time of the backward of every Swin block of one forward: the
    input gradients and the weight gradients (twice the products of the
    forward; no recomputation counted), reading x and dy and writing dx in
    bf16 and the weight gradients in fp32."""
    total = 0.0
    for _, res, c, heads, w, _ in shape.blocks():
        m = rows * res * res
        (af, _), (mf, _) = _halves(rows, res, c, heads, w)
        attn_bytes = 3 * m * c * BF16 + 4 * c * c * (BF16 + FP32) + heads * w ** 4 * FP32
        mlp_bytes = 3 * m * c * BF16 + 8 * c * c * (BF16 + FP32)
        total += bound_s(2 * af, attn_bytes) + bound_s(2 * mf, mlp_bytes)
    return total
