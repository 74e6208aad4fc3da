"""The whole step's share of the cards' bf16 peak: the model operations of
the traced window, counted from the model's shapes (``yardstick/flops.py``;
a training step 3 forwards' worth, 4 with the self-conditioning pass), over
the window's seconds times the cards times 989 TFLOP/s."""
from yardstick import roofline


def read(ctx, data):
    if ctx["window_s"] <= 0 or not ctx.get("flop"):
        return None
    return 100.0 * ctx["flop"] / (ctx["window_s"] * ctx["chips"] * roofline.PEAK_BF16_FLOPS)
