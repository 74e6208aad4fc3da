"""Share of its roofline that the forward Swin kernels reach: the least
time of every forward Swin block's attention and MLP halves, from the
model's shapes, over the device time of the functions that the map in
``swin_fwd_roofline.json`` assigns to ``swin_attn`` and ``token_mlp``."""
from yardstick import kernels, roofline


def read(ctx, data):
    t = kernels.seconds_of(ctx["trace"], data["table"], data["kernels"])
    if t <= 0 or not ctx.get("forward_passes"):
        return None
    return 100.0 * roofline.swin_forward_s(ctx["shape"], ctx["rows"]) * ctx["forward_passes"] / t
