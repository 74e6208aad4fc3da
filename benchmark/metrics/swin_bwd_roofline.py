"""Share of its roofline that the backward Swin kernels reach: the least
time of the input and weight gradients of every Swin block, from the
model's shapes, over the device time of the functions that the map in
``swin_bwd_roofline.json`` assigns to ``swin_attn_bwd``, ``token_mlp_bwd``
and their row passes and reductions."""
from yardstick import kernels, roofline


def read(ctx, data):
    t = kernels.seconds_of(ctx["trace"], data["table"], data["kernels"])
    if t <= 0 or not ctx.get("backward_passes"):
        return None
    return 100.0 * roofline.swin_backward_s(ctx["shape"], ctx["rows"]) * ctx["backward_passes"] / t
