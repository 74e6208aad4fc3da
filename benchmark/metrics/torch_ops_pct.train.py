"""Share of the card's busy time spent in functions that are not the
port's own kernels (the map in ``torch_ops_pct.train.json``): the plain
vjps, LayerNorms, Adam, the EMAs, casts and the loss.  NCCL kernels and
copies are no functions of the step and are left out of the numerator."""
from yardstick import kernels


def read(ctx, data):
    s = ctx["trace"]
    if s.busy_s <= 0:
        return None

    def other(name):
        return kernels.kernel_of(name, data["table"]) is None and not any(
            f in name for f in data["not_functions"])
    return 100.0 * s.seconds_where(other) / s.busy_s
