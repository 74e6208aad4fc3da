"""Device milliseconds of NCCL kernels on rank 0 per training step: the
exposed all-reduce and the wait for the slowest rank."""


def read(ctx, data):
    if ctx.get("chips", 1) < 2 or not ctx.get("train_steps"):
        return None
    t = ctx["trace"].seconds_where(lambda n: "nccl" in n.lower())
    return 1e3 * t / ctx["train_steps"] if t > 0 else None
