"""Host CUDA API calls (runtime and driver) per training step in the
traced sub-window."""


def read(ctx, data):
    steps = ctx.get("train_steps")
    return ctx["trace"].api_calls / steps if steps else None
