"""Host CUDA API calls (runtime and driver) per Heun step in the
traced sub-window."""


def read(ctx, data):
    steps = ctx.get("heun_steps")
    return ctx["trace"].api_calls / steps if steps else None
