"""Host milliseconds per training step in the feed, timed from inside the
program: the program's ``data.batch`` (the source's next batch and its
transform: the native batcher and ``pad_batch``) and ``data.stage`` spans
(pinning and the copy's enqueue; ``data/loader.py``'s
``prefetch_to_device``) of the traced sub-window, over its steps.  A
program without the tracer gives nothing."""


def read(ctx, data):
    steps = ctx.get("train_steps")
    try:
        from diffusesg_torch.utils import tracing
    except ImportError:
        return None
    ns = [r.end - r.start for r in tracing.records() if r.name in ("data.batch", "data.stage")]
    return 1e-6 * sum(ns) / steps if ns and steps else None
