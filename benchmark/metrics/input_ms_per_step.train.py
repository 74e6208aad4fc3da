"""Host milliseconds per training step spent in ``next()`` of the
prefetching feed (``data/loader.py``'s ``Batches`` and
``prefetch_to_device``), from the benchmark's own span around each call."""


def read(ctx, data):
    if not ctx.get("train_steps"):
        return None
    return 1e3 * ctx["input_s"] / ctx["train_steps"]
