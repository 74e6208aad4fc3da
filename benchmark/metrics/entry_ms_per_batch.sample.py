"""Host milliseconds per batch in the serving entry outside the sampler
and the wait for the card: for each of the program's ``serve.call`` spans
(``serving/export.py``'s ``fixed_batch``) its length less the
``sampler.step`` and ``serve.wait`` spans of its batch, the mean over the
batches of the traced sub-window.  What is left is the copy-in, the
initial draw, the binding of the compiled program, the decode's enqueue
and the copy back.  A program without the tracer gives nothing."""


def read(ctx, data):
    try:
        from diffusesg_torch.utils import tracing
    except ImportError:
        return None
    recs = tracing.records()
    inner = {}
    for r in recs:
        if r.name in ("sampler.step", "serve.wait"):
            inner[r.group] = inner.get(r.group, 0) + r.end - r.start
    own = [r.end - r.start - inner.get(r.group, 0) for r in recs if r.name == "serve.call"]
    return 1e-6 * sum(own) / len(own) if own else None
