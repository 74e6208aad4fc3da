"""Host milliseconds per training step in the compiled step's call: the
mean length of the program's ``step.call`` spans (``train/compiled.py``:
the draws, the copies into the static buffers, the replays, the collective
stages and the metrics' copies) in the traced sub-window.  A program
without the tracer gives nothing."""


def read(ctx, data):
    try:
        from diffusesg_torch.utils import tracing
    except ImportError:
        return None
    ns = [r.end - r.start for r in tracing.records() if r.name == "step.call"]
    return 1e-6 * sum(ns) / len(ns) if ns else None
