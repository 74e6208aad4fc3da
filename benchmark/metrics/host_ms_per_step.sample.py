"""Host milliseconds of the program's own work per Heun step in the
sampler's loop: the mean over the program's ``sampler.step`` spans
(``sampling/edm_sampler.py``'s ``run_loop``: the step's host facts, draws,
copies into the compiled program's buffers and the graph's launch) of the
span less the time its ``graph.replay`` spans waited for room in the
launch queue.

Once the host runs a full queue ahead of the card, ``graph.replay``
blocks until the card frees a slot, and a step's span reads the card's
pace.  A launch that does not wait takes what the first steps of a batch
take, when the queue is still empty: so each replay counts at most the
median ``graph.replay`` of the first ``UNBLOCKED`` steps of its batch, and
the rest of it is the card's time.  Under the profile the wait falls on the
graph's launch; a wait that fell on another launch of the step (a draw, a
copy) would still count as the host's.  The program records spans only
while the profile is on, so its buffer holds the traced sub-window; a
program without the tracer gives nothing."""
import statistics

UNBLOCKED = 8  # steps at a batch's start, well under the ~20 a queue holds


def read(ctx, data):
    try:
        from diffusesg_torch.utils import tracing
    except ImportError:
        return None
    recs = tracing.records()
    steps = sorted((r for r in recs if r.name == "sampler.step"), key=lambda r: r.start)
    if not steps:
        return None
    replays = {}
    for r in recs:
        if r.name == "graph.replay":
            replays.setdefault(r.parent, []).append(r.end - r.start)
    first = {}
    for s in steps:
        seen = first.setdefault(s.group, [])
        if len(seen) < UNBLOCKED:
            seen.extend(replays.get(s.id, ()))
    launch = {g: statistics.median(ns) for g, ns in first.items() if ns}
    own = 0
    for s in steps:
        waited = sum(max(0, ns - launch[s.group]) for ns in replays.get(s.id, ()))
        own += s.end - s.start - waited
    return 1e-6 * own / len(steps)
