"""The readers of the program's spans (``metrics/host_ms_per_step.*``,
``entry_ms_per_batch.sample``, ``feed_ms_per_step.train``): their numbers
from a fake buffer of records, nothing from a program without the tracer,
and a finite, positive number from a traced run at a tiny size."""
import math
import sys
import time

import pytest
import torch

from benchlib import cells
from conftest import tiny

SEED = 2 ** 33 + 777


def _rec(name, start_ms, end_ms, group=None, parent=None, id=0):
    from diffusesg_torch.utils.tracing import Record
    return Record(name, int(start_ms * 1e6), int(end_ms * 1e6), id, parent, 1, group, {})


# two batches: 100 ms and 60 ms long, their steps 2 x 30 and 1 x 40 ms, a
# wait of 10 ms in the first; a copy-in outside the steps.  The first
# batch's replays take 2 and 20 ms (median 11: the second waited 9 ms), the
# second's one 30 ms (its own median: no wait)
FAKE = [
    _rec("serve.copy_in", 0, 1, ("batch", 0)),
    _rec("graph.replay", 5, 7, ("batch", 0), parent=1),
    _rec("sampler.step", 1, 31, ("batch", 0), id=1),
    _rec("graph.replay", 35, 55, ("batch", 0), parent=2),
    _rec("sampler.step", 31, 61, ("batch", 0), id=2),
    _rec("serve.wait", 70, 80, ("batch", 0)),
    _rec("serve.call", 0, 100, ("batch", 0)),
    _rec("graph.replay", 115, 145, ("batch", 1), parent=3),
    _rec("sampler.step", 110, 150, ("batch", 1), id=3),
    _rec("serve.call", 100, 160, ("batch", 1)),
    _rec("data.batch", 200, 212),
    _rec("data.stage", 212, 215),
    _rec("data.batch", 300, 305),
    _rec("step.call", 215, 235, ("step", 5)),
    _rec("step.call", 305, 315, ("step", 6)),
]


@pytest.mark.parametrize("name, ctx, want", [
    ("host_ms_per_step.sample", {}, (30 + (30 - 9) + 40) / 3),
    ("entry_ms_per_batch.sample", {}, ((100 - 60 - 10) + (60 - 40)) / 2),
    ("host_ms_per_step.train", {}, (20 + 10) / 2),
    ("feed_ms_per_step.train", {"train_steps": 2}, (12 + 3 + 5) / 2),
])
def test_reader_on_fake_records(name, ctx, want, monkeypatch):
    from diffusesg_torch.utils import tracing
    monkeypatch.setattr(tracing, "records", lambda: list(FAKE))
    read, data = cells.reader(name)
    assert read(ctx, data) == pytest.approx(want)
    monkeypatch.setattr(tracing, "records", lambda: [])
    assert read(ctx, data) is None


def test_host_ms_per_step_sample_leaves_out_the_wait_for_the_queue(monkeypatch):
    """A batch of 12 steps of 2 ms of host work: the first 8 launch in 1 ms,
    the last 4 wait 15 ms more for room in the launch queue.  The reader
    gives the host's 2 ms, not the card's pace."""
    from diffusesg_torch.utils import tracing
    recs, t = [], 0.0
    for i in range(12):
        launch = 1 if i < 8 else 16
        recs.append(_rec("graph.replay", t + 1, t + 1 + launch, ("batch", 0), parent=i + 1))
        recs.append(_rec("sampler.step", t, t + 1 + launch, ("batch", 0), id=i + 1))
        t += 1 + launch
    monkeypatch.setattr(tracing, "records", lambda: recs)
    read, data = cells.reader("host_ms_per_step.sample")
    assert read({}, data) == pytest.approx(2.0)


@pytest.mark.parametrize("name", ["host_ms_per_step.sample", "entry_ms_per_batch.sample",
                                  "host_ms_per_step.train", "feed_ms_per_step.train"])
def test_reader_without_the_tracer_gives_nothing(name, monkeypatch):
    """A program that has no tracer (as before it had one): no number and
    no error, so the line leaves the metric out."""
    import diffusesg_torch.utils as utils
    monkeypatch.delattr(utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "diffusesg_torch.utils.tracing", None)
    read, data = cells.reader(name)
    assert read({"train_steps": 4}, data) is None


@pytest.mark.parametrize("cell, names", [
    ("vg.sample", ["host_ms_per_step.sample", "entry_ms_per_batch.sample"]),
    ("vg.train", ["host_ms_per_step.train", "feed_ms_per_step.train"]),
])
def test_traced_run_prints_the_span_metrics(cell, names):
    import run
    from diffusesg_torch.utils import tracing
    tracing.clear()
    c = tiny(cell)
    res = c.driver().run(c, SEED, 0.3, True, torch.device("cpu"), time.time(), None)
    line = run.result_line(c, res, True, "cpu")
    tracing.clear()
    assert line["correct"], line["checks"]
    for n in names:
        v = line["metrics"][n]["value"]
        assert math.isfinite(v) and v > 0, (n, v)
