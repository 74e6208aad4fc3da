"""The port's tracer (``diffusesg_torch/utils/tracing.py``) and its spans at
the layer boundaries, on the CPU.

* Off (no profile, outside ``recording()``): ``span`` returns one shared
  null context and records nothing.
* ``recording()``: nesting and parent ids, the ``batch`` / ``step`` groups,
  the bounded buffer, the counters.
* The clock: under a ``torch.profiler`` profile each span is exported as a
  ``user_annotation`` whose ``ts`` plus the trace's
  ``baseTimeNanoseconds / 1000`` is the record's start, with its duration.
* The spans of the layers: a compiled sampling through the stand-in of
  tests/helpers/graph_stand_in.py (a ``sampler.step`` a Heun step, a capture
  a variant, a replay at each later step; ``stats()`` seconds are the spans'
  readings), a compiled training step (``step.call`` with its draws, load,
  replay and metrics), the serving entry's ``fixed_batch`` and the feed.
  The gloo pair's ``step.collective`` is read in
  tests/test_torch_compiled_train.py.
* ``/v1/stats`` returns the counters.
"""
import collections
import json
import os
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from graph_stand_in import stand_in  # noqa: E402,F401 - the fixture
from torch_parity import (SMALL_CFG, clean_batch, node_flags, tiny_overrides,  # noqa: E402
                          tiny_port_model)

from diffusesg_torch.utils import tracing  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, STEPS = 3, 6, 5


@pytest.fixture
def rec():
    """Spans on and an empty buffer; the records of the block."""
    tracing.clear()
    with tracing.recording():
        yield tracing.records
    tracing.clear()


def _children(recs, parent):
    return [r for r in recs if r.parent == parent.id]


def test_off_returns_the_shared_null_and_records_nothing():
    tracing.clear()
    assert not tracing.enabled()
    a, b = tracing.span("x"), tracing.span("y", batch=1)
    assert a is b
    with a, tracing.span("z"):
        pass
    assert tracing.records() == []
    with tracing.timed("t") as t:  # reads the clock, records nothing
        pass
    assert t.seconds >= 0 and tracing.records() == []


def test_nesting_parents_and_groups(rec):
    with tracing.span("outer", batch=7) as outer:
        with tracing.span("mid") as mid:
            with tracing.span("inner", k=1):
                pass
        with tracing.span("other", step=3):
            pass
    with tracing.span("alone"):
        pass
    got = {r.name: r for r in rec()}
    assert [r.name for r in rec()] == ["inner", "mid", "other", "outer", "alone"]
    assert got["outer"].parent is None and got["outer"].id == outer.id
    assert got["mid"].parent == outer.id and got["inner"].parent == mid.id
    assert got["inner"].attrs == {"k": 1}
    assert got["mid"].group == got["inner"].group == ("batch", 7) == got["outer"].group
    assert got["other"].group == ("step", 3) and got["alone"].group is None
    assert all(r.start <= r.end for r in rec())
    assert got["outer"].start <= got["inner"].start <= got["inner"].end <= got["outer"].end
    assert len({r.thread for r in rec()}) == 1


def test_threads_keep_their_own_parents(rec):
    def work(i):
        with tracing.span("t.outer", batch=i):
            with tracing.span("t.inner"):
                pass
    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    outer = {r.id: r for r in rec() if r.name == "t.outer"}
    inner = [r for r in rec() if r.name == "t.inner"]
    assert len(outer) == len(inner) == 4
    for r in inner:
        assert outer[r.parent].thread == r.thread and outer[r.parent].group == r.group


def test_the_buffer_is_bounded(rec, monkeypatch):
    monkeypatch.setattr(tracing, "_records", collections.deque(maxlen=3))
    for i in range(5):
        with tracing.span(f"s{i}"):
            pass
    assert [r.name for r in rec()] == ["s2", "s3", "s4"]
    tracing.clear()
    assert rec() == []


def test_counters_always_count():
    before = tracing.counters()
    assert set(tracing.COUNTERS) <= set(before)
    tracing.count("graph.replays")
    tracing.count("graph.replays", 2)
    after = tracing.counters()
    assert after["graph.replays"] == before["graph.replays"] + 3
    assert after["graph.captures"] == before["graph.captures"]


def test_spans_share_the_profiler_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.enabled()
        for i in range(3):
            with tracing.span("clock.outer", batch=i):
                torch.randn(64, 64) @ torch.randn(64, 64)
                with tracing.span("clock.inner"):
                    torch.randn(32, 32).sum()
    assert not tracing.enabled()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base_us = trace["baseTimeNanoseconds"] / 1000
    events = sorted((e for e in trace["traceEvents"]
                     if e.get("cat") == "user_annotation" and e["name"].startswith("clock.")),
                    key=lambda e: e["ts"])
    recs = sorted(tracing.records(), key=lambda r: r.start)
    tracing.clear()
    assert [e["name"] for e in events] == [r.name for r in recs] and len(recs) == 6
    for e, r in zip(events, recs):
        assert abs(e["ts"] + base_us - r.start / 1000) < 1000, (e, r)
        assert abs(e["dur"] - (r.end - r.start) / 1000) < 1000, (e, r)


def _toy_for(node_flags, *operands):
    def fn(a, x, sigmas, sc_a, sc_x):
        return torch.tanh(a + 0.1 * sc_a), torch.tanh(x - 0.2 * sc_x)
    return fn


def test_compiled_sampling_spans(rec, stand_in):
    """A compiled sampling through the stand-in: one ``sampler.step`` a
    Heun step, each holding its draws, its copy-in and either a replay or
    a variant's first use and capture; a capture a variant; the program's
    seconds are its spans'."""
    from diffusesg_torch.sampling.compiled import CompiledSampler
    from diffusesg_torch.sampling.edm_sampler import NodeAdjEDMSampler, TorchNoise
    sampler = NodeAdjEDMSampler(num_steps=STEPS, sigma_max=2.0, S_churn=40.0)
    flags = torch.from_numpy(node_flags(B, N, [6, 4, 1]))
    before = tracing.counters()
    runner = CompiledSampler(sampler)
    runner.sample(_toy_for, flags, 3, 2, noise=TorchNoise(1, "cpu"))
    (program,) = runner._programs.values()
    variants = len(program.graphs)
    recs = rec()
    steps = [r for r in recs if r.name == "sampler.step"]
    assert len(steps) == STEPS and 0 < variants < STEPS
    kinds = collections.Counter()
    for s in steps:
        names = [c.name for c in _children(recs, s)]
        assert names[:2] == ["sampler.draws", "sampler.copy_in"], names
        assert names[2:] in (["graph.replay"], ["graph.first_use", "graph.capture"]), names
        kinds[names[-1]] += 1
    assert kinds == {"graph.capture": variants, "graph.replay": STEPS - variants}
    after = tracing.counters()
    assert after["graph.captures"] - before["graph.captures"] == variants == len(stand_in)
    assert after["graph.replays"] - before["graph.replays"] == STEPS - variants
    assert after["programs.built"] - before["programs.built"] == 1
    firsts = [r for r in recs if r.name == "graph.first_use"]
    captures = [r for r in recs if r.name == "graph.capture"]
    spans = sorted(((f.end - f.start) * 1e-9, (c.end - c.start) * 1e-9)
                   for f, c in zip(firsts, captures))
    assert sorted(program.seconds.values()) == pytest.approx(spans, rel=0, abs=1e-12)


def _train_setup():
    from diffusesg_torch.config import load_config
    from diffusesg_torch.train import (create_train_state, make_optimizer, make_train_step,
                                       train_step_config_from)
    cfg = tiny_overrides(load_config(os.path.join(REPO, SMALL_CFG)))
    step_cfg = train_step_config_from(cfg)
    state = create_train_state(tiny_port_model(cfg), [0.9], make_optimizer(2e-3, 0.5, 2, 1e-2))
    n = cfg.dataset.max_node_num
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a))
                  for a in clean_batch(4, n, [min(c, n) for c in (16, 11, 5, 2)], seed=9))
    return state, make_train_step(state.model, step_cfg), batch


def test_compiled_training_step_spans(rec, stand_in):
    """Three compiled steps through the stand-in: one ``step.call`` a step,
    its group the state's step, holding the draws, the load, the one stage
    graph's replay (or first use and capture) and the metrics."""
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train.compiled import CompiledTrainStep
    state, step, batch = _train_setup()
    comp, noise = CompiledTrainStep(step), TorchNoise(3, "cpu")
    for _ in range(3):
        state, _ = comp(state, noise, *batch)
    recs = rec()
    calls = [r for r in recs if r.name == "step.call"]
    assert [c.group for c in calls] == [("step", k) for k in range(3)]
    replays = 0
    for c in calls:
        names = [r.name for r in _children(recs, c)]
        assert names[:2] == ["step.draws", "step.load"] and names[-1] == "step.metrics", names
        assert names[2:-1] in (["graph.replay"], ["graph.first_use", "graph.capture"]), names
        replays += names[2] == "graph.replay"
        assert all(r.group == c.group for r in recs if r.parent == c.id)
    (program,) = comp._programs.values()
    assert replays == 3 - len(program.graphs) > 0


def test_eager_training_step_is_one_span(rec):
    """On the CPU the compiled step runs the eager one: one ``step.call``
    a step and nothing of the graphs."""
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    from diffusesg_torch.train.compiled import CompiledTrainStep
    state, step, batch = _train_setup()
    CompiledTrainStep(step)(state, TorchNoise(3, "cpu"), *batch)
    assert [r.name for r in rec()] == ["step.call"]


def test_serving_entry_spans(rec):
    """One batch through ``fixed_batch`` on the CPU: ``serve.call`` of its
    own batch group holding the copy-in, a ``sampler.step`` a step, the
    decode and the copy back; no ``serve.wait`` off the card."""
    from diffusesg_torch.config import load_config
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.serving.export import fixed_batch, make_serving_fn
    cfg = tiny_overrides(load_config(os.path.join(REPO, SMALL_CFG)))
    with cfg.unlocked():
        cfg.mcmc.num_steps = 3
    n = cfg.dataset.max_node_num
    serve = fixed_batch(make_serving_fn(tiny_port_model(cfg).eval(), get_mc_sampler(cfg), cfg),
                        2, n, "cpu")
    for seed in (1, 2):
        serve(seed, node_flags(2, n, [n, 2]))
    recs = rec()
    calls = [r for r in recs if r.name == "serve.call"]
    assert len(calls) == 2 and calls[0].group != calls[1].group
    assert calls[0].group[0] == "batch"
    for c in calls:
        names = [r.name for r in recs if r.group == c.group and r is not c]
        assert names == (["serve.copy_in"] + ["sampler.draws", "sampler.step"] * 3
                         + ["serve.decode", "serve.copy_back"]), names
        assert all(r.parent == c.id for r in recs
                   if r.group == c.group and r.name.startswith("serve.") and r is not c)


def test_feed_spans(rec):
    """``prefetch_to_device`` on the CPU: a ``data.batch`` and a
    ``data.stage`` a batch, and one ``data.batch`` that finds the source
    at its end."""
    from diffusesg_torch.data import prefetch_to_device
    items = [(np.full((2, 3), i, np.float32),) for i in range(4)]
    got = list(prefetch_to_device(iter(items), "cpu", transform=lambda it: (it[0] * 2,)))
    assert [float(t[0][0, 0]) for t in got] == [0.0, 2.0, 4.0, 6.0]
    names = collections.Counter(r.name for r in rec())
    assert names == {"data.batch": 5, "data.stage": 4}


def test_stats_endpoint_returns_the_counters():
    """``/v1/stats`` holds the port's counters beside the server's own."""
    from diffusesg_torch.serving import server

    def fn(seed, flags):
        b, n = flags.shape
        return (np.zeros((b, n, n), np.int32), np.zeros((b, n), np.int32),
                np.zeros((b, n, 4), np.float32))
    batcher = server.BatchingSampler(fn, 4, 5, linger_ms=1.0)
    httpd = server.serve(batcher, 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        batcher.generate(2, 3)
        tracing.count("graph.captures")
        want = tracing.counters()
        url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/stats"
        with urllib.request.urlopen(url, timeout=30) as r:
            stats = json.load(r)
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    assert stats["batches"] == 1 and stats["graphs"] == 2
    assert {k: stats[k] for k in tracing.COUNTERS} == {k: want[k] for k in tracing.COUNTERS}
    assert stats["graph.captures"] >= 1
