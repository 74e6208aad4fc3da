"""The serving slice on the CPU: the port's serving and completion cores
against the JAX package's ``make_serving_fn`` / ``make_completion_fn`` on
shared weights and shared draws (``torch_parity.JaxKeyNoise``), padded rows
included; ``chunk_steps``; the JAX server's batcher and HTTP scenarios
through both packages' ``BatchingSampler`` with equal answers; the sampler
artifact and ``cli.serve``; ``utils/perf.py`` against the JAX one.

The model is ``configs/vg_small_test.yaml`` at max_node_num 8, 4 steps and
batch 4, as tests/test_serving.py runs it, with the randomized weights of
``torch_parity.model_pair``.
"""
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_parity import COCO_CFG, VG_CFG, JaxKeyNoise, model_pair, node_flags  # noqa: E402
from test_serving import _fake_complete_fn, _fake_fn  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CFG = os.path.join(REPO, "configs", "vg_small_test.yaml")
B, N, STEPS, SEED = 4, 8, 4, 7
# continuous samples / boxes after 4 Heun steps at fp32 (tests/test_torch_slice.py:23)
SAMPLE_ATOL = 1e-3
# boxes of one batch of rows against a batch of another size, fp32 on the CPU
PAD_ATOL = 1e-5
# the toy tanh denoiser of tests/test_sampler.py's chunk test: fp32, 12 steps
CHUNK_ATOL = 1e-5


def _tiny(load_config, path=SMALL_CFG):
    cfg = load_config(path)
    with cfg.unlocked():
        cfg.dataset.max_node_num = N
        cfg.mcmc.num_steps = STEPS
        cfg.test.batch_size = B
    return cfg


@pytest.fixture(scope="module")
def pair():
    """(JAX config, port config, flax module, flax params, port model)."""
    from diffusesg_tpu.config import load_config as jload
    from diffusesg_torch.config import load_config as tload
    jcfg, tcfg = _tiny(jload), _tiny(tload)
    jm, params, tm = model_pair(jcfg, tcfg)
    return jcfg, tcfg, jm, params, tm


@pytest.fixture(scope="module")
def jax_serving(pair):
    from diffusesg_tpu.sampling import get_mc_sampler
    from diffusesg_tpu.serving.export import make_serving_fn
    jcfg, _, jm, params, _ = pair
    return jax.jit(make_serving_fn(jm, params, get_mc_sampler(jcfg), jcfg))


def _port_serving(pair, **kw):
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.serving.export import make_serving_fn
    _, tcfg, _, _, tm = pair
    return make_serving_fn(tm, get_mc_sampler(tcfg), tcfg, **kw)


def _known_parts():
    """Pinned node types (0, 1), one pinned box (node 0), one pinned edge."""
    kn = np.zeros((B, N), np.int32)
    mn = np.zeros((B, N), bool)
    kb = np.full((B, N, 4), 0.5, np.float32)
    mb = np.zeros((B, N), bool)
    ka = np.zeros((B, N, N), np.int32)
    ma = np.zeros((B, N, N), bool)
    kn[:, 0], mn[:, 0] = 3, True
    kb[:, 0], mb[:, 0] = [0.25, 0.25, 0.1, 0.2], True
    kn[:, 1], mn[:, 1] = 1, True  # type pinned, box free
    ka[:, 0, 1], ma[:, 0, 1] = 2, True
    return kn, mn, kb, mb, ka, ma


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# --------------------------------------------------- (a) the completion core

def test_completion_core_matches_jax(pair):
    from diffusesg_tpu.sampling import get_mc_sampler as jsampler
    from diffusesg_tpu.serving.export import make_completion_fn as jcomplete
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.serving.export import make_completion_fn
    jcfg, tcfg, jm, params, tm = pair
    flags = node_flags(B, N, [8, 6, 5, 3])
    known = _known_parts()
    want = [np.asarray(v) for v in jax.jit(jcomplete(jm, params, jsampler(jcfg), jcfg))(
        np.int32(SEED), flags, *known)]

    noise = JaxKeyNoise(SEED, STEPS, inpaint=True)
    got = [v.numpy() for v in make_completion_fn(tm, get_mc_sampler(tcfg), tcfg)(
        SEED, *_t((flags,) + known), noise=noise)]
    assert {k for _, k in noise.requests} == {"init_adj", "init_node", "churn_adj",
                                              "churn_node", "inpaint_adj", "inpaint_node"}
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=SAMPLE_ATOL)
    adj, node, bbox = got
    assert (node[:, 0] == 3).all() and (node[:, 1] == 1).all() and (adj[:, 0, 1] == 2).all()
    np.testing.assert_allclose(bbox[:, 0], [[0.25, 0.25, 0.1, 0.2]] * B, atol=1e-5)


# ----------------------------------------------------- (b) padded batches

def test_padded_batch_matches_jax_and_padding_is_inert(pair, jax_serving):
    """Counts [8, 5, 0, 0]: equal to the JAX serving core and the all-False
    rows zero; rows 0-1 bit-equal to the same batch with rows 2-3 filled
    instead (the same draws), and to an unpadded batch of rows 0-1 under the
    padded batch's draws in their integers, its boxes within PAD_ATOL (a
    batch of another size blocks the CPU's fp32 products otherwise)."""
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    flags = node_flags(B, N, [8, 5])
    want = [np.asarray(v) for v in jax_serving(np.int32(SEED), flags)]
    serve = _port_serving(pair)
    got = [v.numpy() for v in serve(SEED, torch.from_numpy(flags),
                                    noise=JaxKeyNoise(SEED, STEPS))]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=SAMPLE_ATOL)
    for part in got:
        assert not part[2:].any()

    class Rows:  # the padded batch's draws, rows 0-1 only
        def __init__(self, noise):
            self.noise = noise

        def normal(self, step, kind, shape):
            return self.noise.normal(step, kind, (B,) + tuple(shape[1:]))[:2]

    padded = serve(SEED, torch.from_numpy(flags), noise=TorchNoise(SEED, "cpu"))
    filled = serve(SEED, torch.from_numpy(node_flags(B, N, [8, 5, 8, 3])),
                   noise=TorchNoise(SEED, "cpu"))
    alone = serve(SEED, torch.from_numpy(flags[:2]), noise=Rows(TorchNoise(SEED, "cpu")))
    for p, f in zip(padded, filled):
        assert torch.equal(p[:2], f[:2])
    assert torch.equal(padded[0][:2], alone[0]) and torch.equal(padded[1][:2], alone[1])
    np.testing.assert_allclose(padded[2][:2].numpy(), alone[2].numpy(), rtol=0, atol=PAD_ATOL)


# ------------------------------------------------------------ (c) chunk_steps

def test_chunked_sampling_matches_unchunked_and_jax():
    """tests/test_sampler.py's chunk test through both samplers: the port's
    chunked run bit-equal to its unchunked one, both within CHUNK_ATOL of
    the JAX package's chunked run under the same draws."""
    import jax.numpy as jnp

    from diffusesg_tpu.sampling.edm_sampler import NodeAdjEDMSampler as JSampler
    from diffusesg_torch.sampling.edm_sampler import NodeAdjEDMSampler
    flags = np.ones((2, 8), bool)
    key = jax.random.PRNGKey(0)
    want = JSampler(num_steps=12, symmetric_noise=False).sample(
        lambda a, x, s, sa, sx: (jnp.tanh(a), jnp.tanh(x)), key, jnp.asarray(flags), 3, 1,
        chunk_steps=5)
    sampler = NodeAdjEDMSampler(num_steps=12, symmetric_noise=False)
    runs = [sampler.sample(lambda a, x, s, sa, sx: (torch.tanh(a), torch.tanh(x)),
                           torch.from_numpy(flags), 3, 1, noise=JaxKeyNoise(key, 12),
                           chunk_steps=chunk) for chunk in (None, 5)]
    for whole, chunked, ref in zip(*runs, want):
        assert torch.equal(whole, chunked)
        np.testing.assert_allclose(chunked.numpy(), np.asarray(ref), atol=CHUNK_ATOL)
    with pytest.raises(ValueError, match="chunk_steps"):
        sampler.sample(lambda *a: a[:2], torch.from_numpy(flags), 3, 1, chunk_steps=0)


def test_chunked_serving_core_is_bit_equal(pair):
    from diffusesg_torch.config import load_config
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.serving.export import make_serving_fn
    _, _, _, _, tm = pair
    cfg = _tiny(load_config)
    with cfg.unlocked():
        cfg.mcmc.num_steps = 12
    flags = torch.from_numpy(node_flags(B, N, [8, 5, 3]))
    sampler = get_mc_sampler(cfg)
    whole = make_serving_fn(tm, sampler, cfg)(3, flags)
    chunked = make_serving_fn(tm, sampler, cfg, chunk_steps=5)(3, flags)
    for w, c in zip(whole, chunked):
        assert torch.equal(w, c)


# ---------------------------------- (d) the JAX server's scenarios, both packages

def _http(base, path, payload=None):
    """(status, JSON body without its latency) of one request."""
    req = urllib.request.Request(
        base + path, data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            code, body = r.status, json.load(r)
    except urllib.error.HTTPError as e:
        code, body = e.code, json.load(e)
    body.pop("latency_ms", None)
    return code, body


def _with_http(mod, batcher, fn, idx_to_word=None):
    httpd = mod.serve(batcher, 0, idx_to_word)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        return fn(f"http://127.0.0.1:{httpd.server_address[1]}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()


def _pack_split(mod):
    b = mod.BatchingSampler(_fake_fn, batch_size=8, max_node_num=6, linger_ms=200.0)
    try:
        results = [None, None]

        def call(i, k, nn):
            results[i] = b.generate(k, nn)
        threads = [threading.Thread(target=call, args=(0, 3, 4)),
                   threading.Thread(target=call, args=(1, 2, [2, 6]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        assert b.stats["batches"] == 1 and b.stats["requests"] == 2
        assert len(results[1][1]["edges"]) == 6 * 5
        return results
    finally:
        b.close()


def _seeded(mod):
    b = mod.BatchingSampler(_fake_fn, batch_size=4, max_node_num=5, linger_ms=1.0)
    try:
        r1, r2, r3 = b.generate(1, 3, seed=42), b.generate(1, 3, seed=42), b.generate(1, 3)
        assert r1 == r2 and r1[0]["nodes"] == [42, 42, 42] and r3[0]["nodes"] != [42] * 3
        return r1, r2, r3
    finally:
        b.close()


def _validation(mod):
    b = mod.BatchingSampler(_fake_fn, batch_size=4, max_node_num=5, linger_ms=1.0)
    try:
        errors = []
        for args in ((5, 3), (1, 9), (2, [1, 2, 3])):
            with pytest.raises(ValueError) as e:
                b.generate(*args)
            errors.append(str(e.value))
        return errors
    finally:
        b.close()


def _http_end_to_end(mod):
    b = mod.BatchingSampler(_fake_fn, batch_size=4, max_node_num=5, linger_ms=1.0)
    idx_to_word = {"ind_to_classes": [f"cls{i}" for i in range(100)],
                   "ind_to_predicates": ["none", "on"]}

    def run(base):
        out = [_http(base, "/healthz"),
               _http(base, "/v1/generate", {"num_graphs": 2, "num_nodes": [3, 2], "seed": 5}),
               _http(base, "/v1/generate", {"num_graphs": 99}),
               _http(base, "/nope")]
        code, stats = _http(base, "/v1/stats")
        assert code == 200 and "latency_ms_p50" in stats
        # the port's server adds its counters of graphs and programs, which
        # the JAX server has not: the rest must be equal
        from diffusesg_torch.utils.tracing import COUNTERS
        if mod.__name__.startswith("diffusesg_torch"):
            assert set(COUNTERS) <= set(stats)
        out.append({k: v for k, v in stats.items()
                    if not k.startswith("latency") and k not in COUNTERS})
        assert out[1][1]["graphs"][0]["node_names"] == ["cls5"] * 3 and out[2][0] == 400
        return out
    return _with_http(mod, b, run, idx_to_word)


def _complete_route(mod):
    b = mod.BatchingSampler(_fake_fn, batch_size=4, max_node_num=5, linger_ms=1.0,
                            complete_fn=_fake_complete_fn)

    def run(base):
        g = b.complete(4, known_nodes=[{"index": 0, "type": 9},
                                       {"index": 1, "bbox": [0.1, 0.2, 0.3, 0.4]}],
                       known_edges=[[0, 1, 7]], seed=5)
        assert g["nodes"][0] == 9 and [0, 1, 7] in g["edges"]
        out = [g, _http(base, "/v1/complete", {"num_nodes": 3, "seed": 2,
                                               "known_nodes": [{"index": 2, "type": 8}],
                                               "known_edges": [[2, 0, 3]]}),
               _http(base, "/v1/complete", {"num_nodes": 3,
                                            "known_nodes": [{"index": 7, "type": 1}]})]
        assert out[1][1]["graphs"][0]["nodes"] == [2, 2, 8] and out[2][0] == 400
        return out
    return _with_http(mod, b, run)


def _artifact_mode_501(mod):
    b = mod.BatchingSampler(_fake_fn, batch_size=4, max_node_num=5, linger_ms=1.0)

    def run(base):
        with pytest.raises(RuntimeError, match="completion unavailable") as e:
            b.complete(3)
        out = [str(e.value), _http(base, "/v1/complete", {"num_nodes": 3})]
        assert out[1][0] == 501
        return out
    return _with_http(mod, b, run)


def _label_bounds(mod):
    b = mod.BatchingSampler(_fake_fn, batch_size=4, max_node_num=5, linger_ms=1.0,
                            complete_fn=_fake_complete_fn, num_node_types=10, num_edge_types=5)
    try:
        errors = []
        for kw in (dict(known_nodes=[{"index": 0, "type": 10}]),
                   dict(known_edges=[[0, 1, 5]]), dict(known_nodes=[{"index": 0, "type": -1}]),
                   dict(known_nodes=[{"index": 0, "bbox": [0, 0, 2, 0]}]),
                   dict(known_edges=[[1, 1, 1]])):
            with pytest.raises(ValueError) as e:
                b.complete(3, **kw)
            errors.append(str(e.value))
        g = b.complete(3, known_edges=[[0, 1, 0]], seed=1)
        assert [0, 1, 0] not in g["edges"]
        return errors, g
    finally:
        b.close()


SCENARIOS = {"pack_split": _pack_split, "seeded": _seeded, "validation": _validation,
             "http_end_to_end": _http_end_to_end, "complete_route": _complete_route,
             "artifact_mode_501": _artifact_mode_501, "label_bounds": _label_bounds}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_batcher_scenarios_answer_as_the_jax_server(name):
    from diffusesg_tpu.serving import server as jserver
    from diffusesg_torch.serving import server as tserver
    assert SCENARIOS[name](tserver) == SCENARIOS[name](jserver)


# ------------------------------------------------------- (e) the artifact

class _FakeExported:
    """The attributes of a jax.export.Exported that save_artifact reads."""
    platforms, nr_devices, in_avals, out_avals = ("cpu",), 1, ("a",), ("b",)

    def serialize(self):
        return b""


def test_artifact_round_trip_and_its_guards(pair, tmp_path):
    from diffusesg_tpu.serving.export import save_artifact as jsave
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.sampling.edm_sampler import NodeAdjEDMSampler
    from diffusesg_torch.serving.export import (export_sampler, fixed_batch, load_artifact,
                                                save_artifact)
    jcfg, tcfg, _, _, tm = pair
    art = str(tmp_path / "art")
    save_artifact(art, export_sampler(tm, get_mc_sampler(tcfg), tcfg, B), tcfg, B)
    jsave(str(tmp_path / "jax_art"), _FakeExported(), jcfg, B)
    with open(os.path.join(art, "meta.json")) as f:
        meta = json.load(f)
    with open(tmp_path / "jax_art" / "meta.json") as f:
        jmeta = json.load(f)
    assert list(meta) == list(jmeta)
    assert meta["format"] == "diffusesg_torch.serving/1" and meta["platforms"] == ["cpu"]
    assert meta["in_avals"] == ["int32[]", f"bool[{B},{N}]"]
    for k in ("batch_size", "max_node_num", "dataset", "node_encoding", "edge_encoding",
              "num_steps"):
        assert meta[k] == jmeta[k], k

    fn, got_meta = load_artifact(art, device="cpu")
    assert got_meta == meta
    live = fixed_batch(_port_serving(pair), B, N, "cpu")
    flags = node_flags(B, N, [8, 4, 1])
    for a, b in zip(fn(3, flags), live(3, flags)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        fn(3, flags[:2])
    with pytest.raises(ValueError, match="shape"):
        fn(3, np.ones((B, N + 1), bool))
    with pytest.raises(ValueError, match="sampler differs"):
        export_sampler(tm, NodeAdjEDMSampler(num_steps=9), tcfg, B)

    for platforms, ndev, match in ((["cuda"], 1, "exported for platforms"),
                                   (["cpu"], 2, "spans 2 devices")):
        with open(os.path.join(art, "meta.json"), "w") as f:
            json.dump(dict(meta, platforms=platforms, num_devices=ndev), f)
        with pytest.raises(RuntimeError, match=match):
            load_artifact(art, device="cpu")


def _port_run_dir(tmp_path, tcfg, model):
    """A port run dir (config.yaml + models_ckpt/00000.pt) whose EMAs differ."""
    from diffusesg_torch.config import save_config
    from diffusesg_torch.train import create_train_state, make_optimizer
    from diffusesg_torch.utils.checkpoint import save_checkpoint
    run = tmp_path / "run"
    os.makedirs(run)
    save_config(tcfg, str(run / "config.yaml"))
    state = create_train_state(model, list(tcfg.train.ema_coef), make_optimizer(1e-4, 1.0, 1))
    with torch.no_grad():
        for k, ema in enumerate(state.ema_params):
            torch._foreach_mul_(ema, 1.0 + 0.1 * (k + 1))
    save_checkpoint(str(run / "models_ckpt" / "00000"), state, {"epoch": 0})
    return str(run), state


def test_serve_cli_exports_and_the_artifact_serves_the_chosen_ema(pair, tmp_path):
    from diffusesg_torch.cli.serve import main as serve_main
    from diffusesg_torch.models import make_model
    from diffusesg_torch.serving.export import fixed_batch, load_artifact
    _, tcfg, _, _, tm = pair
    model = make_model(tcfg)
    model.load_state_dict(tm.state_dict())
    run, state = _port_run_dir(tmp_path, tcfg, model)
    art = str(tmp_path / "art")
    serve_main(["-p", run, "--export_to", art, "--batch_size", "2", "--device", "cpu"])
    fn, meta = load_artifact(art, device="cpu")
    assert meta["batch_size"] == 2 and meta["platforms"] == ["cpu"]
    # the default EMA is the largest beta's
    top = int(np.argmax(state.ema_betas))
    with torch.no_grad():
        for p, e in zip(model.parameters(), state.ema_params[top]):
            p.copy_(e)
    live = fixed_batch(_port_serving(pair[:4] + (model,)), 2, N, "cpu")
    flags = node_flags(2, N, [8, 3])
    for a, b in zip(fn(1, flags), live(1, flags)):
        np.testing.assert_array_equal(a, b)
    assert not fn(1, flags)[1][1, 3:].any()
    with pytest.raises(SystemExit, match="--devices 2 but only 1 local devices"):
        serve_main(["-p", run, "--export_to", art, "--devices", "2", "--device", "cpu"])


def test_serve_ema_choice():
    """--ema as diffusesg_tpu/cli/serve.py:104-111 reads it: the largest beta
    by default, 'none' the raw weights, a value the nearest beta."""
    from diffusesg_torch.cli.serve import ema_index
    betas = [0.9, 0.99, 0.999]
    assert [ema_index(betas, e) for e in (None, "none", "0.99", "0.993", "0.9999")] == \
        [2, -1, 1, 1, 2]
    assert ema_index([], None) == -1


# ---------------------------------------------------------- (g) utils/perf.py

@pytest.mark.parametrize("path", [VG_CFG, COCO_CFG, "configs/vg_small_test.yaml"])
def test_flops_estimate_matches_jax(path):
    from diffusesg_tpu.config import load_config as jload
    from diffusesg_tpu.utils.perf import estimate_model_flops as jflops
    from diffusesg_torch.config import load_config as tload
    from diffusesg_torch.utils.perf import estimate_model_flops
    path = os.path.join(REPO, path)
    got, want = estimate_model_flops(tload(path)), jflops(jload(path))
    assert got == want and got["total"] > 0


def test_peak_table_holds_the_h100_only():
    from diffusesg_torch.utils.perf import device_memory_stats, device_peak_tflops
    assert device_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert device_peak_tflops("NVIDIA H100 80GB HBM3", "float32") is None
    assert device_peak_tflops("TPU v5 lite") is None
    if not torch.cuda.is_available():
        assert device_memory_stats() == {}


def test_server_takes_a_burst_past_the_default_backlog():
    """32 connections at once: the port's server listens with a backlog of
    128 (socketserver's default, 5, drops the rest for a second), and every
    request is answered."""
    from concurrent.futures import ThreadPoolExecutor

    from diffusesg_torch.serving import server

    def run(base):
        with ThreadPoolExecutor(32) as pool:
            return list(pool.map(lambda i: _http(base, "/v1/generate",
                                                 {"num_graphs": 2, "num_nodes": 3}), range(32)))
    answers = _with_http(server, server.BatchingSampler(_fake_fn, 64, 5, linger_ms=50.0), run)
    assert server._HTTPServer.request_queue_size == 128
    assert [code for code, _ in answers] == [200] * 32
    assert all(len(body["graphs"]) == 2 for _, body in answers)
