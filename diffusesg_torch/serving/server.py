"""Micro-batching scene-graph generation server.

The port's own copy of diffusesg_tpu/serving/server.py (numpy, the
standard library and the port's counters; the port imports nothing of the
JAX package): the same requests give the same JSON, given the same sample
function, but ``/v1/stats``, which adds the port's counters.  It
listens with a backlog of 128 connections where the JAX server keeps
socketserver's 5.  The
reference has no server; generation there is a batch eval run.  Design:

* ONE sampler runs at a fixed batch size (``serving.export.fixed_batch``,
  as the JAX package's compiled program does); the server packs concurrent
  requests into that batch.  A request asks
  for ``num_graphs`` graphs with chosen (or dataset-default) node counts;
  slots the batch doesn't fill get all-False node flags (masked noise is
  exactly zero work for the model — the same padding the trainer uses).
* The batcher lingers ``linger_ms`` after the first pending request so
  bursts coalesce, then runs the batch on device and splits results.
* Seeded requests are deterministic: a request carrying ``seed`` gets a
  batch of its own (noise is drawn per-batch from one key, so sharing a
  batch would couple its randomness to its neighbors).

HTTP surface (stdlib ThreadingHTTPServer; JSON in/out):

  POST /v1/generate   {"num_graphs": 4, "num_nodes": 12 | [12, 5, ...],
                       "seed": 123?}  ->  {"graphs": [...], "latency_ms": ..}
  POST /v1/complete   {"num_nodes": 12, "seed"?,
                       "known_nodes": [{"index", "type"?, "bbox"?}, ...],
                       "known_edges": [[subj, obj, predicate], ...]}
                      -> one graph with the pinned parts verbatim
                      (conditional completion; live checkpoint mode only)
  GET  /healthz       liveness + served-batch info
  GET  /v1/stats      request/graph/batch counters, latency quantiles, and
                      the port's counters of graph captures, replays and
                      programs built (utils/tracing.py), where a server
                      whose shapes churn shows its recaptures

Each graph is {"nodes": [int], "node_names": [str]?, "bboxes": [[cx,cy,w,h]],
"edges": [[subj, obj, predicate], ...], "edge_names": [...]?}.
"""
from __future__ import annotations

import json
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..utils import tracing


@dataclass
class _Request:
    flags: np.ndarray            # [k, N] bool
    seed: int | None
    kind: str = "gen"            # "gen" | "complete"
    tensors: tuple | None = None  # completion: (kn, mn, kb, mb, ka, ma)
    done: threading.Event = field(default_factory=threading.Event)
    result: list | None = None
    error: str | None = None


class BatchingSampler:
    """Packs concurrent generation requests into fixed-size device batches.

    ``sample_fn(seed:int32, flags:[B,N] bool) -> (adj[B,N,N] i32,
    node[B,N] i32, bbox[B,N,4] f32)``: the numpy contract of
    serving.export (``fixed_batch`` over a live model, or ``load_artifact``).
    The worker thread calls it, so the card's kernels launch from there.
    """

    def __init__(self, sample_fn, batch_size: int, max_node_num: int,
                 base_seed: int = 0, linger_ms: float = 10.0,
                 complete_fn=None, num_node_types: int | None = None,
                 num_edge_types: int | None = None):
        self._fn = sample_fn
        # optional conditional-completion fn (serving.export.make_completion_fn
        # under fixed_batch; live mode only: the artifact does not carry it)
        self._complete_fn = complete_fn
        # label-count bounds for request validation (when known): pinning an
        # out-of-range type would silently encode to garbage, breaking the
        # "pinned parts come back verbatim" contract
        self._num_node_types = num_node_types
        self._num_edge_types = num_edge_types
        self.batch_size = batch_size
        self.max_node_num = max_node_num
        self._linger = linger_ms / 1e3
        self._q: queue.Queue[_Request] = queue.Queue()
        self._counter = base_seed
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "graphs": 0, "batches": 0,
                      "latencies_ms": []}
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._stop = threading.Event()
        self._worker.start()

    def warmup(self):
        """Run one batch (and one completion batch when completion is
        available) before serving traffic: the first call builds the card's
        kernels with nvcc, and a build failure raises here."""
        flags = np.zeros((self.batch_size, self.max_node_num), bool)
        flags[:, :1] = True
        self._call(0, flags)
        if self._complete_fn is not None:
            # the completion path too, so the first /v1/complete pays no
            # first-use cost
            n = self.max_node_num
            req = _Request(
                flags=flags[:1], seed=0, kind="complete",
                tensors=(np.zeros((1, n), np.int32), np.zeros((1, n), bool),
                         np.full((1, n, 4), 0.5, np.float32),
                         np.zeros((1, n), bool),
                         np.zeros((1, n, n), np.int32),
                         np.zeros((1, n, n), bool)))
            self._call_complete(0, req)

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)

    # ---------------------------------------------------------------- client
    def generate(self, num_graphs: int, num_nodes, seed: int | None = None,
                 timeout: float = 600.0) -> list:
        """Blocking generate; returns a list of per-graph result dicts."""
        if not 1 <= num_graphs <= self.batch_size:
            raise ValueError(f"num_graphs must be in [1, {self.batch_size}]")
        counts = (np.full(num_graphs, num_nodes, int)
                  if np.isscalar(num_nodes) else np.asarray(num_nodes, int))
        if len(counts) != num_graphs:
            raise ValueError("len(num_nodes) must equal num_graphs")
        if counts.min() < 1 or counts.max() > self.max_node_num:
            raise ValueError(f"num_nodes must be in [1, {self.max_node_num}]")
        flags = np.zeros((num_graphs, self.max_node_num), bool)
        for i, c in enumerate(counts):
            flags[i, :c] = True
        req = _Request(flags=flags, seed=seed)
        self._q.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("generation timed out")
        if req.error:
            raise RuntimeError(req.error)
        return req.result

    def complete(self, num_nodes: int, known_nodes: list | None = None,
                 known_edges: list | None = None, seed: int | None = None,
                 timeout: float = 600.0) -> dict:
        """Blocking conditional completion of ONE graph.

        ``known_nodes``: [{"index": i, "type": t?, "bbox": [cx,cy,w,h]?}]
        — type and bbox knowledge are independent.  ``known_edges``:
        [[subj, obj, predicate], ...].  Everything not pinned is sampled;
        pinned values come back verbatim (RePaint-style inpainting,
        serving/export.make_completion_fn).
        """
        if self._complete_fn is None:
            raise RuntimeError("completion unavailable: server was started "
                               "from a generation artifact (live checkpoint "
                               "mode required)")
        n = self.max_node_num
        num_nodes = int(num_nodes)
        if not 1 <= num_nodes <= n:
            raise ValueError(f"num_nodes must be in [1, {n}]")
        flags = np.zeros((1, n), bool)
        flags[0, :num_nodes] = True
        kn = np.zeros((1, n), np.int32)
        mn = np.zeros((1, n), bool)
        kb = np.full((1, n, 4), 0.5, np.float32)
        mb = np.zeros((1, n), bool)
        ka = np.zeros((1, n, n), np.int32)
        ma = np.zeros((1, n, n), bool)
        for item in known_nodes or []:
            i = int(item["index"])
            if not 0 <= i < num_nodes:
                raise ValueError(f"node index {i} out of range [0, {num_nodes})")
            if item.get("type") is not None:
                t = int(item["type"])
                if t < 0 or (self._num_node_types is not None
                             and t >= self._num_node_types):
                    raise ValueError(f"node type {t} out of range "
                                     f"[0, {self._num_node_types})")
                kn[0, i] = t
                mn[0, i] = True
            if item.get("bbox") is not None:
                bb = np.asarray(item["bbox"], np.float32)
                if bb.shape != (4,) or (bb < 0).any() or (bb > 1).any():
                    raise ValueError("bbox must be 4 floats in [0, 1] (cxcywh)")
                kb[0, i] = bb
                mb[0, i] = True
        for edge in known_edges or []:
            s, o, p = (int(v) for v in edge)
            if not (0 <= s < num_nodes and 0 <= o < num_nodes and s != o):
                raise ValueError(f"bad edge ({s}, {o})")
            # p == 0 pins "no edge" (null predicate) — deliberately allowed
            if p < 0 or (self._num_edge_types is not None
                         and p >= self._num_edge_types):
                raise ValueError(f"predicate {p} out of range "
                                 f"[0, {self._num_edge_types})")
            ka[0, s, o] = p
            ma[0, s, o] = True
        req = _Request(flags=flags, seed=seed, kind="complete",
                       tensors=(kn, mn, kb, mb, ka, ma))
        self._q.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("completion timed out")
        if req.error:
            raise RuntimeError(req.error)
        return req.result[0]

    # ---------------------------------------------------------------- worker
    def _next_seed(self) -> int:
        with self._lock:
            self._counter += 1
            return self._counter

    def _call(self, seed: int, flags: np.ndarray):
        pad = self.batch_size - len(flags)
        if pad:
            flags = np.concatenate(
                [flags, np.zeros((pad, self.max_node_num), bool)], 0)
        adj, node, bbox = self._fn(np.int32(seed), flags)
        return np.asarray(adj), np.asarray(node), np.asarray(bbox)

    def _call_complete(self, seed: int, req: _Request):
        def _pad0(x):
            pad = self.batch_size - len(x)
            if pad:
                x = np.concatenate(
                    [x, np.zeros((pad,) + x.shape[1:], x.dtype)], 0)
            return x
        flags = _pad0(req.flags)
        kn, mn, kb, mb, ka, ma = (_pad0(t) for t in req.tensors)
        adj, node, bbox = self._complete_fn(np.int32(seed), flags,
                                            kn, mn, kb, mb, ka, ma)
        return np.asarray(adj), np.asarray(node), np.asarray(bbox)

    def _run(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            if first.seed is None and first.kind == "gen":
                # coalesce a burst; seeded/completion requests ride alone
                deadline = time.time() + self._linger
                used = len(first.flags)
                while time.time() < deadline and used < self.batch_size:
                    try:
                        nxt = self._q.get(timeout=max(0.0, deadline - time.time()))
                    except queue.Empty:
                        break
                    if (nxt.seed is not None or nxt.kind != "gen"
                            or used + len(nxt.flags) > self.batch_size):
                        self._q.put(nxt)  # leave for the next batch
                        break
                    batch.append(nxt)
                    used += len(nxt.flags)
            t0 = time.time()
            flags = np.concatenate([r.flags for r in batch], 0)
            seed = batch[0].seed if batch[0].seed is not None else self._next_seed()
            try:
                if first.kind == "complete":
                    adj, node, bbox = self._call_complete(int(seed), first)
                else:
                    adj, node, bbox = self._call(int(seed), flags)
            except Exception as e:  # surface to every waiting client
                logging.exception("batch generation failed")
                for r in batch:
                    r.error = f"{type(e).__name__}: {e}"
                    r.done.set()
                continue
            dt_ms = (time.time() - t0) * 1e3
            off = 0
            for r in batch:
                k = len(r.flags)
                r.result = [
                    _graph_dict(adj[off + i], node[off + i], bbox[off + i],
                                r.flags[i])
                    for i in range(k)]
                off += k
                r.done.set()
            with self._lock:
                self.stats["requests"] += len(batch)
                self.stats["graphs"] += off
                self.stats["batches"] += 1
                self.stats["latencies_ms"].append(dt_ms)
                del self.stats["latencies_ms"][:-1000]  # bounded history


def _graph_dict(adj, node, bbox, flags) -> dict:
    n = int(flags.sum())
    edges = [[int(i), int(j), int(adj[i, j])]
             for i in range(n) for j in range(n)
             if i != j and adj[i, j] > 0]
    return {"nodes": [int(v) for v in node[:n]],
            "bboxes": [[float(x) for x in bb] for bb in bbox[:n]],
            "edges": edges}


def _augment_names(graphs: list, idx_to_word: dict | None) -> None:
    if not idx_to_word:
        return
    classes = idx_to_word.get("ind_to_classes", [])
    preds = idx_to_word.get("ind_to_predicates", [])
    for g in graphs:
        if classes:
            g["node_names"] = [str(classes[v]) if v < len(classes) else str(v)
                               for v in g["nodes"]]
        if preds:
            g["edge_names"] = [str(preds[e[2]]) if e[2] < len(preds) else str(e[2])
                               for e in g["edges"]]


def make_handler(batcher: BatchingSampler, idx_to_word: dict | None = None,
                 default_num_nodes: int | None = None):
    default_n = default_num_nodes or batcher.max_node_num

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through logging, not stderr
            logging.debug("http: " + fmt, *args)

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok",
                                 "batch_size": batcher.batch_size,
                                 "max_node_num": batcher.max_node_num})
            elif self.path == "/v1/stats":
                with batcher._lock:
                    lat = sorted(batcher.stats["latencies_ms"])
                    stats = {k: v for k, v in batcher.stats.items()
                             if k != "latencies_ms"}
                if lat:
                    stats["latency_ms_p50"] = lat[len(lat) // 2]
                    stats["latency_ms_p95"] = lat[int(len(lat) * 0.95)]
                stats.update(tracing.counters())
                self._json(200, stats)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path not in ("/v1/generate", "/v1/complete"):
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                seed = body.get("seed")
                seed = None if seed is None else int(seed)
                t0 = time.time()
                if self.path == "/v1/complete":
                    graph = batcher.complete(
                        int(body.get("num_nodes", default_n)),
                        body.get("known_nodes"), body.get("known_edges"),
                        seed)
                    graphs = [graph]
                else:
                    graphs = batcher.generate(int(body.get("num_graphs", 1)),
                                              body.get("num_nodes", default_n),
                                              seed)
                _augment_names(graphs, idx_to_word)
                self._json(200, {"graphs": graphs,
                                 "latency_ms": (time.time() - t0) * 1e3})
            except (ValueError, TypeError, KeyError) as e:
                self._json(400, {"error": str(e)})
            except RuntimeError as e:
                self._json(501 if "completion unavailable" in str(e) else 500,
                           {"error": str(e)})
            except Exception as e:
                logging.exception("generate failed")
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    # the listen backlog.  socketserver's default, 5, drops the connections of
    # a burst beyond it, and their clients retry a second later (the one
    # departure from diffusesg_tpu/serving/server.py; the answers are the same)
    request_queue_size = 128


def serve(batcher: BatchingSampler, port: int, idx_to_word: dict | None = None,
          default_num_nodes: int | None = None) -> ThreadingHTTPServer:
    """Start the HTTP server (returns it; call .serve_forever() to block)."""
    handler = make_handler(batcher, idx_to_word, default_num_nodes)
    httpd = _HTTPServer(("0.0.0.0", port), handler)
    logging.info("serving scene-graph generation on :%d (batch %d)",
                 port, batcher.batch_size)
    return httpd
