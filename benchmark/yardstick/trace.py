"""Reduction of a profiler trace to what the per-layer metrics read.

The trace is ``torch.profiler``'s Chrome trace (``export_chrome_trace``).
Device activity is the events of category ``kernel``, ``gpu_memcpy`` and
``gpu_memset``; the card is busy over the *union* of their intervals, so
work that overlaps on two streams (a prefetch copy beside compute, NCCL
beside a kernel) is counted once.  Host CUDA API calls are the events of
category ``cuda_runtime`` and ``cuda_driver``.  An idle gap is named after
the host event that covers most of it (the innermost of equals).
"""
from __future__ import annotations

import dataclasses
import json

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
API = ("cuda_runtime", "cuda_driver")
HOST = ("cpu_op", "user_annotation", "python_function") + API


def union_us(intervals) -> tuple[float, list]:
    """Length of the union of (start, end) intervals, and its pieces in
    order."""
    pieces = []
    for s, e in sorted(intervals):
        if pieces and s <= pieces[-1][1]:
            if e > pieces[-1][1]:
                pieces[-1][1] = e
        else:
            pieces.append([s, e])
    return sum(e - s for s, e in pieces), pieces


@dataclasses.dataclass
class Summary:
    busy_s: float                 # union of device activity
    kernels: dict                 # kernel name -> [seconds, count]
    api_calls: int                # host CUDA API calls
    gaps: list                    # [(seconds, host event name)], longest first
    span_s: float                 # first device start to last device end

    def seconds_where(self, pred) -> float:
        """Device seconds of the kernels whose name satisfies ``pred``."""
        return sum(t for name, (t, _) in self.kernels.items() if pred(name))

    def top_ops(self, n: int = 10) -> list:
        rows = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:n]
        return [[name[:120], t] for name, (t, _) in rows]


def summarize(events: list, gaps: int = 10) -> Summary:
    """``events``: the ``traceEvents`` of a Chrome trace."""
    dev, host, kernels, api = [], [], {}, 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        s = float(e["ts"])
        d = float(e.get("dur", 0.0))
        if cat in DEVICE:
            dev.append((s, s + d))
            if cat == "kernel":
                k = kernels.setdefault(e["name"], [0.0, 0])
                k[0] += d * 1e-6
                k[1] += 1
        elif cat in HOST:
            host.append((s, s + d, e["name"]))
            if cat in API:
                api += 1
    busy, pieces = union_us(dev)
    holes = [(pieces[i][1], pieces[i + 1][0]) for i in range(len(pieces) - 1)]
    holes.sort(key=lambda h: h[0] - h[1])
    named = []
    for g0, g1 in holes[:gaps]:
        best = None
        for s, e, name in host:
            cover = min(e, g1) - max(s, g0)
            if cover > 0:
                rank = (cover, -(e - s))
                if best is None or rank > best[0]:
                    best = (rank, name)
        named.append(((g1 - g0) * 1e-6, "host: " + (best[1] if best else "none")))
    span = (pieces[-1][1] - pieces[0][0]) * 1e-6 if pieces else 0.0
    return Summary(busy * 1e-6, kernels, api, named, span)


def load(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data
