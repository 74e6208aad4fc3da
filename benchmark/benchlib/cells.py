"""A cell's definition, gathered by name from the benchmark's data files.

``BENCHMARK.json`` names the cell's configuration, traffic mix and chips,
and the metrics it reports; each of those lives in a file of its own:

* ``benchmark/configs/<config>.json``: the model configuration as run
  (``model_config``), its source and what was reduced or assumed;
* ``benchmark/traffic/<traffic>.json``: the mix's parameters, and in
  ``kind`` the driver that reads them (``benchmark/drivers/<kind>.py``);
* ``benchmark/limits/<cell>.json``: the limits of the numbers that decide
  ``correct``, with the readings they were set from, and in ``check`` the
  settings of the comparison (such as the number of graphs it samples);
* ``benchmark/metrics/<metric>.py``: a per-layer metric's reader, beside
  its data in ``<metric>.json`` where it has any.

Adding a configuration, a mix, a cell or a metric adds files and entries;
no file here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file ``path`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # benchmark/configs/<config>.json
    traffic: dict           # benchmark/traffic/<traffic>.json
    limits: dict            # check name -> limit (the numbers compared)
    check: dict             # the comparison's settings
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def model_config(self) -> dict:
        return self.config["model_config"]

    def driver(self):
        kind = self.traffic["kind"]
        return load_module(os.path.join(HERE, "drivers", f"{kind}.py"), f"bench_driver_{kind}")


def reports(metric: dict, cell: str, bench: dict) -> bool:
    """Whether ``cell`` reports ``metric``: it lists the cell, or lists
    none and the cell reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moved = next((m for m in bench["end_to_end"] if m["name"] == metric.get("moves")), None)
    return moved is None or reports(moved, cell, bench)


def load(name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else _json("..", "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    limits = _json("limits", f"{name}.json")
    return Cell(name=name, chips=int(entry["chips"]), config=_json("configs", entry["config"] + ".json"),
                traffic=_json("traffic", entry["traffic"] + ".json"),
                limits={k: v["limit"] for k, v in limits["checks"].items()},
                check=limits.get("check", {}),
                end_to_end=[m for m in bench["end_to_end"] if reports(m, name, bench)],
                per_layer=[m for m in bench["per_layer"] if reports(m, name, bench)])


def reader(metric: str):
    """The ``read(ctx)`` of a per-layer metric and its data (or {})."""
    base = os.path.join(HERE, "metrics", metric)
    mod = load_module(base + ".py", "bench_metric_" + metric.replace(".", "_"))
    data = _json("metrics", metric + ".json") if os.path.exists(base + ".json") else {}
    return mod.read, data
