"""BENCHMARK.json keeps the benchmark's contract, and every cell, metric
and configuration it names has its files."""
import json
import os
import re
import statistics

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# no width may be reduced (a model's hidden, head, window or expansion sizes)
WIDTH = re.compile(r"(_dim|_rank|dims|hidden|intermediate|latent|state|proj|head|window|ratio"
                   r"|experts_per)", re.I)


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(bench["command"]) <= 32
    for word in bench["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and os.path.isdir(os.path.join(ROOT, p))
        assert not p.endswith("_torch")
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group if group in ("configs", "workloads") else "metric", e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
    assert len(names) == len(set(names))
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_cells_and_configs(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in bench["workloads"]} == configs
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))


def test_every_cell_reports_enough(bench):
    from benchlib import cells
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"] if cells.reports(m, w["name"], bench)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cells.reports(m, w["name"], bench) for m in bench["per_layer"])


def test_per_layer_metrics_move_a_metric_their_cells_report(bench):
    from benchlib import cells
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert cells.reports(e2e[m["moves"]], cell, bench), (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_layers_are_named_alike(bench):
    """Metrics of one layer name it letter for letter: one name per
    distinct prefix before the colon."""
    by_head = {}
    for m in bench["per_layer"]:
        by_head.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_head.values()), by_head


def test_every_name_has_its_files(bench):
    from benchlib import cells
    for w in bench["workloads"]:
        cell = cells.load(w["name"], bench)
        assert os.path.exists(os.path.join(HERE, "drivers", cell.traffic["kind"] + ".py"))
        assert cell.limits
    for m in bench["per_layer"]:
        read, _ = cells.reader(m["name"])
        assert callable(read)


def test_configs_hold_the_published_sizes(bench):
    """Nothing reduced: the files hold the repository's published configs."""
    import yaml
    published = {"vg": "configs/edm_diffuse_sg_regular_visual_genome.yaml",
                 "coco": "configs/edm_diffuse_sg_regular_coco.yaml"}
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            held = json.load(f)
        with open(os.path.join(ROOT, published[c["name"]])) as f:
            assert held["model_config"] == yaml.safe_load(f)
        assert held["reduced"] == c["reduced"] == []


def test_limits_name_their_readings():
    """Each limit lies between the readings it was set from, where both
    were taken: above the program's largest, below the control's least."""
    for name in os.listdir(os.path.join(HERE, "limits")):
        with open(os.path.join(HERE, "limits", name)) as f:
            checks = json.load(f)["checks"]
        for k, c in checks.items():
            if c.get("lower") is not None:
                assert c["limit"] >= c["lower"], (name, k)
            if c.get("upper") is not None:
                assert c["limit"] < c["upper"], (name, k)


def test_spread_uses_python_quartiles():
    """The bound's spread is the inter-quartile distance over the median,
    as statistics.quantiles(n=4) gives it."""
    from tools import spread
    vals = [10.0, 10.2, 9.9, 10.1, 10.05, 9.95]
    q = statistics.quantiles(vals, n=4)
    assert spread.spread(vals) == pytest.approx((q[2] - q[0]) / statistics.median(vals))
