"""The frozen arithmetic: the FLOP count, the union of device intervals and
the reduction of a trace."""
import json
import os

import pytest

from yardstick import flops, kernels, roofline, trace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)["model_config"]


@pytest.mark.parametrize("name, expected", [("vg", 12_124_090_368), ("coco", 7_043_950_080)])
def test_forward_flops_per_graph(name, expected):
    assert flops.forward_flops(_config(name)) == expected


@pytest.mark.parametrize("name, blocks", [("vg", 12), ("coco", 18)])
def test_swin_blocks_per_forward(name, blocks):
    from reference.model import Shape
    assert len(Shape.of(_config(name)).blocks()) == blocks


def test_union_counts_overlap_once():
    busy, pieces = trace.union_us([(0, 10), (5, 12), (20, 25), (21, 22), (12, 13)])
    assert busy == 13 + 5
    assert pieces == [[0, 13], [20, 25]]


def test_summary_of_a_trace_with_two_streams():
    """A kernel on a side stream inside another counts once; the gap between
    them is named after the host event covering most of it."""
    ev = [
        {"ph": "X", "cat": "kernel", "name": "token_mlp_kernel<96>", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 50, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce", "ts": 400, "dur": 50},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "bench.step", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 10, "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 140, "dur": 280},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 100, "dur": 300},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0},
    ]
    s = trace.summarize(ev)
    assert s.busy_s == pytest.approx(200e-6)
    assert s.api_calls == 2
    assert s.gaps[0][0] == pytest.approx(250e-6)
    assert s.gaps[0][1] == "host: cudaStreamSynchronize"
    table = [["token_mlp_kernel", "token_mlp"]]
    assert kernels.seconds_of(s, table, ["token_mlp"]) == pytest.approx(100e-6)
    assert s.top_ops(1) == [["token_mlp_kernel<96>", pytest.approx(100e-6)]]


def test_bound_takes_the_slower_of_operations_and_bytes():
    assert roofline.bound_s(989e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)
    from reference.model import Shape
    shape = Shape.of(_config("vg"))
    assert roofline.swin_backward_s(shape, 64) > roofline.swin_forward_s(shape, 64) > 0
