"""The native batcher on the CPU (``data/native``, the port's copy of the JAX
package's C++ batch assembler): its batches bit-equal to the numpy gather
of ``Batches`` over two epochs, with shuffling, a shard of two processes,
``drop_remainder`` and the repeat-to-fill of a small set (the counterpart
of tests/test_data.py:308), the auto rule choosing it when more than one
CPU is available, and ``DSG_NATIVE_LOADER=0`` taking the numpy path.
"""
import numpy as np
import pytest


@pytest.fixture(scope="module")
def data():
    from diffusesg_torch.data.dataset import build_tensors
    from diffusesg_torch.data.synthetic import synthetic_scene_graphs
    return build_tensors(synthetic_scene_graphs(45, 9, 20, 5, seed=7), max_node_num=9,
                         num_node_attr_type=20, num_edge_attr_type=5, node_encoding="ddpm",
                         edge_encoding="ddpm")


@pytest.fixture(scope="module")
def native():
    from diffusesg_torch.data.native import get_lib
    lib = get_lib()
    assert lib is not None, "g++ builds the batcher on this host"
    return lib


@pytest.mark.parametrize("kw", [dict(), dict(process_index=1, process_count=2),
                                dict(drop_remainder=True), dict(shuffle=False),
                                dict(subset=4)], ids=["shuffle", "shard", "drop", "ordered",
                                                      "repeat_to_fill"])
def test_native_batches_equal_the_numpy_gather(data, native, kw):
    from diffusesg_torch.data.loader import Batches
    from diffusesg_torch.data.loader import split_eval_set
    kw = dict(kw)
    src = split_eval_set(data, kw.pop("subset")) if "subset" in kw else data
    nat = Batches(src, 8, seed=11, native=True, **kw)
    ref = Batches(src, 8, seed=11, native=False, **kw)
    assert nat._use_native() and not ref._use_native()
    for epoch in (0, 1):
        nat.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, exp = list(nat), list(ref)
        assert len(got) == len(exp) == len(nat) > 0
        for gb, eb in zip(got, exp):
            for g, e in zip(gb, eb):
                assert g.dtype == e.dtype and g.shape == e.shape
                np.testing.assert_array_equal(g, e)


def test_auto_rule_and_the_switch_off(data, native, monkeypatch):
    import os

    from diffusesg_torch.data import native as native_mod
    from diffusesg_torch.data.loader import Batches
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 1})
    assert Batches(data, 8)._use_native()
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0})
    assert not Batches(data, 8)._use_native()  # one CPU: its thread would only compete
    # DSG_NATIVE_LOADER=0 keeps the library from loading at all
    monkeypatch.setattr(native_mod, "_LIB", None)
    monkeypatch.setattr(native_mod, "_TRIED", False)
    monkeypatch.setenv("DSG_NATIVE_LOADER", "0")
    assert native_mod.get_lib() is None
    off = Batches(data, 8, native=True)
    assert not off._use_native()
    ref = Batches(data, 8, native=False)
    for g, e in zip(list(off), list(ref)):
        for a, b in zip(g, e):
            np.testing.assert_array_equal(a, b)
