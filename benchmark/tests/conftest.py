"""Test set-up of the benchmark's own tests: its folder and the repo on the
path, and the ``card`` fixture that skips a ``gpu`` test without a card."""
import copy
import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.dirname(HERE), HERE):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark measures the card")
    return torch.device("cuda", 0)


def tiny(name: str, chips: int | None = None, traffic: str | None = None):
    """Cell ``name`` at a size the CPU runs in seconds: N = 8, embed 24,
    two stages, window 4, the kernels off, float32; the mix cut to match.
    ``chips`` and ``traffic`` put the cell on that many ranks with that mix."""
    from benchlib import cells
    c = cells.load(name)
    if traffic is not None:
        c.chips, c.traffic = chips, cells._json("traffic", traffic + ".json")
    mc = copy.deepcopy(c.config["model_config"])
    mc["dataset"]["max_node_num"] = 8
    mc["model"].update(feature_dims=[24], depths=[1, 2], window_size=4)
    mc["tpu"].update(use_pallas_attention=False, compute_dtype="float32")
    if c.chips > 1:
        # the mode the kernels pick on cards (auto resolves to gspmd without them)
        mc["tpu"]["spmd_mode"] = "shard_map"
    c.config = dict(c.config, model_config=mc)
    if c.traffic["kind"] == "sample":
        c.traffic = dict(c.traffic, batch=3, heun_steps=4)
        c.check = dict(c.check, check_graphs=10 ** 6)
    else:
        c.traffic = dict(c.traffic, batch=6 * c.chips, pool_batches=4, check_block=4,
                         traced_steps=2)
    return c
