"""Serving across devices against the JAX package's sharded functions: the
port's ``make_sharded_serving_fn`` / ``make_sharded_completion_fn`` over
``["cpu"] * 2`` and the JAX ``make_sharded_serving_fn`` /
``make_sharded_completion_fn`` over a mesh of two of the virtual CPU devices
(tests/conftest.py), on shared weights (``torch_parity.model_pair``) and the
JAX keys' draws (``torch_parity.JaxKeyNoise``; folded with the shard index
under ``shard_map``, diffusesg_tpu/serving/export.py:114-120).

The model is ``configs/vg_small_test.yaml`` at max_node_num 8, 4 steps and
batch 4, as tests/test_torch_serving.py runs it.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_parity import JaxKeyNoise, model_pair, node_flags  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CFG = os.path.join(REPO, "configs", "vg_small_test.yaml")
B, N, STEPS, SEED, SHARDS = 4, 8, 4, 13, 2
# continuous samples / boxes after 4 Heun steps at fp32 (tests/test_torch_slice.py:23),
# the bar of tests/test_torch_serving.py's cores against the JAX ones
SAMPLE_ATOL = 1e-3


def _tiny(load_config):
    cfg = load_config(SMALL_CFG)
    with cfg.unlocked():
        cfg.dataset.max_node_num = N
        cfg.mcmc.num_steps = STEPS
        cfg.test.batch_size = B
    return cfg


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tiny model's ops gain nothing from more, and
    a parallel test run (a process a core) makes each op wait for threads the
    others have descheduled, up to a hundred times slower."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    from diffusesg_tpu.config import load_config as jload
    from diffusesg_torch.config import load_config as tload
    jcfg, tcfg = _tiny(jload), _tiny(tload)
    jm, params, tm = model_pair(jcfg, tcfg)
    return jcfg, tcfg, jm, params, tm


def _known_parts():
    kn, mn = np.zeros((B, N), np.int32), np.zeros((B, N), bool)
    kb, mb = np.full((B, N, 4), 0.5, np.float32), np.zeros((B, N), bool)
    ka, ma = np.zeros((B, N, N), np.int32), np.zeros((B, N, N), bool)
    kn[:, 0], mn[:, 0] = 3, True
    kb[:, 0], mb[:, 0] = [0.25, 0.25, 0.1, 0.2], True
    ka[:, 0, 1], ma[:, 0, 1] = 2, True
    return kn, mn, kb, mb, ka, ma


@pytest.mark.parametrize("mode", ["gspmd", "shard_map"])
@pytest.mark.parametrize("what", ["generate", "complete"])
def test_sharded_functions_match_jax(pair, what, mode):
    """Both packages' sharded functions on the same flags and the same JAX
    keys: the decoded types equal, the boxes within SAMPLE_ATOL."""
    from diffusesg_tpu.parallel.mesh import make_mesh
    from diffusesg_tpu.sampling import get_mc_sampler as jsampler
    from diffusesg_tpu.serving import export as jexport
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.serving import export
    jcfg, tcfg, jm, params, tm = pair
    args = (node_flags(B, N, [8, 5, 7, 2]),)
    if what == "complete":
        args += _known_parts()
    jmake = (jexport.make_sharded_serving_fn if what == "generate"
             else jexport.make_sharded_completion_fn)
    tmake = (export.make_sharded_serving_fn if what == "generate"
             else export.make_sharded_completion_fn)
    jfn = jmake(jm, params, jsampler(jcfg), jcfg, make_mesh(SHARDS), mode)
    want = [np.asarray(v) for v in jfn(np.int32(SEED), *args)]
    noise = JaxKeyNoise(SEED, STEPS, inpaint=what == "complete")
    got = tmake(tm, get_mc_sampler(tcfg), tcfg, ["cpu"] * SHARDS, mode)(SEED, *args, noise=noise)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=SAMPLE_ATOL)
    if what == "complete":
        assert (got[1][:, 0] == 3).all() and (got[0][:, 0, 1] == 2).all()
