"""The port's denoiser vs flax on shared weights (CPU, fp32), the weight
carry-over, the seeded init and the VG parameter count."""
import os
import sys

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_parity import ATOL, RTOL, VG_CFG, load_pair, model_pair, node_flags  # noqa: E402

from diffusesg_torch.config import load_config  # noqa: E402
from diffusesg_torch.models import build_model, count_params, make_model  # noqa: E402


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = load_pair()
    jm, params, tm = model_pair(jcfg, tcfg)
    return jcfg, tcfg, jm, params, tm


def _inputs(seed=0, b=2, n=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(adj=f(b, n, n), node=f(b, n, 5), flags=node_flags(b, n, [n, 9]),
                sigma=np.exp(f(b) * 1.2 - 1.2).astype(np.float32),
                sc_a=f(b, n, n), sc_x=f(b, n, 5))


@pytest.mark.parametrize("self_cond", [True, False])
def test_denoiser_forward_matches_flax(pair, self_cond):
    _, _, jm, params, tm = pair
    x = _inputs()
    c_noise = np.log(x["sigma"]) / 4.0
    sc = (x["sc_a"], x["sc_x"]) if self_cond else (None, None)
    ja, jx = jm.apply(params, x["adj"], x["node"], x["flags"], c_noise, *sc)
    with torch.no_grad():
        ta, tx = tm(torch.from_numpy(x["adj"]), torch.from_numpy(x["node"]),
                    torch.from_numpy(x["flags"]), torch.from_numpy(c_noise),
                    *(None if s is None else torch.from_numpy(s) for s in sc))
    assert ta.shape == (2, 16, 16) and tx.shape == (2, 16, 5)
    assert float(np.abs(np.asarray(ja)).max()) > 1e-2  # the weights make the outputs matter
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL, rtol=RTOL)


def test_precond_forward_matches_flax(pair):
    from diffusesg_tpu.models.precond import precond_forward as jprecond
    from diffusesg_torch.models.precond import precond_forward as tprecond
    _, _, jm, params, tm = pair
    x = _inputs(seed=1)

    def jfn(a, n, f, c, sa, sx):
        return jm.apply(params, a, n, f, c, sa, sx)

    ja, jx = jprecond(jfn, "edm", x["adj"], x["node"], x["flags"], x["sigma"],
                      x["sc_a"], x["sc_x"])
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    with torch.no_grad():
        ta, tx = tprecond(tm, "edm", t["adj"], t["node"], t["flags"], t["sigma"],
                          t["sc_a"], t["sc_x"])
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL, rtol=RTOL)


def test_weights_round_trip_through_reference_names(pair):
    """The port's state_dict uses the PyTorch reference's names: the JAX
    package's own importer maps it back onto the identical flax tree."""
    from diffusesg_tpu.utils.torch_import import state_dict_to_flax
    _, tcfg, _, params, tm = pair
    back = state_dict_to_flax(tm.state_dict(), list(tcfg.model.depths), 1)
    flat_ref = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), np.asarray(leaf))


def test_vg_parameter_count():
    cfg = load_config(VG_CFG)
    model = make_model(cfg)
    assert count_params(model) == 35_808_848
    assert model.dtype == torch.bfloat16


def test_seeded_init_is_deterministic():
    _, tcfg = load_pair()
    a = build_model(tcfg, device="cpu", seed=3)
    b = build_model(tcfg, device="cpu", seed=3)
    c = build_model(tcfg, device="cpu", seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["map_layer0.weight"], sc["map_layer0.weight"])
    assert torch.equal(sa["norm.weight"], torch.ones_like(sa["norm.weight"]))
    assert torch.count_nonzero(sa["map_layer0.bias"]) == 0
    w = sa["down_layers.0.blocks.0.attn.qkv.weight"]
    assert float(w.abs().max()) <= 0.04 and 0.012 < float(w.std()) < 0.025
