"""The COCO-Stuff slice on the CPU, port vs JAX package: the config read as it
is and cut to a small size that keeps a shifted window-10 block (N = 20,
embed 24, depths (2, 2), fp32), on shared weights and shared random draws.

Tolerances: denoiser and ``precond_forward`` atol 2e-4 / rtol 1e-3 (the fp32
parity bar of the VG slice); continuous samples after 4 Heun steps atol 1e-3 /
rtol 1e-3, decoded graphs equal; three training steps under the bars of
tests/test_torch_train_step.py (loss rtol 2e-4, gradients rtol 5e-3 + 5e-3 *
max|leaf|); the synthetic COCO-like dataset identical arrays.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_parity import ATOL, COCO_CFG, RTOL, load_coco_pair, model_pair, node_flags  # noqa: E402

from test_torch_slice import SAMPLE_ATOL, SAMPLE_RTOL, SEED, JaxKeyNoise, _jax_run  # noqa: E402
from test_torch_train_step import run_three_training_steps  # noqa: E402

from diffusesg_torch.config import load_config  # noqa: E402
from diffusesg_torch.models import count_params, make_model  # noqa: E402

N = 20
COUNTS = [20, 13, 5, 1]
WEIGHT_SEED = 1


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = load_coco_pair()
    jm, params, tm = model_pair(jcfg, tcfg)
    return jcfg, tcfg, jm, params, tm


def _inputs(seed=0, b=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(adj=f(b, N, N), node=f(b, N, 5), flags=node_flags(b, N, [N, 9]),
                sigma=np.exp(f(b) * 1.2 - 1.2).astype(np.float32), sc_a=f(b, N, N),
                sc_x=f(b, N, 5))


def test_coco_config_reads_alike_and_counts_its_parameters():
    from diffusesg_tpu.config import load_config as jload
    from diffusesg_torch.models.channels import dataset_constants
    jcfg, tcfg = jload(COCO_CFG), load_config(COCO_CFG)
    assert tcfg.to_dict() == jcfg.to_dict()
    assert dataset_constants(tcfg.dataset.name) == (171, 7, 33)
    assert (tcfg.dataset.max_node_num, tcfg.model.window_size) == (40, 10)
    model = make_model(tcfg)
    assert count_params(model) == 30_690_020 and model.dtype == torch.bfloat16
    geometry = [(blk.input_resolution, blk.window, blk.shift, blk.num_heads)
                for layer in list(model.down_layers) + list(model.up_layers)
                for blk in layer.blocks]
    assert len(geometry) == 18 and all(w == 10 for _, w, _, _ in geometry)
    assert geometry[:3] == [((40, 40), 10, 0, 3), ((20, 20), 10, 0, 6), ((20, 20), 10, 5, 6)]
    assert sum(1 for res, _, s, _ in geometry if s) == 2            # the 20x20 stage, down and up
    assert sum(1 for res, _, _, _ in geometry if res == (10, 10)) == 12  # window = grid, no shift
    table = model.down_layers[2].blocks[0].attn.relative_position_bias_table
    assert tuple(table.shape) == (361, 12)


def test_small_coco_model_keeps_a_shifted_window_10_block(pair):
    tm = pair[4]
    blocks = [(b.input_resolution, b.window, b.shift) for b in tm.down_layers[0].blocks]
    assert blocks == [((20, 20), 10, 0), ((20, 20), 10, 5)]
    assert tuple(tm.down_layers[0].blocks[1].attn_mask.shape) == (4, 100, 100)
    assert [(b.input_resolution, b.window, b.shift) for b in tm.down_layers[1].blocks] == \
        [((10, 10), 10, 0)] * 2


@pytest.mark.parametrize("self_cond", [True, False])
def test_coco_denoiser_forward_matches_flax(pair, self_cond):
    _, _, jm, params, tm = pair
    x = _inputs()
    c_noise = np.log(x["sigma"]) / 4.0
    sc = (x["sc_a"], x["sc_x"]) if self_cond else (None, None)
    ja, jx = jm.apply(params, x["adj"], x["node"], x["flags"], c_noise, *sc)
    with torch.no_grad():
        ta, tx = tm(torch.from_numpy(x["adj"]), torch.from_numpy(x["node"]),
                    torch.from_numpy(x["flags"]), torch.from_numpy(c_noise),
                    *(None if s is None else torch.from_numpy(s) for s in sc))
    assert ta.shape == (2, N, N) and tx.shape == (2, N, 5)
    assert float(np.abs(np.asarray(ja)).max()) > 1e-2  # the weights make the outputs matter
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL, rtol=RTOL)


def test_coco_precond_forward_matches_flax(pair):
    from diffusesg_tpu.models.precond import precond_forward as jprecond
    from diffusesg_torch.models.precond import precond_forward as tprecond
    _, _, jm, params, tm = pair
    x = _inputs(seed=1)
    ja, jx = jprecond(lambda *a: jm.apply(params, *a), "edm", x["adj"], x["node"], x["flags"],
                      x["sigma"], x["sc_a"], x["sc_x"])
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    with torch.no_grad():
        ta, tx = tprecond(tm, "edm", t["adj"], t["node"], t["flags"], t["sigma"], t["sc_a"],
                          t["sc_x"])
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL, rtol=RTOL)


def test_coco_weights_round_trip_through_reference_names(pair):
    """Three-stage-style tree with 361-row bias tables: the JAX package's own
    importer maps the port's state_dict back onto the identical flax tree."""
    from diffusesg_tpu.utils.torch_import import state_dict_to_flax
    from diffusesg_torch.utils.weights import flax_to_state_dict
    from diffusesg_torch.utils.weights import state_dict_to_flax as port_to_flax
    _, tcfg, _, params, tm = pair
    sd = tm.state_dict()
    assert sd["down_layers.0.blocks.1.attn.relative_position_bias_table"].shape[0] == 361
    back = state_dict_to_flax(sd, list(tcfg.model.depths), 1)
    flat_ref = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), np.asarray(leaf))
    again = flax_to_state_dict(port_to_flax(sd))
    assert all(torch.equal(again[k], v) for k, v in sd.items())


@pytest.mark.parametrize("s_churn", [0.0, 40.0])
def test_coco_generate_matches_jax_serving(s_churn):
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.serving.generate import generate, make_denoiser

    jcfg, tcfg = load_coco_pair(num_steps=4, s_churn=s_churn)
    # decode rounds to the nearest type: a sample within the 1e-3 parity bar of
    # a threshold may fall on either side; with these weights none is
    jm, params, tm = model_pair(jcfg, tcfg, seed=WEIGHT_SEED)
    flags = node_flags(len(COUNTS), N, COUNTS)
    (j_adj, j_node, j_bbox), (j_cont_a, j_cont_x) = _jax_run(jcfg, jm, params, flags)

    sampler = get_mc_sampler(tcfg)
    noise = JaxKeyNoise(SEED, sampler.num_steps)
    t_adj, t_node, t_bbox = generate(tm, sampler, tcfg, COUNTS, device="cpu", noise=noise)
    assert ({k for _, k in noise.requests}
            == {"init_adj", "init_node"} | ({"churn_adj", "churn_node"} if s_churn else set()))
    tflags = torch.from_numpy(flags)
    with torch.no_grad():
        cont_a, cont_x = sampler.sample(make_denoiser(tm, tcfg, tflags), tflags, 5, 1,
                                        noise=JaxKeyNoise(SEED, sampler.num_steps))
    np.testing.assert_allclose(cont_a.numpy(), j_cont_a, atol=SAMPLE_ATOL, rtol=SAMPLE_RTOL)
    np.testing.assert_allclose(cont_x.numpy(), j_cont_x, atol=SAMPLE_ATOL, rtol=SAMPLE_RTOL)
    np.testing.assert_array_equal(t_adj.numpy(), j_adj)
    np.testing.assert_array_equal(t_node.numpy(), j_node)
    np.testing.assert_allclose(t_bbox.numpy(), j_bbox, atol=SAMPLE_ATOL)
    assert int(t_node.max()) < 171 and int(t_adj.max()) < 7
    assert int(t_node[3, 1:].abs().sum()) == 0 and int(t_adj[3].abs().sum()) == 0


def test_coco_three_training_steps_match_jax():
    """With stochastic self-conditioning on: the three steps take both
    branches of the Bernoulli draw."""
    run_three_training_steps(True, load_coco_pair, [20, 11, 5, 2])


def test_coco_synthetic_dataset_matches_jax():
    from diffusesg_tpu.data import load_data as jload
    from diffusesg_torch.data import load_data
    jcfg, tcfg = load_coco_pair()
    for cfg in (jcfg, tcfg):
        with cfg.unlocked():
            cfg.dataset.max_node_num = 40   # the dataset's own node budget
            cfg.dataset.subset = None
            cfg.dataset.synthetic_num_train = 20
            cfg.dataset.synthetic_num_test = 6
    jb, tb = jload(jcfg, data_root="/nonexistent"), load_data(tcfg, data_root="/nonexistent")
    for split in ("train", "test"):
        for field in ("adjs", "nodes", "node_flags", "image_ids"):
            a, b = getattr(getattr(tb, split), field), getattr(getattr(jb, split), field)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b, err_msg=f"{split}.{field}")
    assert tb.train.adjs.shape[1:] == (40, 40) and tb.train_triplet_dict == jb.train_triplet_dict
    assert tb.idx_to_word == jb.idx_to_word and tb.bbox_area_stat == jb.bbox_area_stat


def test_coco_training_cli_runs_on_the_cpu(tmp_path):
    """``cli.train`` -> ``go_training`` on the COCO config, cut small."""
    from diffusesg_torch.cli import train as cli
    state = cli.main([
        "-c", COCO_CFG, "--data_root", "/nonexistent", "--device", "cpu", "--subset", "8",
        "--batch_size", "4", "--max_epoch", "1", "--save_interval", "1",
        "-o", f"exp_dir={tmp_path}", "-o", "dataset.max_node_num=20",
        "-o", "model.feature_dims=[24]", "-o", "model.depths=[2,2]",
        "-o", "tpu.compute_dtype=float32", "-o", "train.sample_interval=100000"])
    assert state.step == 2
    root = os.path.join(str(tmp_path), "edm_diffuse_sg_regular")
    runs = os.listdir(root)
    assert len(runs) == 1 and runs[0].startswith("coco_stuff_train") and os.path.exists(os.path.join(root, runs[0], "models_ckpt",
                                                          "00000.pt"))
