"""Port host-side and tensor modules vs the JAX package: sampler schedule,
preconditioning, masking, the attribute codec and decode."""
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusesg_tpu.diffusion import edm as jedm
from diffusesg_tpu.ops import attribute_code as jcode
from diffusesg_tpu.ops import masking as jmask
from diffusesg_tpu.sampling import decode as jdecode
from diffusesg_tpu.sampling.edm_sampler import NodeAdjEDMSampler as JaxSampler
from diffusesg_torch.diffusion import edm as tedm
from diffusesg_torch.ops import attribute_code as tcode
from diffusesg_torch.ops import masking as tmask
from diffusesg_torch.sampling import decode as tdecode
from diffusesg_torch.sampling.edm_sampler import NodeAdjEDMSampler as TorchSampler

SAMPLER_CASES = [
    dict(),
    dict(num_steps=16, S_churn=0.0),
    dict(num_steps=7, solver="euler", self_condition=True),
    dict(num_steps=12, discretization="vp", schedule="vp", scaling="vp"),
    dict(num_steps=10, discretization="ve", schedule="ve"),
    dict(num_steps=9, discretization="iddpm", alpha=0.8, S_churn=80.0),
]


@pytest.mark.parametrize("kw", SAMPLER_CASES)
def test_step_coefficients_bit_exact(kw):
    j, t = JaxSampler(**kw), TorchSampler(**kw)
    cj, ct = j.step_coefficients(), t.step_coefficients()
    assert ct.dtype == np.float32 and ct.shape == cj.shape
    np.testing.assert_array_equal(ct, cj)
    assert t.init_scale() == j.init_scale()


@pytest.mark.parametrize("precond", ["edm", "vp", "ve"])
def test_preconditioning_params(precond):
    sig = np.geomspace(0.002, 80.0, 13).astype(np.float32)
    ref = jedm.get_preconditioning_params(precond, jnp.asarray(sig))
    got = tedm.get_preconditioning_params(precond, torch.from_numpy(sig))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)
    assert tuple(tedm.get_edm_params()) == tuple(jedm.get_edm_params())
    assert tuple(tedm.get_ve_params()) == tuple(jedm.get_ve_params())
    np.testing.assert_allclose(tuple(tedm.get_vp_params()), tuple(jedm.get_vp_params()),
                               rtol=1e-6)


@pytest.mark.parametrize("shape", [(2, 6, 6), (2, 6, 6, 3)])
def test_masking_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    adj = rng.standard_normal(shape).astype(np.float32)
    adj[1, 5, 5] = np.nan  # a padded NaN must not survive the mask
    flags = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 0, 0, 0]], bool)
    nodes = rng.standard_normal((2, 6, 3)).astype(np.float32)
    ta, tf = torch.from_numpy(adj), torch.from_numpy(flags)
    for kw in (dict(), dict(col_only=True), dict(value=-1.0)):
        np.testing.assert_array_equal(tmask.mask_adjs(ta, tf, **kw).numpy(),
                                      np.asarray(jmask.mask_adjs(adj, flags, **kw)))
    np.testing.assert_array_equal(tmask.mask_nodes(torch.from_numpy(nodes), tf).numpy(),
                                  np.asarray(jmask.mask_nodes(nodes, flags)))
    clean = np.nan_to_num(adj)
    np.testing.assert_allclose(tmask.symmetrize(torch.from_numpy(clean)).numpy(),
                               np.asarray(jmask.symmetrize(clean)), rtol=1e-7)
    # symmetric noise: the JAX draw's upper triangle mirrored, zero diagonal
    key = jax.random.PRNGKey(3)
    ref = jmask.get_sym_normal_noise(key, shape)
    got = tmask.sym_from_normal(torch.from_numpy(np.array(jax.random.normal(key, shape))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


ENC = ("int", "ddpm", "bits", "one_hot")


def _encoded(enc, ints, flags, k, nodes):
    kw = dict(flag_nodes=True) if nodes else dict(flag_adjs=True)
    return np.asarray(jcode.attribute_converter(jnp.asarray(ints, jnp.float32), flags, "int",
                                                enc, k, **kw))


@pytest.mark.parametrize("enc_in,enc_out", list(itertools.product(ENC, ENC)))
def test_attribute_codec_all_pairs(enc_in, enc_out):
    rng = np.random.default_rng(ENC.index(enc_in) * 4 + ENC.index(enc_out))
    k = 51
    flags = np.array([[1, 1, 1, 1, 1, 0], [1, 1, 0, 0, 0, 0]], bool)
    for nodes in (True, False):
        shape = (2, 6) if nodes else (2, 6, 6)
        ints = rng.integers(0, k, size=shape).astype(np.float32)
        x = _encoded(enc_in, ints, flags, k, nodes)
        if enc_in == "ddpm":  # off-grid values exercise the interval quantizer
            x = x + rng.uniform(-0.9, 0.9, x.shape).astype(np.float32) / (k - 1)
        kw = dict(flag_nodes=True) if nodes else dict(flag_adjs=True)
        ref = jcode.attribute_converter(jnp.asarray(x), flags, enc_in, enc_out, k, **kw)
        got = tcode.attribute_converter(torch.from_numpy(np.array(x, np.float32)),
                                        torch.from_numpy(flags), enc_in, enc_out, k, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("node_enc,edge_enc", [("ddpm", "ddpm"), ("bits", "bits"),
                                               ("one_hot", "bits"), ("bits", "one_hot")])
def test_decode_matches_jax(node_enc, edge_enc):
    rng = np.random.default_rng(7)
    n_node, n_edge = 150, 51
    c_x = {"ddpm": 1, "bits": 8, "one_hot": 150}[node_enc] + 4
    c_a = {"ddpm": 1, "bits": 6, "one_hot": 51}[edge_enc]
    flags = np.zeros((3, 10), bool)
    for i, c in enumerate((10, 6, 1)):
        flags[i, :c] = True
    adjs = (1.3 * rng.standard_normal((3, 10, 10) + ((c_a,) if c_a > 1 else ()))).astype(np.float32)
    nodes = (1.3 * rng.standard_normal((3, 10, c_x))).astype(np.float32)
    kw = dict(node_encoding=node_enc, edge_encoding=edge_enc, num_node_type=n_node,
              num_adj_type=n_edge)
    ref = jdecode.decode_samples(adjs, nodes, flags, **kw)
    got = tdecode.decode_samples(torch.from_numpy(adjs), torch.from_numpy(nodes),
                                 torch.from_numpy(flags), **kw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got.adj_types.dtype == torch.int32 and got.node_types.dtype == torch.int32
