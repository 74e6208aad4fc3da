"""Adj-only sampling on the CPU: the port's ``NodeAdjEDMSampler.sample_adj``
against the JAX package's (diffusesg_tpu/sampling/edm_sampler.py:510-532)
on the same initial sample and churn draws (``torch_parity.JaxKeyNoise``
under the key ``sample_adj`` hands its joint sampler), with and without
self-conditioning, through the adj-only preconditioning of both packages
(``precond_forward_adj``) around a deterministic denoiser; and
``gen_init_sample_adj``'s symmetric, folded, masked draw.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_parity import ATOL, RTOL, JaxKeyNoise  # noqa: E402

B, N, STEPS = 3, 8, 12


def _flags():
    flags = np.ones((B, N), bool)
    flags[0, N - 3:] = False
    flags[2, 2:] = False
    return flags


def _sym(rs, flags):
    x = np.triu(rs.randn(B, N, N).astype(np.float32), 1)
    x = x + np.swapaxes(x, -1, -2)
    return np.abs(x) * flags[:, :, None] * flags[:, None, :]


def _raw(x, c_noise, sc, xp):
    """A deterministic adj-only network: nonlinear in x, the noise level and
    the self-conditioning input."""
    sig = c_noise.reshape((-1, 1, 1))
    return xp.tanh(0.8 * x + 0.3 * sc) - 0.05 + 0.1 * xp.sin(sig)


def _samplers(self_cond):
    from diffusesg_tpu.sampling.edm_sampler import NodeAdjEDMSampler as J
    from diffusesg_torch.sampling.edm_sampler import NodeAdjEDMSampler as T
    kw = dict(num_steps=STEPS, self_condition=self_cond, symmetric_noise=True, S_churn=40.0,
              S_min=0.05, S_max=50.0)
    return J(**kw), T(**kw)


@pytest.mark.parametrize("self_cond", [False, True])
def test_sample_adj_matches_jax_with_injected_draws(self_cond):
    from diffusesg_tpu.models.precond import precond_forward_adj as jprecond
    from diffusesg_torch.models.precond import precond_forward_adj as tprecond
    jsampler, tsampler = _samplers(self_cond)
    flags = _flags()
    init = _sym(np.random.RandomState(2), flags)
    key = jax.random.PRNGKey(9)

    def jden(adjs, node_flags, sigmas, sc):
        def raw(a, f, c_noise, s):
            return _raw(a, c_noise, jnp.zeros_like(a) if s is None else s, jnp)
        return jprecond(raw, "edm", adjs, node_flags, sigmas, sc)

    want = np.asarray(jsampler.sample_adj(jden, key, jnp.asarray(flags),
                                          init_adjs=jnp.asarray(init)))

    def tden(adjs, node_flags, sigmas, sc):
        def raw(a, f, c_noise, s):
            return _raw(a, c_noise, torch.zeros_like(a) if s is None else s, torch)
        return tprecond(raw, "edm", adjs, node_flags, sigmas, sc)

    # sample_adj splits the key once for its init and hands the rest to sample
    noise = JaxKeyNoise(jax.random.split(key)[0], STEPS)
    got = tsampler.sample_adj(tden, torch.from_numpy(flags), noise=noise,
                              init_adjs=torch.from_numpy(init)).numpy()
    assert {k for _, k in noise.requests} == {"churn_adj", "churn_node"}
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.swapaxes(got, -1, -2), atol=1e-6)
    assert not got[0, N - 3:].any() and not got[:, :, N - 3:][0].any()
    # and with the interim snapshots
    interim_noise = JaxKeyNoise(jax.random.split(key)[0], STEPS)
    adjs, interim = tsampler.sample_adj(tden, torch.from_numpy(flags), noise=interim_noise,
                                        init_adjs=torch.from_numpy(init), num_interim=4)
    np.testing.assert_array_equal(adjs.numpy(), got)
    assert interim.shape == (5, B, N, N)
    np.testing.assert_array_equal(interim[0].numpy(), init)


def test_gen_init_sample_adj_is_symmetric_folded_and_masked():
    from diffusesg_torch.sampling.edm_sampler import TorchNoise
    _, tsampler = _samplers(False)
    flags = torch.from_numpy(_flags())
    init = tsampler.gen_init_sample_adj(TorchNoise(4, "cpu"), flags)
    assert init.shape == (B, N, N)
    assert (init >= 0).all() and init.abs().sum() > 0
    torch.testing.assert_close(init, init.transpose(-1, -2), rtol=0, atol=0)
    assert not torch.diagonal(init, dim1=-2, dim2=-1).any()
    pair = flags[:, :, None] & flags[:, None, :]
    assert not init[~pair].any()
    # the draw is the JAX package's given its normal draw (edm_sampler.py:534-544)
    from diffusesg_tpu.sampling.edm_sampler import NodeAdjEDMSampler as J
    key = jax.random.PRNGKey(3)

    class Draw:
        def normal(self, step, kind, shape):
            return torch.from_numpy(np.array(jax.random.normal(key, tuple(shape))))
    got = tsampler.gen_init_sample_adj(Draw(), flags).numpy()
    want = np.asarray(J(symmetric_noise=True).gen_init_sample_adj(key, jnp.asarray(_flags())))
    np.testing.assert_array_equal(got, want)
