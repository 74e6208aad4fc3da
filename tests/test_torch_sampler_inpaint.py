"""The port's sampler with inpainting, interim snapshots and ``init_*``
against the JAX sampler (diffusesg_tpu/sampling/edm_sampler.py:271-384) on
the same draws (``JaxKeyNoise``): a tanh toy denoiser at atol 1e-6, the
small model at the slice tests' 1e-3 / 1e-3, and the known entries exact.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_parity import JaxKeyNoise, load_pair, model_pair, node_flags  # noqa: E402

# atol for the O(1) outputs; rtol (8 fp32 ulps) for the snapshots of early
# steps, whose values reach several sigma
TOY_ATOL, TOY_RTOL = 1e-6, 1e-6
# The toy runs start at sigma_max 2: from the default 80 the two fp32
# samplers each end about 2e-6 from a float64 run of the same draws (their
# own rounding of values near 80), above TOY_ATOL; that range runs as the
# last case, held at DEFAULT_RANGE_ATOL.
TOY_SIGMA_MAX = 2.0
DEFAULT_RANGE_ATOL = 1e-5
# continuous samples after 4 Heun steps of the small model (test_torch_slice.py)
SAMPLE_ATOL, SAMPLE_RTOL = 1e-3, 1e-3
SEED = 11
B, N = 3, 6
COUNTS = [6, 4, 1]


def _samplers(num_steps, **kw):
    from diffusesg_tpu.sampling.edm_sampler import NodeAdjEDMSampler as JSampler
    from diffusesg_torch.sampling.edm_sampler import NodeAdjEDMSampler as TSampler
    return JSampler(num_steps=num_steps, **kw), TSampler(num_steps=num_steps, **kw)


def _toy(lib):
    """A denoiser that reads every input: tanh of the input plus the
    self-conditioning, scaled by sigma."""
    def fn(a, x, sigmas, sc_a, sc_x):
        sa = sigmas.reshape((-1,) + (1,) * (a.ndim - 1))
        sx = sigmas.reshape((-1,) + (1,) * (x.ndim - 1))
        return (lib.tanh(a + 0.1 * sc_a) * (1 + 0.01 * sa),
                lib.tanh(x - 0.2 * sc_x) * (1 - 0.01 * sx))
    return fn


def _inpaint_arrays(rng, flags, a_shape, x_shape, which):
    """Ground truth in [-1, 1] and masks of lower rank than their tensors:
    the first ceil(n/2) valid nodes known, and the edges among them."""
    known = (np.arange(N)[None, :] < np.ceil(flags.sum(1) / 2)[:, None]) & flags
    arrays = {}
    if which in ("both", "adj"):
        arrays.update(gt_adjs=rng.uniform(-1, 1, a_shape).astype(np.float32),
                      mask_adjs=known[:, :, None] & known[:, None, :])
    if which in ("both", "node"):
        arrays.update(gt_nodes=rng.uniform(-1, 1, x_shape).astype(np.float32),
                      mask_nodes=known)
    return arrays


def _known_exact(out_a, out_x, ip, flags):
    """The known valid entries of the output equal the ground truth exactly."""
    valid_pair = flags[:, :, None] & flags[:, None, :]
    if "mask_adjs" in ip:
        m = ip["mask_adjs"] & valid_pair
        assert m.any() and np.array_equal(out_a[m], ip["gt_adjs"][m])
        assert not np.array_equal(out_a[~m & valid_pair], ip["gt_adjs"][~m & valid_pair])
    if "mask_nodes" in ip:
        m = ip["mask_nodes"] & flags
        assert m.any() and np.array_equal(out_x[m], ip["gt_nodes"][m])


# (inpainted entries, edge / node channels, symmetric noise, self-conditioning
#  with refresh p, snapshots, init given, churn)
TOY_CASES = [
    ("both", 2, 3, False, 0.0, 3, False, 40.0),
    ("adj", 1, 5, True, 0.0, 0, True, 40.0),
    ("node", 1, 2, False, 1.0, 4, False, 40.0),
    ("both", 1, 5, True, 0.5, 8, True, 40.0),
    ("none", 2, 1, False, 0.0, 2, True, 0.0),
    ("both", 1, 5, False, 0.0, 3, False, 40.0, None),
]


@pytest.mark.parametrize("which,edge_chan,node_chan,sym,refresh_p,interim,init,churn,sigma_max",
                         [c if len(c) == 9 else c + (TOY_SIGMA_MAX,) for c in TOY_CASES])
def test_toy_sampler_matches_jax(which, edge_chan, node_chan, sym, refresh_p, interim, init,
                                 churn, sigma_max):
    num_steps = 5
    kw = dict(S_churn=churn, symmetric_noise=sym, self_condition=refresh_p > 0 or which == "adj",
              precond_self_cond_refresh_p=refresh_p, sigma_max=sigma_max)
    js, ts = _samplers(num_steps, **kw)
    rng = np.random.default_rng(3)
    flags = node_flags(B, N, COUNTS)
    a_shape = (B, N, N) + ((edge_chan,) if edge_chan > 1 else ())
    x_shape = (B, N) + ((node_chan,) if node_chan > 1 else ())
    ip = _inpaint_arrays(rng, flags, a_shape, x_shape, which) if which != "none" else {}
    inits = {}
    if init:
        inits = dict(init_adjs=rng.standard_normal(a_shape).astype(np.float32),
                     init_nodes=rng.standard_normal(x_shape).astype(np.float32))

    j_out = js.sample(_toy(jnp), jax.random.PRNGKey(SEED), jnp.asarray(flags), node_chan,
                      edge_chan, init_adjs=None if not init else jnp.asarray(inits["init_adjs"]),
                      init_nodes=None if not init else jnp.asarray(inits["init_nodes"]),
                      num_interim=interim,
                      inpaint={k: jnp.asarray(v) for k, v in ip.items()} or None)
    noise = JaxKeyNoise(SEED, num_steps, refresh=ts.self_condition and refresh_p > 0,
                        inpaint=bool(ip))
    t_out = ts.sample(_toy(torch), torch.from_numpy(flags), node_chan, edge_chan, noise=noise,
                      num_interim=interim,
                      inpaint={k: torch.from_numpy(v) for k, v in ip.items()} or None,
                      **{k: torch.from_numpy(v) for k, v in inits.items()})
    assert len(t_out) == len(j_out) == (4 if interim else 2)
    if interim:
        assert t_out[2].shape == (min(interim, num_steps) + 1,) + a_shape
    for t, j in zip(t_out, j_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOY_RTOL,
                                   atol=TOY_ATOL if sigma_max else DEFAULT_RANGE_ATOL)
    if init:  # slot 0 is the unscaled initial sample itself
        if interim:
            np.testing.assert_array_equal(t_out[2][0].numpy(), inits["init_adjs"])
        assert not any(k.startswith("init") for _, k in noise.requests)
    kinds = {k for _, k in noise.requests}
    assert ("inpaint_adj" in kinds) == ("gt_adjs" in ip)
    assert ("inpaint_node" in kinds) == ("gt_nodes" in ip)
    assert not any(step >= num_steps for step, _ in noise.requests)  # nothing drawn at sigma 0
    _known_exact(t_out[0].numpy(), t_out[1].numpy(), ip, flags)


def test_interim_slots_follow_the_jax_grid():
    """More snapshots than steps are capped; slot k + 1 holds the output of
    step clip(linspace(0, S, n).astype(int), 0, S - 1)[k]."""
    _, ts = _samplers(3, S_churn=0.0)
    flags = torch.from_numpy(node_flags(2, 4, [4, 2]))
    seen = []

    def den(a, x, sigmas, sc_a, sc_x):
        seen.append(float(sigmas[0]))
        return torch.full_like(a, float(len(seen))), torch.full_like(x, float(len(seen)))
    a, x, ia, ix = ts.sample(den, flags, 1, 1, seed=0, num_interim=7)
    assert ia.shape == (4, 2, 4, 4) and ix.shape == (4, 2, 4)
    # the last snapshot is the final output; every slot was written
    torch.testing.assert_close(ia[-1], a, rtol=0, atol=0)
    assert all(float(s.abs().sum()) > 0 for s in ia)


@pytest.mark.parametrize("interim", [0, 3])
def test_small_model_inpaint_matches_jax(interim):
    from diffusesg_tpu.models.channels import resolve_sampling_channels
    from diffusesg_tpu.models.precond import precond_forward
    from diffusesg_tpu.sampling import get_mc_sampler as jget
    from diffusesg_torch.sampling import get_mc_sampler
    from diffusesg_torch.serving.generate import make_denoiser

    jcfg, tcfg = load_pair(num_steps=4, s_churn=40.0)
    jm, params, tm = model_pair(jcfg, tcfg)
    n = tcfg.dataset.max_node_num
    counts = [16, 9, 4]
    flags = node_flags(len(counts), n, counts)
    info = resolve_sampling_channels(jcfg)
    rng = np.random.default_rng(5)
    known = (np.arange(n)[None, :] < np.ceil(flags.sum(1) * 0.5)[:, None]) & flags
    ip = dict(gt_adjs=rng.uniform(-1, 1, (len(counts), n, n)).astype(np.float32),
              gt_nodes=rng.uniform(-1, 1, (len(counts), n, 5)).astype(np.float32),
              mask_adjs=known[:, :, None] & known[:, None, :], mask_nodes=known)

    js = jget(jcfg)

    def run(p, key, f, ipj):
        def denoiser(a, x, sigmas, sc_a, sc_x):
            return precond_forward(lambda *args: jm.apply(p, *args), "edm", a, x, f, sigmas,
                                   sc_a, sc_x)
        return js.sample(denoiser, key, f, info["num_node_chan"], info["num_adj_chan"],
                         num_interim=interim, inpaint=ipj)
    j_out = jax.jit(run)(params, jax.random.PRNGKey(SEED), jnp.asarray(flags),
                         {k: jnp.asarray(v) for k, v in ip.items()})

    ts = get_mc_sampler(tcfg)
    tflags = torch.from_numpy(flags)
    t_out = ts.sample(make_denoiser(tm, tcfg, tflags), tflags, 5, 1,
                      noise=JaxKeyNoise(SEED, ts.num_steps, inpaint=True),
                      num_interim=interim, inpaint={k: torch.from_numpy(v) for k, v in ip.items()})
    assert len(t_out) == len(j_out)
    for t, j in zip(t_out, j_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=SAMPLE_ATOL, rtol=SAMPLE_RTOL)
    _known_exact(t_out[0].numpy(), t_out[1].numpy(), ip, flags)
