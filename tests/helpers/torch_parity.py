"""Shared fixtures of the port-vs-JAX parity tests (tests/test_torch_*.py).

Both packages read the same YAML; the weights come from the JAX package's
``init_params``, are redrawn from a seeded numpy generator at a scale that
makes every path of the network matter (the stock init's 0.02 weights and
zero biases leave outputs near 1e-6, where any tolerance is vacuous), and
are carried across with ``diffusesg_torch.utils.weights``.
"""
from __future__ import annotations

import numpy as np

# fp32 parity bar the JAX package met against the PyTorch reference
# (tests/test_reference_parity.py:124-125)
ATOL, RTOL = 2e-4, 1e-3

SMALL_CFG = "configs/vg_small_test.yaml"
VG_CFG = "configs/edm_diffuse_sg_regular_visual_genome.yaml"


def small_overrides(cfg, num_steps: int = 4, s_churn: float | None = None):
    """N=16, embed 24, depths (2, 2), window 8: one shifted block, one merge,
    one breakup and both readout heads run."""
    with cfg.unlocked():
        cfg.dataset.max_node_num = 16
        cfg.model.feature_dims = [24]
        cfg.model.depths = [2, 2]
        cfg.model.window_size = 8
        cfg.mcmc.num_steps = num_steps
        cfg.tpu.compute_dtype = "float32"
        if s_churn is not None:
            cfg.mcmc.s_churn = float(s_churn)
    return cfg


def load_pair(path: str = SMALL_CFG, **kw):
    """(JAX config, port config) of the same YAML with the same overrides."""
    from diffusesg_tpu.config import load_config as jload
    from diffusesg_torch.config import load_config as tload
    return small_overrides(jload(path), **kw), small_overrides(tload(path), **kw)


def randomized_params(params, seed: int = 1, scale: float = 0.15):
    """Every leaf of a flax tree redrawn as N(0, scale^2), numpy float32."""
    import jax
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (rng.standard_normal(np.shape(x)) * scale).astype(np.float32), params)


def model_pair(jcfg, tcfg, seed: int = 0):
    """(flax module, flax params, port module on the CPU) on shared weights."""
    import jax
    from diffusesg_tpu.models import build_model as jbuild
    from diffusesg_tpu.models.factory import init_params as jinit
    from diffusesg_torch.models import make_model
    from diffusesg_torch.utils.weights import flax_to_state_dict

    jm = jbuild(jcfg)
    params = randomized_params(jinit(jm, jcfg, jax.random.PRNGKey(seed)), seed + 1)
    tm = make_model(tcfg)
    tm.load_state_dict(flax_to_state_dict(params, int(tcfg.model.patch_size)), strict=True)
    return jm, params, tm.eval()


def node_flags(batch: int, n: int, counts) -> np.ndarray:
    f = np.zeros((batch, n), bool)
    for i, c in enumerate(counts):
        f[i, :c] = True
    return f


class JaxTrainNoise:
    """The JAX training step's draws, by its key schedule, for the port's
    noise protocol.  ``keys[step]`` is the key ``train_step`` gets at that
    step; ``loss_fn`` splits it into (objective, self-cond), the objective
    into (sigma, noise) and the noise into (adj, node)
    (train_step.py:69, edm.py:240, edm.py:222)."""

    def __init__(self, keys):
        self.keys = list(keys)
        self.requests = []

    def _key(self, step, kind):
        import jax
        rng_obj, rng_sc = jax.random.split(self.keys[step])
        rng_sigma, rng_noise = jax.random.split(rng_obj)
        rng_a, rng_x = jax.random.split(rng_noise)
        self.requests.append((step, kind))
        return {"sigma": rng_sigma, "noise_adj": rng_a, "noise_node": rng_x,
                "self_cond": rng_sc}[kind]

    def normal(self, step, kind, shape):
        import jax
        import torch
        return torch.from_numpy(np.array(jax.random.normal(self._key(step, kind), tuple(shape))))

    def uniform(self, step, kind, shape):
        import jax
        import torch
        return torch.from_numpy(np.array(jax.random.uniform(self._key(step, kind), tuple(shape))))

    def bernoulli(self, step, kind, p):
        import jax
        return bool(jax.random.bernoulli(self._key(step, kind), p))


def clean_batch(batch: int, n: int, counts, seed: int = 0, node_chan: int = 5):
    """(adjs [B,N,N], nodes [B,N,C], flags) in the ddpm range, padding zeroed;
    the last four node channels are boxes (cx, cy, w, h) mapped to [-1, 1]."""
    rng = np.random.default_rng(seed)
    flags = node_flags(batch, n, counts)
    pair = flags[:, :, None] & flags[:, None, :]
    adjs = (rng.uniform(-1, 1, (batch, n, n)) * pair).astype(np.float32)
    nodes = rng.uniform(-1, 1, (batch, n, node_chan))
    nodes[..., -4:-2] = rng.uniform(-0.5, 0.5, (batch, n, 2))   # centres
    nodes[..., -2:] = rng.uniform(-0.8, -0.2, (batch, n, 2))    # sizes 0.1 .. 0.4
    nodes = (nodes * flags[:, :, None]).astype(np.float32)
    return adjs, nodes, flags
