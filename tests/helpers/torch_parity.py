"""Shared fixtures of the port-vs-JAX parity tests (tests/test_torch_*.py).

Both packages read the same YAML; the weights come from the JAX package's
``init_params``, are redrawn from a seeded numpy generator at a scale that
makes every path of the network matter (the stock init's 0.02 weights and
zero biases leave outputs near 1e-6, where any tolerance is vacuous), and
are carried across with ``diffusesg_torch.utils.weights``.
"""
from __future__ import annotations

import os

import numpy as np

# fp32 parity bar the JAX package met against the PyTorch reference
# (tests/test_reference_parity.py:124-125)
ATOL, RTOL = 2e-4, 1e-3

SMALL_CFG = "configs/vg_small_test.yaml"
VG_CFG = "configs/edm_diffuse_sg_regular_visual_genome.yaml"
COCO_CFG = "configs/edm_diffuse_sg_regular_coco.yaml"


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


def coco_small_overrides(cfg, num_steps: int = 4, s_churn: float | None = None):
    """The COCO-Stuff config (171 node types, 7 edge types, window 10) at
    N=20, embed 24, depths (2, 2): a 20x20 stage with an unshifted and a
    shifted (5) window-10 block, a 10x10 stage whose window is the grid, one
    merge, one breakup and both readout heads."""
    small_overrides(cfg, num_steps, s_churn)
    with cfg.unlocked():
        cfg.dataset.max_node_num = 20
        cfg.model.window_size = 10
    return cfg


def load_coco_pair(**kw):
    """(JAX config, port config) of the COCO-Stuff YAML, cut to a small size."""
    from diffusesg_tpu.config import load_config as jload
    from diffusesg_torch.config import load_config as tload
    return coco_small_overrides(jload(COCO_CFG), **kw), coco_small_overrides(tload(COCO_CFG), **kw)


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


class JaxKeyNoise:
    """The JAX sampler's draws, by its key schedule, for the port's noise
    protocol: ``rng, rng_init = split(key)``, ``rng_a, rng_x =
    split(rng_init)`` for the initial sample (edm_sampler.py:305-308, 249;
    split even when ``init_*`` is given), then per step ``rng, k1, k2 =
    split(rng, 3)`` for the churn noise of adjs and nodes, with the
    self-cond refresh on ``rng, k3, k4 = split(rng, 3)`` for its Bernoulli
    draws at the Euler and Heun evals (:425-428, :414), and with inpainting
    ``rng, k_ip = split(rng)``, ``k_a, k_x = split(k_ip)`` for the known
    entries' re-noising (:436-440, :366).  ``key`` is a seed or a PRNG key."""

    def __init__(self, key, num_steps: int, refresh: bool = False, inpaint: bool = False):
        import jax
        rng = jax.random.PRNGKey(key) if isinstance(key, int) else key
        self.key, self.schedule = rng, (num_steps, refresh, inpaint)
        rng, rng_init = jax.random.split(rng)
        self.init = dict(zip(("init_adj", "init_node"), jax.random.split(rng_init)))
        self.steps = []
        for _ in range(num_steps):
            rng, k1, k2 = jax.random.split(rng, 3)
            keys = {"churn_adj": k1, "churn_node": k2}
            if refresh:
                rng, k3, k4 = jax.random.split(rng, 3)
                keys.update(refresh_euler=k3, refresh_heun=k4)
            if inpaint:
                rng, k_ip = jax.random.split(rng)
                keys.update(zip(("inpaint_adj", "inpaint_node"), jax.random.split(k_ip)))
            self.steps.append(keys)
        self.requests = []

    def fold_in(self, index: int) -> "JaxKeyNoise":
        """The draws of ``jax.random.fold_in(key, index)`` (a shard_map
        shard's key, diffusesg_tpu/serving/export.py:114-120)."""
        import jax
        return JaxKeyNoise(jax.random.fold_in(self.key, index), *self.schedule)

    def normal(self, step, kind, shape):
        import jax
        import torch
        self.requests.append((step, kind))
        key = self.init[kind] if step < 0 else self.steps[step][kind]
        return torch.from_numpy(np.array(jax.random.normal(key, tuple(shape))))

    def bernoulli(self, step, kind, p):
        import jax
        self.requests.append((step, kind))
        return bool(jax.random.bernoulli(self.steps[step][kind], p))


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

    def fold_in(self, index):
        """The draws of shard ``index`` under the JAX ``shard_map`` step, which
        folds the axis index into every step key (shardmap_dp.py:62-64)."""
        import jax
        return JaxTrainNoise([jax.random.fold_in(k, index) for k in self.keys])


def tiny_overrides(cfg):
    """The tiny config of __graft_entry__.py:18-27: vg_small_test at N=16,
    embed 48, depths (1, 1), fp32, the kernels off."""
    with cfg.unlocked():
        cfg.dataset.max_node_num = 16
        cfg.model.feature_dims = [48]
        cfg.model.depths = [1, 1]
        cfg.tpu.compute_dtype = "float32"
        cfg.tpu.use_pallas_attention = False
    return cfg


def tiny_port_model(tcfg, seed: int = 1, scale: float = 0.15):
    """The port's model for ``tcfg`` on the CPU, every parameter redrawn as
    N(0, scale^2) from a seeded numpy generator (as ``randomized_params``
    does for a flax tree), so processes that import no JAX build the same
    weights; ``diffusesg_torch.utils.weights.state_dict_to_flax`` carries
    them to the JAX package."""
    import torch
    from diffusesg_torch.models import make_model
    model = make_model(tcfg)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for _, p in sorted(model.named_parameters()):
            p.copy_(torch.from_numpy((rng.standard_normal(tuple(p.shape)) * scale)
                                     .astype(np.float32)))
    return model


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


DP_CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dp_child.py")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    """A port nothing listens on, from a socket bound to port 0."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(args, log_dir: str, world: int = 2, env=None):
    """Start ``world`` ranks of tests/helpers/torch_dp_child.py with ``args``,
    torchrun's rendezvous variables set, each rank's output in a file of
    ``log_dir`` (a pipe that nobody drains would stall the collectives);
    returns [(process, log path)]."""
    import subprocess
    import sys
    port = free_port()
    os.makedirs(log_dir, exist_ok=True)
    base = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    base.update(JAX_PLATFORMS="cpu", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                WORLD_SIZE=str(world), OMP_NUM_THREADS="1", DSG_DIST_TIMEOUT="120",
                **(env or {}))
    ranks = []
    for r in range(world):
        path = os.path.join(log_dir, f"rank{r}.log")
        with open(path, "w") as log:
            proc = subprocess.Popen([sys.executable, DP_CHILD, *args], cwd=REPO, stdout=log,
                                    stderr=subprocess.STDOUT,
                                    env=dict(base, RANK=str(r), LOCAL_RANK=str(r)))
        ranks.append((proc, path))
    return ranks


def wait_ranks(ranks, timeout: float = 240.0) -> list[str]:
    """Wait for the ranks of ``start_ranks``; kill them all when one fails or
    the time is up; returns their outputs, and raises unless each exited 0
    and printed CHILD_OK."""
    import time
    deadline = time.time() + timeout
    pending = list(ranks)
    while pending and time.time() < deadline:
        pending = [(p, f) for p, f in pending if p.poll() is None]
        if any(p.returncode not in (None, 0) for p, _ in ranks):
            break
        time.sleep(0.1)
    for p, _ in ranks:
        if p.poll() is None:
            p.kill()
            p.wait()
    outs = [open(f).read() for _, f in ranks]
    for r, ((p, _), out) in enumerate(zip(ranks, outs)):
        assert p.returncode == 0 and f"CHILD_OK {r}" in out, f"rank {r} rc {p.returncode}:\n{out}"
    return outs
