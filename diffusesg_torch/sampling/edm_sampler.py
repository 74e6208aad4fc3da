"""EDM stochastic Heun/Euler sampler for joint node + adjacency diffusion.

Counterpart of diffusesg_tpu/sampling/edm_sampler.py (``sample`` with
``init_*``, interim snapshots, inpainting and ``chunk_steps``, and
``sample_adj``, the adj-only path).  The per-step coefficients are computed
host-side in float64 exactly as the JAX package does and put on the
sampling device once, as the [num_steps, 12] float32 table that is the JAX
scan's input; a step reads its row as 0-d tensors (``step``), so the step
holds no host value and runs as well inside a CUDA graph
(``sampling/compiled.py``) as eagerly.  The JAX ``lax.scan`` is a Python
loop here, and its ``lax.cond``s are host facts that pick the step's
variant (``StepVariant``).  Reference behaviours kept: churn gated on
S_min <= sigma <= S_max, the Heun quirk of re-evaluating at (x_hat, t_hat)
(``heun_reuse_xhat``), self-conditioning on the previous estimate, and the
opt-in sampling-time self-cond refresh (``precond_self_cond_refresh_p``).

Random draws come from a noise source (``TorchNoise`` by default) keyed by
step and kind, so a test can hand the port the JAX sampler's own draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.masking import mask_adjs, mask_nodes, sym_from_normal
from ..utils import tracing

# DenoiserFn: (adjs, nodes, sigmas[B], self_cond_a, self_cond_x) -> (D_adj, D_node)
DenoiserFn = Callable[..., tuple[torch.Tensor, torch.Tensor]]


class TorchNoise:
    """Default noise source: normals from a ``torch.Generator`` on the
    sampling device, Bernoulli draws (host decisions) from one on the CPU.

    ``normal(step, kind, shape)`` with kind in init_adj / init_node (step -1),
    churn_adj / churn_node and, when inpainting, inpaint_adj / inpaint_node
    (the known entries re-noised at the step's sigma_hat); ``bernoulli(step, kind, p)`` with kind in
    refresh_euler / refresh_heun.  Training draws through the same source:
    kinds sigma, noise_adj, noise_node (``normal``, or ``uniform`` for the
    vp/ve sigma distributions) and self_cond (``bernoulli``).
    ``fold_in(index)`` is a new source of its own for ``index`` (a rank's
    stream), the counterpart of ``jax.random.fold_in``."""

    def __init__(self, seed: int, device: torch.device | str):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.host_gen = torch.Generator().manual_seed(self.seed + 1)

    def fold_in(self, index: int) -> "TorchNoise":
        seed = np.random.SeedSequence([self.seed, int(index)]).generate_state(1)[0]
        return TorchNoise(int(seed), self.device)

    def normal(self, step: int, kind: str, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.gen, device=self.device)

    def uniform(self, step: int, kind: str, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.gen, device=self.device)

    def bernoulli(self, step: int, kind: str, p: float) -> bool:
        return bool(torch.rand((), generator=self.host_gen) < p)


class StepVariant(NamedTuple):
    """The host's facts of one step, which pick its program: whether the
    churn draws (``noise_coef != 0``), whether the Heun correction runs
    (every Heun step but the last), and whether the self-conditioning
    refresh fires at the Euler and at the Heun evaluation (the host
    Bernoulli draws)."""
    churn: bool
    heun: bool
    refresh_euler: bool
    refresh_heun: bool


class EagerSteps:
    """The sampler's steps run eagerly: the carry (adjs, nodes, sc_a, sc_x)
    as tensors that each step replaces.  ``sampling/compiled.py`` has the
    same interface over static buffers and CUDA graphs."""

    def __init__(self, sampler, denoiser_fn, node_flags, ip, table):
        self.sampler, self.denoiser_fn, self.node_flags = sampler, denoiser_fn, node_flags
        self.ip, self.table = ip, table

    def start(self, adjs, nodes):
        self.carry = (adjs, nodes, torch.zeros_like(adjs), torch.zeros_like(nodes))

    def step(self, i: int, variant: StepVariant, draws) -> None:
        self.carry = self.sampler.step(self.denoiser_fn, self.node_flags, self.ip, self.carry,
                                       self.table[i], draws, variant)

    def current(self):
        return self.carry[:2]

    finish = current


def run_steps(steps):
    """Run a generator of steps (``NodeAdjEDMSampler.sample_steps``) to its
    end; what it returns."""
    while True:
        try:
            next(steps)
        except StopIteration as done:
            return done.value


def _np_schedules(schedule: str):
    if schedule == "vp":
        bd, bm = 19.9, 0.1
        sigma = lambda t: np.sqrt(np.expm1(0.5 * bd * np.asarray(t, np.float64) ** 2 + bm * t))  # noqa: E731
        deriv = lambda t: 0.5 * (bm + bd * np.asarray(t, np.float64)) * (sigma(t) + 1.0 / sigma(t))  # noqa: E731
        inv = lambda s: (np.sqrt(bm ** 2 + 2 * bd * np.log1p(np.asarray(s, np.float64) ** 2)) - bm) / bd  # noqa: E731
    elif schedule == "ve":
        sigma = lambda t: np.sqrt(np.asarray(t, np.float64))  # noqa: E731
        deriv = lambda t: 0.5 / np.sqrt(np.asarray(t, np.float64))  # noqa: E731
        inv = lambda s: np.asarray(s, np.float64) ** 2  # noqa: E731
    elif schedule in ("linear", "edm"):
        sigma = lambda t: np.asarray(t, np.float64)  # noqa: E731
        deriv = lambda t: np.ones_like(np.asarray(t, np.float64))  # noqa: E731
        inv = lambda s: np.asarray(s, np.float64)  # noqa: E731
    else:
        raise NotImplementedError(f"unknown schedule {schedule}")
    return sigma, deriv, inv


def _np_sigma_grid(discretization: str, num_steps: int, sigma_min: float, sigma_max: float,
                   rho: float = 7.0, C_1: float = 0.001, C_2: float = 0.008,
                   M: int = 1000) -> np.ndarray:
    """Noise-level discretizations (reference: edm.py:69-88), float64."""
    idx = np.arange(num_steps, dtype=np.float64)
    if discretization == "vp":
        orig_t = 1 + idx / (num_steps - 1) * (1e-3 - 1)
        return _np_schedules("vp")[0](orig_t)
    if discretization == "ve":
        orig_t = (sigma_max ** 2) * ((sigma_min ** 2 / sigma_max ** 2) ** (idx / (num_steps - 1)))
        return np.sqrt(orig_t)
    if discretization == "iddpm":
        u = np.zeros(M + 1, dtype=np.float64)
        alpha_bar = lambda j: np.sin(0.5 * np.pi * j / M / (C_2 + 1)) ** 2  # noqa: E731
        for j in range(M, 0, -1):
            u[j - 1] = np.sqrt((u[j] ** 2 + 1) / max(alpha_bar(j - 1) / alpha_bar(j), C_1) - 1)
        u_filtered = u[np.logical_and(u >= sigma_min, u <= sigma_max)]
        sel = np.round((len(u_filtered) - 1) / (num_steps - 1) * idx).astype(np.int64)
        return u_filtered[sel]
    assert discretization == "edm"
    return (sigma_max ** (1 / rho)
            + idx / (num_steps - 1) * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho


_DEFAULT_SIGMA_RANGES = {
    "vp": (None, None),
    "ve": (0.02, 100.0),
    "iddpm": (0.002, 81.0),
    "edm": (0.002, 80.0),
}


@dataclasses.dataclass(frozen=True)
class NodeAdjEDMSampler:
    """Stochastic sampler for joint node + adjacency EDM diffusion (the
    fields and defaults of the JAX package's sampler)."""
    solver: str = "heun"
    discretization: str = "edm"
    schedule: str = "linear"
    scaling: str = "none"
    num_steps: int = 256
    alpha: float = 1.0
    S_churn: float = 40.0
    S_min: float = 0.05
    S_max: float = 50.0
    S_noise: float = 1.003
    sigma_min: float | None = None
    sigma_max: float | None = None
    rho: float = 7.0
    self_condition: bool = False
    symmetric_noise: bool = False
    heun_reuse_xhat: bool = True
    precond_self_cond_refresh_p: float = 0.0

    def __post_init__(self):
        for name, allowed in (("solver", ("euler", "heun")),
                              ("discretization", ("vp", "ve", "iddpm", "edm")),
                              ("schedule", ("vp", "ve", "linear")), ("scaling", ("vp", "none"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {getattr(self, name)!r}")

    def _sigma_range(self):
        d_min, d_max = _DEFAULT_SIGMA_RANGES[self.discretization]
        if self.discretization == "vp":
            sig_vp = _np_schedules("vp")[0]
            d_min, d_max = float(sig_vp(1e-3)), float(sig_vp(1.0))
        return (d_min if self.sigma_min is None else self.sigma_min,
                d_max if self.sigma_max is None else self.sigma_max)

    def step_coefficients(self) -> np.ndarray:
        """[num_steps, 12] float32 per-step coefficients, computed in float64.

        Columns: (noise_coef, s_ratio, h, A_hat, B_hat, A_prime, B_prime,
                  sigma_hat, inv_s_hat, is_heun, sigma_prime, inv_s_prime).
        """
        sigma, sigma_deriv, sigma_inv = _np_schedules(self.schedule)
        if self.scaling == "vp":
            s = lambda t: 1.0 / np.sqrt(1.0 + sigma(t) ** 2)  # noqa: E731
            s_deriv = lambda t: -sigma(t) * sigma_deriv(t) * (s(t) ** 3)  # noqa: E731
        else:
            s = lambda t: np.ones_like(np.asarray(t, np.float64))  # noqa: E731
            s_deriv = lambda t: np.zeros_like(np.asarray(t, np.float64))  # noqa: E731
        smin, smax = self._sigma_range()
        sigma_steps = _np_sigma_grid(self.discretization, self.num_steps, smin, smax, self.rho)
        t_steps = np.concatenate([sigma_inv(sigma_steps), np.zeros(1)])  # t_N = 0

        rows = []
        for i in range(self.num_steps):
            t_cur, t_next = t_steps[i], t_steps[i + 1]
            sig_cur = float(sigma(t_cur))
            gamma = (min(self.S_churn / self.num_steps, math.sqrt(2) - 1)
                     if self.S_min <= sig_cur <= self.S_max else 0.0)
            t_hat = float(sigma_inv(sig_cur + gamma * sig_cur))
            sig_hat = float(sigma(t_hat))
            s_hat, s_cur = float(s(t_hat)), float(s(t_cur))
            noise_coef = math.sqrt(max(sig_hat ** 2 - sig_cur ** 2, 0.0)) * s_hat * self.S_noise
            h = float(t_next - t_hat)
            A_hat = float(sigma_deriv(t_hat)) / sig_hat + float(s_deriv(t_hat)) / s_hat
            B_hat = float(sigma_deriv(t_hat)) * s_hat / sig_hat
            t_prime = t_hat + self.alpha * h
            if i == self.num_steps - 1:
                A_prime, B_prime, sig_prime, inv_s_prime = 0.0, 0.0, 1.0, 1.0
            else:
                sig_prime = float(sigma(t_prime))
                s_prime = float(s(t_prime))
                A_prime = (float(sigma_deriv(t_prime)) / sig_prime
                           + float(s_deriv(t_prime)) / s_prime)
                B_prime = float(sigma_deriv(t_prime)) * s_prime / sig_prime
                inv_s_prime = 1.0 / s_prime
            is_heun = 1.0 if (self.solver == "heun" and i < self.num_steps - 1) else 0.0
            rows.append([noise_coef, s_hat / s_cur, h, A_hat, B_hat, A_prime, B_prime,
                         sig_hat, 1.0 / s_hat, is_heun, sig_prime, inv_s_prime])
        return np.asarray(rows, dtype=np.float32)

    def init_scale(self) -> float:
        """sigma(t_0) * s(t_0) applied to the initial noise."""
        sigma, _, sigma_inv = _np_schedules(self.schedule)
        smin, smax = self._sigma_range()
        sigma_steps = _np_sigma_grid(self.discretization, self.num_steps, smin, smax, self.rho)
        t0 = sigma_inv(sigma_steps)[0]
        s0 = 1.0 if self.scaling == "none" else 1.0 / math.sqrt(1.0 + float(sigma(t0)) ** 2)
        return float(sigma(t0)) * s0

    def _adj_noise(self, noise, step: int, kind: str, shape) -> torch.Tensor:
        draw = noise.normal(step, kind, shape)
        return sym_from_normal(draw) if self.symmetric_noise else draw

    def gen_init_sample(self, noise, node_flags, num_node_chan: int, num_edge_chan: int):
        """Initial noise draw, channels-last, masked; channel axes of size 1
        squeezed (reference: edm.py:257-289)."""
        b, n = node_flags.shape[:2]
        init_adjs = mask_adjs(self._adj_noise(noise, -1, "init_adj", (b, n, n, num_edge_chan)),
                              node_flags)
        if num_edge_chan == 1:
            init_adjs = init_adjs[..., 0]
        init_nodes = mask_nodes(noise.normal(-1, "init_node", (b, n, num_node_chan)), node_flags)
        if num_node_chan == 1:
            init_nodes = init_nodes[..., 0]
        return init_adjs, init_nodes

    def sample(self, denoiser_fn: DenoiserFn, node_flags, num_node_chan: int,
               num_edge_chan: int, noise=None, seed: int = 0, init_adjs=None, init_nodes=None,
               num_interim: int = 0, inpaint: dict | None = None,
               chunk_steps: int | None = None):
        """Run the reverse diffusion; returns (adjs, nodes) in float32, or
        (adjs, nodes, interim_a, interim_x) when ``num_interim`` > 0.

        ``chunk_steps`` runs the step loop in chunks of at most that many
        steps, with a ``torch.cuda.synchronize`` after each chunk on a CUDA
        device: the counterpart of the JAX package's separate device programs
        per chunk (edm_sampler.py:271-358), a point of progress and
        pre-emption.  The draws are keyed by step and kind, so the output is
        bit-equal to the unchunked loop's.

        ``noise`` is the source of random draws (default: ``TorchNoise`` from
        ``seed`` on the flags' device).  ``init_adjs`` / ``init_nodes``
        replace the initial draw (both or neither; unscaled, as
        ``gen_init_sample`` returns it).

        ``num_interim`` keeps min(num_interim, num_steps) snapshots:
        slot 0 the unscaled initial sample, slot k + 1 the output of step
        clip(linspace(0, S, n).astype(int), 0, S - 1)[k]; each stack is
        [n + 1, B, ...] (edm_sampler.py:317-328).

        ``inpaint`` (conditional completion, edm_sampler.py:271-300): a dict
        with keys among gt_adjs / gt_nodes (known clean values, encoded
        space) and mask_adjs [B, N, N(, 1)] / mask_nodes [B, N(, 1)] (1 where
        the entry is known).  After each step's churn the known entries are
        re-noised from the ground truth at sigma_hat; the output carries the
        exact known values."""
        return run_steps(self.sample_steps(
            denoiser_fn, node_flags, num_node_chan, num_edge_chan, noise=noise, seed=seed,
            init_adjs=init_adjs, init_nodes=init_nodes, num_interim=num_interim,
            inpaint=inpaint, chunk_steps=chunk_steps))

    @torch.no_grad()
    def sample_steps(self, denoiser_fn: DenoiserFn, node_flags, num_node_chan: int,
                     num_edge_chan: int, noise=None, seed: int = 0, init_adjs=None,
                     init_nodes=None, num_interim: int = 0, inpaint: dict | None = None,
                     chunk_steps: int | None = None):
        """``sample`` as a generator: it yields after each step and returns
        what ``sample`` returns, so that one thread can advance several
        samplings a step each in turn (``serving/export.py``'s shards)."""
        noise = noise if noise is not None else TorchNoise(seed, node_flags.device)
        init_adjs, init_nodes = self.initial_sample(noise, node_flags, num_node_chan,
                                                    num_edge_chan, init_adjs, init_nodes)
        ip = inpaint_tuple(inpaint)
        table = self.coefficient_table(node_flags.device)
        steps = EagerSteps(self, denoiser_fn, node_flags, ip, table)
        return (yield from self.run_loop(steps, noise, node_flags, init_adjs, init_nodes,
                                         num_interim, ip, chunk_steps))

    def coefficient_table(self, device) -> torch.Tensor:
        """``step_coefficients()`` on ``device``: the JAX scan's ``coefs``."""
        return torch.from_numpy(self.step_coefficients()).to(device)

    def initial_sample(self, noise, node_flags, num_node_chan, num_edge_chan, init_adjs=None,
                       init_nodes=None):
        """The unscaled initial sample: ``init_*`` when both are given, else
        the initial draw (``gen_init_sample``)."""
        if init_adjs is None or init_nodes is None:
            return self.gen_init_sample(noise, node_flags, num_node_chan, num_edge_chan)
        return init_adjs, init_nodes

    def run_loop(self, steps, noise, node_flags, init_adjs, init_nodes, num_interim: int, ip,
                 chunk_steps: int | None):
        """The step loop over ``steps`` (``EagerSteps`` or the compiled
        sampler's): per step the host facts and draws from ``noise``, the
        step, the interim snapshot and the chunk's synchronize; yields after
        each step and returns ``sample``'s outputs.  The span
        ``sampler.step`` holds one step but the synchronize, with
        ``sampler.draws`` inside it."""
        if chunk_steps is not None and chunk_steps < 1:
            raise ValueError(f"chunk_steps must be at least 1, got {chunk_steps}")
        num_interim = min(num_interim, self.num_steps)
        scale0 = self.init_scale()
        adjs, nodes = init_adjs * scale0, init_nodes * scale0
        steps.start(adjs, nodes)
        slot_of_step = {}
        if num_interim > 0:
            snap_steps = np.clip(np.linspace(0, self.num_steps, num_interim).astype(int), 0,
                                 self.num_steps - 1)
            slot_of_step = {int(s): k + 1 for k, s in enumerate(snap_steps)}
            interim_a = adjs.new_zeros((num_interim + 1,) + tuple(adjs.shape))
            interim_x = nodes.new_zeros((num_interim + 1,) + tuple(nodes.shape))
            interim_a[0], interim_x[0] = init_adjs, init_nodes
        sync = chunk_steps is not None and node_flags.device.type == "cuda"
        for i, row in enumerate(self.step_coefficients()):
            # closed before the yield: callers step several loops in turn
            with tracing.span("sampler.step"):
                variant = self.step_variant(noise, i, row)
                with tracing.span("sampler.draws"):
                    draws = self.step_draws(noise, i, variant, adjs.shape, nodes.shape, ip)
                steps.step(i, variant, draws)
                if i in slot_of_step:
                    interim_a[slot_of_step[i]], interim_x[slot_of_step[i]] = steps.current()
            if sync and ((i + 1) % chunk_steps == 0 or i + 1 == self.num_steps):
                torch.cuda.synchronize(node_flags.device)  # the chunk's end
            yield
        adjs, nodes = steps.finish()
        if any(v is not None for v in ip):
            # the exact known values in the output (edm_sampler.py:352-355)
            adjs, nodes = self._inpaint(node_flags, ip, adjs, nodes, None, None, None)
        if num_interim > 0:
            return adjs, nodes, interim_a, interim_x
        return adjs, nodes

    def step_variant(self, noise, step: int, row) -> StepVariant:
        """Step ``step``'s host facts (``row`` its float32 coefficients on
        the host).  The refresh Bernoulli draws are made here, the Euler
        evaluation's and then, where the Heun correction evaluates again,
        the Heun one's (edm_sampler.py:414-417)."""
        heun = bool(row[9] > 0.5)
        refresh = self.self_condition and self.precond_self_cond_refresh_p > 0.0
        second = heun and (self.self_condition or not self.heun_reuse_xhat)
        p = self.precond_self_cond_refresh_p
        r_euler = refresh and noise.bernoulli(step, "refresh_euler", p)
        r_heun = refresh and second and noise.bernoulli(step, "refresh_heun", p)
        return StepVariant(bool(row[0] != 0.0), heun, bool(r_euler), bool(r_heun))

    def step_draws(self, noise, step: int, variant: StepVariant, adj_shape, node_shape, ip):
        """Step ``step``'s normals from ``noise``, unsymmetrized: the churn's
        (adj, node) where it draws, then the re-noising of the known
        entries where inpainting sets them; None for what is not drawn."""
        churn_a = churn_x = ip_a = ip_x = None
        if variant.churn:
            churn_a = noise.normal(step, "churn_adj", adj_shape)
            churn_x = noise.normal(step, "churn_node", node_shape)
        gt_a, mask_a, gt_x, mask_x = ip
        if gt_a is not None and mask_a is not None:
            ip_a = noise.normal(step, "inpaint_adj", adj_shape)
        if gt_x is not None and mask_x is not None:
            ip_x = noise.normal(step, "inpaint_node", node_shape)
        return churn_a, churn_x, ip_a, ip_x

    def _sym(self, draw):
        return sym_from_normal(draw) if self.symmetric_noise else draw

    def step(self, denoiser_fn: DenoiserFn, node_flags, ip, carry, row, draws,
             variant: StepVariant):
        """One step (the JAX scan body, edm_sampler.py:419-499): carry (adjs,
        nodes, sc_a, sc_x) -> the next carry.  ``row`` is the step's [12]
        float32 coefficients on the device, read as 0-d tensors, ``draws``
        ``step_draws``' normals (or static buffers holding them) and
        ``variant`` ``step_variant``'s facts.  The f32 products follow the
        JAX step's order."""
        adjs, nodes, sc_a, sc_x = carry
        (noise_coef, s_ratio, h, A_hat, B_hat, A_prime, B_prime, sigma_hat, inv_s_hat,
         _, sigma_prime, inv_s_prime) = row.unbind(0)
        churn_a, churn_x, ip_a, ip_x = draws
        batch = node_flags.shape[0]

        def denoise(a_in, x_in, inv_s, sigma, sa, sx, refresh):
            sigma_vec = sigma.expand(batch)

            def call(s_a, s_x):
                D_a, D_x = denoiser_fn(a_in * inv_s, x_in * inv_s, sigma_vec, s_a, s_x)
                return mask_adjs(D_a, node_flags), mask_nodes(D_x, node_flags)

            base = call(sa, sx)
            return call(*base) if refresh else base

        # churn re-noising (edm.py:354-366); a zero coefficient draws nothing
        a_hat, x_hat = s_ratio * adjs, s_ratio * nodes
        if variant.churn:
            a_hat = a_hat + noise_coef * self._sym(churn_a)
            x_hat = x_hat + noise_coef * churn_x
        a_hat, x_hat = mask_adjs(a_hat, node_flags), mask_nodes(x_hat, node_flags)
        if any(v is not None for v in ip):
            a_hat, x_hat = self._inpaint(node_flags, ip, a_hat, x_hat, sigma_hat, ip_a, ip_x)

        # Euler evaluation (edm.py:368-391)
        den_a, den_x = denoise(a_hat, x_hat, inv_s_hat, sigma_hat, sc_a, sc_x,
                               variant.refresh_euler)
        d_a = mask_adjs(A_hat * a_hat - B_hat * den_a, node_flags)
        d_x = mask_nodes(A_hat * x_hat - B_hat * den_x, node_flags)

        if variant.heun:
            sc_a2 = den_a if self.self_condition else sc_a
            sc_x2 = den_x if self.self_condition else sc_x
            alpha_h = self.alpha * h
            a_pr = a_hat + alpha_h * d_a
            x_pr = x_hat + alpha_h * d_x
            if self.heun_reuse_xhat and not self.self_condition:
                # the 2nd eval's inputs equal the Euler eval's: reuse it
                den_a2, den_x2 = den_a, den_x
            elif self.heun_reuse_xhat:
                # reference quirk: the 2nd eval reuses x_hat/t_hat (edm.py:400-405)
                den_a2, den_x2 = denoise(a_hat, x_hat, inv_s_hat, sigma_hat, sc_a2, sc_x2,
                                         variant.refresh_heun)
            else:
                den_a2, den_x2 = denoise(a_pr, x_pr, inv_s_prime, sigma_prime, sc_a2, sc_x2,
                                         variant.refresh_heun)
            d_a2 = A_prime * a_pr - B_prime * den_a2
            d_x2 = A_prime * x_pr - B_prime * den_x2
            w1, w2 = 1.0 - 1.0 / (2.0 * self.alpha), 1.0 / (2.0 * self.alpha)
            adjs = a_hat + h * (w1 * d_a + w2 * d_a2)
            nodes = x_hat + h * (w1 * d_x + w2 * d_x2)
            den_a, den_x = den_a2, den_x2
        else:
            adjs, nodes = a_hat + h * d_a, x_hat + h * d_x

        adjs, nodes = mask_adjs(adjs, node_flags), mask_nodes(nodes, node_flags)
        if self.self_condition:
            sc_a, sc_x = den_a, den_x
        return adjs, nodes, sc_a, sc_x

    @staticmethod
    def _adj_only_joint(denoiser_fn, node_flags):
        """An adj-only denoiser in the joint signature: the nodes ride along
        as an inert dummy modality (edm_sampler.py:503-508)."""
        def joint_fn(adjs, nodes, sigmas, sc_a, sc_x):
            return denoiser_fn(adjs, node_flags, sigmas, sc_a), torch.zeros_like(nodes)
        return joint_fn

    @torch.no_grad()
    def sample_adj(self, denoiser_fn, node_flags, noise=None, seed: int = 0, init_adjs=None,
                   num_interim: int = 0, chunk_steps: int | None = None):
        """Adj-only sampling (edm_sampler.py:510-532; the reference's adj-only
        EDMSampler.sample, edm.py:121-230): one [B, N, N] modality from a
        symmetric folded-normal init, the joint path's churn, Heun and
        self-conditioning.  ``denoiser_fn``: (adjs, node_flags, sigmas[B],
        self_cond) -> D_adj, the adj-only preconditioned model
        (``models.precond.precond_forward_adj``).  Returns adjs, or (adjs,
        interim_adjs) when ``num_interim`` > 0."""
        noise = noise if noise is not None else TorchNoise(seed, node_flags.device)
        if init_adjs is None:
            init_adjs = self.gen_init_sample_adj(noise, node_flags)
        dummy_nodes = init_adjs.new_zeros(node_flags.shape[:2])
        out = self.sample(self._adj_only_joint(denoiser_fn, node_flags), node_flags, 1, 1,
                          noise=noise, init_adjs=init_adjs, init_nodes=dummy_nodes,
                          num_interim=num_interim, chunk_steps=chunk_steps)
        if num_interim > 0:
            return out[0], out[2]
        return out[0]

    def gen_init_sample_adj(self, noise, node_flags, folded_norm: bool = True):
        """Symmetric (by default folded) normal init of the adj-only path,
        masked (edm_sampler.py:534-544; the reference's
        GeneralSampler.gen_init_sample): the draw ``init_adj`` at step -1."""
        b, n = node_flags.shape[:2]
        init = sym_from_normal(noise.normal(-1, "init_adj", (b, n, n)))
        if folded_norm:
            init = init.abs()
        return mask_adjs(init, node_flags)

    def _inpaint(self, node_flags, ip, adjs_v, nodes_v, sigma, draw_a, draw_x):
        """Replace the known entries with the ground truth re-noised at
        ``sigma`` (a 0-d tensor) from the step's draws (edm_sampler.py:360-384);
        ``ip`` = (gt_adjs, mask_adjs, gt_nodes, mask_nodes), None where unset.
        ``sigma`` None (the output, at sigma 0) takes the ground truth itself."""
        gt_a, mask_a, gt_x, mask_x = ip
        if mask_a is not None and gt_a is not None:
            m = mask_a.to(adjs_v.dtype)
            if m.ndim < adjs_v.ndim:
                m = m[..., None]
            known = gt_a if sigma is None else gt_a + sigma * self._sym(draw_a)
            adjs_v = mask_adjs(known, node_flags) * m + adjs_v * (1 - m)
        if mask_x is not None and gt_x is not None:
            m = mask_x.to(nodes_v.dtype)
            if m.ndim < nodes_v.ndim:
                m = m[..., None]
            known = gt_x if sigma is None else gt_x + sigma * draw_x
            nodes_v = mask_nodes(known, node_flags) * m + nodes_v * (1 - m)
        return adjs_v, nodes_v


def inpaint_tuple(inpaint: dict | None) -> tuple:
    """``sample``'s ``inpaint`` dict as (gt_adjs, mask_adjs, gt_nodes,
    mask_nodes), None where unset."""
    ip = inpaint or {}
    return (ip.get("gt_adjs"), ip.get("mask_adjs"), ip.get("gt_nodes"), ip.get("mask_nodes"))
