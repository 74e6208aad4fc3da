"""EDM (Karras et al. 2022) noise-level schedules and preconditioning.

Counterpart of diffusesg_tpu/diffusion/edm.py: the VP/VE/EDM parameter
tuples, ``get_preconditioning_params`` and the training objective (sigma
draw, noising, targets and loss weights).

The objective's random draws come from a noise source with the sampler's
protocol (``sampling.edm_sampler.TorchNoise``: ``normal(step, kind, shape)``,
``uniform(step, kind, shape)``), keyed by the training step and the kinds
``sigma``, ``noise_adj`` and ``noise_node``, so a test can hand the port the
JAX key schedule's own draws.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.masking import mask_adjs, mask_nodes, sym_from_normal


class VPParams(NamedTuple):
    beta_d: float
    beta_min: float
    epsilon_t: float
    M: int
    epsilon_s: float
    sigma_min_training: float
    sigma_max_training: float
    sigma_min_sampling: float
    sigma_max_sampling: float


class VEParams(NamedTuple):
    sigma_min_training: float
    sigma_max_training: float
    sigma_min_sampling: float
    sigma_max_sampling: float


class EDMParams(NamedTuple):
    sigma_min_training: float
    sigma_max_training: float
    sigma_min_sampling: float
    sigma_max_sampling: float
    sigma_data: float
    P_mean: float
    P_std: float
    rho: float


def vp_sigma_from_t(t, beta_d=19.9, beta_min=0.1):
    t = torch.as_tensor(t, dtype=torch.float32)
    return torch.sqrt(torch.expm1(0.5 * beta_d * t ** 2 + beta_min * t))


def vp_t_from_sigma(sigma, beta_d=19.9, beta_min=0.1):
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    return (torch.sqrt(beta_min ** 2 + 2 * beta_d * torch.log1p(sigma ** 2)) - beta_min) / beta_d


def get_vp_params() -> VPParams:
    epsilon_t, epsilon_s = 1e-5, 1e-3
    return VPParams(
        beta_d=19.9, beta_min=0.1, epsilon_t=epsilon_t, M=1000, epsilon_s=epsilon_s,
        sigma_min_training=float(vp_sigma_from_t(epsilon_t)),
        sigma_max_training=float(vp_sigma_from_t(1.0)),
        sigma_min_sampling=float(vp_sigma_from_t(epsilon_s)),
        sigma_max_sampling=float(vp_sigma_from_t(1.0)))


def get_ve_params() -> VEParams:
    return VEParams(0.02, 100.0, 0.02, 100.0)


def get_edm_params() -> EDMParams:
    return EDMParams(sigma_min_training=0.0, sigma_max_training=float("inf"),
                     sigma_min_sampling=0.002, sigma_max_sampling=80.0,
                     sigma_data=0.5, P_mean=-1.2, P_std=1.2, rho=7.0)


def get_preconditioning_params(precond: str, sigmas: torch.Tensor,
                               vp_params: VPParams | None = None,
                               edm_params: EDMParams | None = None):
    """c_skip, c_out, c_in, c_noise as functions of sigma (reference
    formulas: edm.py:111-129); every output has the shape of ``sigmas``."""
    if precond == "vp":
        vp = vp_params or get_vp_params()
        c_skip = torch.ones_like(sigmas)
        c_out = -sigmas
        c_in = 1.0 / torch.sqrt(sigmas ** 2 + 1.0)
        c_noise = (vp.M - 1) * vp_t_from_sigma(sigmas).to(sigmas.device)
    elif precond == "ve":
        c_skip = torch.ones_like(sigmas)
        c_out = sigmas
        c_in = torch.ones_like(sigmas)
        c_noise = torch.log(0.5 * sigmas)
    elif precond == "edm":
        sd = (edm_params or get_edm_params()).sigma_data
        c_skip = sd ** 2 / (sigmas ** 2 + sd ** 2)
        c_out = sigmas * sd / torch.sqrt(sigmas ** 2 + sd ** 2)
        c_in = 1.0 / torch.sqrt(sd ** 2 + sigmas ** 2)
        c_noise = torch.log(sigmas) / 4.0
    else:
        raise NotImplementedError(f"unknown precond {precond}")
    return c_skip, c_out, c_in, c_noise


def sample_training_sigmas_weights(noise, step: int, num_samples: int, sigma_dist: str,
                                   vp_params: VPParams | None = None,
                                   ve_params: VEParams | None = None,
                                   edm_params: EDMParams | None = None):
    """Per-sample training noise levels and loss weights (reference:
    edm.py:160-179): edm draws sigma = exp(N(P_mean, P_std)) with weight
    (sigma^2 + sigma_d^2) / (sigma * sigma_d)^2."""
    if sigma_dist == "vp":
        vp = vp_params or get_vp_params()
        u = noise.uniform(step, "sigma", (num_samples,))
        sigmas = vp_sigma_from_t(1.0 + u * (vp.epsilon_t - 1.0))
        weights = 1.0 / sigmas ** 2
    elif sigma_dist == "ve":
        ve = ve_params or get_ve_params()
        u = noise.uniform(step, "sigma", (num_samples,))
        sigmas = ve.sigma_min_training * (ve.sigma_max_training / ve.sigma_min_training) ** u
        weights = 1.0 / sigmas ** 2
    elif sigma_dist == "edm":
        p = edm_params or get_edm_params()
        n = noise.normal(step, "sigma", (num_samples,))
        sigmas = torch.exp(n * p.P_std + p.P_mean)
        weights = (sigmas ** 2 + p.sigma_data ** 2) / (sigmas * p.sigma_data) ** 2
    else:
        raise NotImplementedError(f"unknown sigma_dist {sigma_dist}")
    return sigmas, weights


def _over(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A [B] vector shaped to broadcast over the trailing dims of ``like``."""
    return x.reshape((x.shape[0],) + (1,) * (like.ndim - 1)).to(like.dtype)


def add_normal_noise(draw, in_tensors, sigmas, node_flags, symmetric: bool):
    """in + sigma * draw per sample, adjacency-shaped; the draw mirrored
    over the diagonal when ``symmetric`` (reference: add_sym_normal_noise with
    unit scales).  Returns (noisy, noise), both masked."""
    noise = (sym_from_normal(draw) if symmetric else draw) * _over(sigmas, in_tensors)
    return mask_adjs(in_tensors + noise, node_flags), mask_adjs(noise, node_flags)


class ObjectiveBatch(NamedTuple):
    """Training-time network inputs/targets for the joint node+adj objective."""
    net_input_a: torch.Tensor   # noisy adjs            [B, N, N(, C)]
    net_input_x: torch.Tensor   # noisy nodes           [B, N(, C)]
    net_cond: torch.Tensor      # sigmas                [B]
    net_target_a: torch.Tensor  # clean adjs (x0 target)
    net_target_x: torch.Tensor  # clean nodes
    c_skip: torch.Tensor        # [B]
    c_out: torch.Tensor         # [B]
    c_in: torch.Tensor          # [B]
    c_noise: torch.Tensor       # [B]
    sigmas: torch.Tensor        # [B]
    weights: torch.Tensor       # [B]


@dataclasses.dataclass(frozen=True)
class NodeAdjEDMObjective:
    """Training objective generator for joint node+adj diffusion (reference:
    NodeAdjEDMObjectiveGenerator, edm.py:215-281).  The scene-graph configs
    use symmetric_noise=False."""
    precond: str = "edm"
    sigma_dist: str = "edm"
    symmetric_noise: bool = False

    def get_network_input(self, noise, step: int, clean_adjs, clean_x, node_flags, sigmas):
        """Noise both modalities with the per-sample sigma, masked."""
        draw_a = noise.normal(step, "noise_adj", clean_adjs.shape)
        noisy_adjs, noise_a = add_normal_noise(draw_a, clean_adjs, sigmas, node_flags,
                                               self.symmetric_noise)
        noise_x = noise.normal(step, "noise_node", clean_x.shape) * _over(sigmas, clean_x)
        if node_flags.ndim == 3:  # node-only mode: the node vector is a dummy
            noise_x = torch.zeros_like(noise_x)
        else:
            noise_x = mask_nodes(noise_x, node_flags)
        return noisy_adjs, noise_a, clean_x + noise_x, noise_x

    def get_input_output(self, noise, step: int, clean_adjs, clean_x,
                         node_flags) -> ObjectiveBatch:
        sigmas, weights = sample_training_sigmas_weights(noise, step, clean_adjs.shape[0],
                                                         self.sigma_dist)
        c_skip, c_out, c_in, c_noise = get_preconditioning_params(self.precond, sigmas)
        noisy_adjs, _, noisy_x, _ = self.get_network_input(noise, step, clean_adjs, clean_x,
                                                           node_flags, sigmas)
        return ObjectiveBatch(noisy_adjs, noisy_x, sigmas, clean_adjs, clean_x,
                              c_skip, c_out, c_in, c_noise, sigmas, weights)
