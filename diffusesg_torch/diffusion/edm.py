"""EDM (Karras et al. 2022) noise-level schedules and preconditioning.

Counterpart of the sampling half of diffusesg_tpu/diffusion/edm.py: the
VP/VE/EDM parameter tuples and ``get_preconditioning_params``.  The
training objective waits for the training slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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
