"""EDM preconditioning around the raw denoiser.

Counterpart of diffusesg_tpu/models/precond.py:

    D_adj  = c_skip * adjs  + c_out * F_adj(c_in * adjs, c_in * nodes, ...)
    D_node = c_skip * nodes + c_out * F_node(...)

with training-time stochastic self-conditioning: with probability 0.5 a
forward pass under ``torch.no_grad()`` produces (D_adj, D_node) that are fed
back as self-conditioning inputs.  The Bernoulli draw is a host decision
(``noise.bernoulli``), so it costs no device synchronisation, and the
conditioning pass leaves no graph behind.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..diffusion.edm import get_preconditioning_params
from ..ops.masking import mask_adjs, mask_nodes

# DenoiserFn: (adj, node, node_flags, c_noise, self_cond_a, self_cond_x) -> (F_adj, F_node)
DenoiserFn = Callable[..., tuple[torch.Tensor, torch.Tensor]]


def _bshape(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a [B] coefficient over the trailing dims of ``like``."""
    return x.reshape((x.shape[0],) + (1,) * (like.ndim - 1)).to(like.dtype)


def precond_forward(denoiser_fn: DenoiserFn, precond: str, adjs, nodes, node_flags, sigmas,
                    self_cond_adjs=None, self_cond_nodes=None):
    """One preconditioned denoiser evaluation, in fp32 around the network."""
    c_skip, c_out, c_in, c_noise = get_preconditioning_params(precond, sigmas)
    F_a, F_x = denoiser_fn(_bshape(c_in, adjs) * adjs, _bshape(c_in, nodes) * nodes,
                           node_flags, c_noise, self_cond_adjs, self_cond_nodes)
    D_a = _bshape(c_skip, adjs) * adjs + _bshape(c_out, adjs) * F_a.float()
    D_x = _bshape(c_skip, nodes) * nodes + _bshape(c_out, nodes) * F_x.float()
    return mask_adjs(D_a, node_flags), mask_nodes(D_x, node_flags)


def precond_forward_train(denoiser_fn: DenoiserFn, precond: str, self_condition: bool, noise,
                          step: int, adjs, nodes, node_flags, sigmas):
    """Training forward with p=0.5 stochastic self-conditioning (reference:
    precond.py:90-105).  Without the conditioning pass the model is handed
    explicit zeros, as the JAX branch does."""
    if not self_condition:
        return precond_forward(denoiser_fn, precond, adjs, nodes, node_flags, sigmas)
    if noise.bernoulli(step, "self_cond", 0.5):
        with torch.no_grad():
            sc_a, sc_x = precond_forward(denoiser_fn, precond, adjs, nodes, node_flags, sigmas)
    else:
        sc_a, sc_x = torch.zeros_like(adjs), torch.zeros_like(nodes)
    return precond_forward(denoiser_fn, precond, adjs, nodes, node_flags, sigmas, sc_a, sc_x)


# adj-only preconditioning (the reference's Precond): the pure-graph path
# with no node modality; no shipped config takes it.
# AdjDenoiserFn: (adj, node_flags, c_noise, self_cond) -> F_adj

def precond_forward_adj(denoiser_fn, precond: str, adjs, node_flags, sigmas, self_cond=None):
    """One adj-only preconditioned evaluation."""
    c_skip, c_out, c_in, c_noise = get_preconditioning_params(precond, sigmas)
    F_a = denoiser_fn(_bshape(c_in, adjs) * adjs, node_flags, c_noise, self_cond)
    D_a = _bshape(c_skip, adjs) * adjs + _bshape(c_out, adjs) * F_a.float()
    return mask_adjs(D_a, node_flags)


def precond_forward_train_adj(denoiser_fn, precond: str, self_condition: bool, noise,
                              step: int, adjs, node_flags, sigmas):
    """Adj-only training forward with p=0.5 stochastic self-conditioning."""
    if not self_condition:
        return precond_forward_adj(denoiser_fn, precond, adjs, node_flags, sigmas)
    if noise.bernoulli(step, "self_cond", 0.5):
        with torch.no_grad():
            sc = precond_forward_adj(denoiser_fn, precond, adjs, node_flags, sigmas)
    else:
        sc = torch.zeros_like(adjs)
    return precond_forward_adj(denoiser_fn, precond, adjs, node_flags, sigmas, sc)
