"""EDM preconditioning around the raw denoiser (inference path).

Counterpart of ``precond_forward`` in diffusesg_tpu/models/precond.py:

    D_adj  = c_skip * adjs  + c_out * F_adj(c_in * adjs, c_in * nodes, ...)
    D_node = c_skip * nodes + c_out * F_node(...)

The training variants wait for the training slice.
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
