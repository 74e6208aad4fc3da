"""Masking and symmetric-noise primitives for padded graph tensors.

Counterpart of diffusesg_tpu/ops/masking.py, channels-last like it:
  adjs [B, N, N] or [B, N, N, C];  nodes [B, N] or [B, N, C];
  node_flags [B, N] (any dtype, nonzero = valid) or [B, N, N].
Invalid entries are replaced with ``torch.where`` (not multiplied), so NaN
or Inf in padded slots cannot leak into reductions.
"""
from __future__ import annotations

import torch


def mask_adjs(adjs: torch.Tensor, node_flags: torch.Tensor, value: float = 0.0,
              col_only: bool = False) -> torch.Tensor:
    """Mask adjacency-shaped tensors by node validity (rows and columns, or
    columns only; element-wise for [B, N, N] flags)."""
    flags = node_flags.bool()
    if flags.ndim == 2:
        mask = flags[:, None, :] if col_only else flags[:, :, None] & flags[:, None, :]
    elif flags.ndim == 3:
        if col_only:
            raise ValueError("col_only unsupported with element-wise [B,N,N] flags")
        mask = flags
    else:
        raise ValueError(f"bad node_flags shape {tuple(node_flags.shape)}")
    if adjs.ndim == mask.ndim + 1:
        mask = mask[..., None]
    elif adjs.ndim != mask.ndim:
        raise ValueError(f"adjs shape {tuple(adjs.shape)} incompatible with flags "
                         f"{tuple(node_flags.shape)}")
    return torch.where(mask, adjs, torch.full((), value, dtype=adjs.dtype, device=adjs.device))


def mask_nodes(nodes: torch.Tensor, node_flags: torch.Tensor,
               value: float = 0.0) -> torch.Tensor:
    """Mask node-shaped tensors by node validity; a no-op for [B, N, N]
    flags (node-only mode), as in the reference."""
    flags = node_flags.bool()
    if flags.ndim == 3:
        return nodes
    if flags.ndim != 2:
        raise ValueError(f"bad node_flags shape {tuple(node_flags.shape)}")
    if nodes.ndim == 2:
        mask = flags
    elif nodes.ndim == 3:
        mask = flags[:, :, None]
    else:
        raise ValueError(f"nodes must be [B,N] or [B,N,C], got {tuple(nodes.shape)}")
    return torch.where(mask, nodes, torch.full((), value, dtype=nodes.dtype, device=nodes.device))


def symmetrize(adjs: torch.Tensor) -> torch.Tensor:
    """0.5 * (A + A^T) over the two node axes."""
    if adjs.ndim == 3:
        return 0.5 * (adjs + adjs.transpose(-1, -2))
    if adjs.ndim == 4:
        return 0.5 * (adjs + adjs.transpose(1, 2))
    raise ValueError(f"bad adjs shape {tuple(adjs.shape)}")


def sym_from_normal(noise: torch.Tensor) -> torch.Tensor:
    """Symmetric noise with zero diagonal from a standard-normal draw: keep
    the strict upper triangle over the node axes and mirror it."""
    if noise.ndim == 4:
        n = noise.shape[1]
        tri = torch.triu(torch.ones(n, n, dtype=torch.bool, device=noise.device), 1)
        upper = noise * tri[None, :, :, None]
        return upper + upper.transpose(1, 2)
    n = noise.shape[-1]
    tri = torch.triu(torch.ones(n, n, dtype=torch.bool, device=noise.device), 1)
    upper = noise * tri
    return upper + upper.transpose(-1, -2)


def get_sym_normal_noise(shape, generator: torch.Generator | None = None,
                         dtype=torch.float32, device=None) -> torch.Tensor:
    """Symmetric Gaussian noise with zero diagonal (reference
    graph_utils.py:113-119): N(0, 1) above the diagonal, mirrored below."""
    return sym_from_normal(torch.randn(shape, generator=generator, dtype=dtype, device=device))
