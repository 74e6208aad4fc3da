"""Plain reference of DiffuseSG's sampling: the EDM stochastic Heun sampler
with self-conditioning, and the decode to integer scene graphs.

EDM's Algorithm 2 (Karras et al. 2022, arXiv:2206.00364) as DiffuseSG runs it
(ubc-vision/DiffuseSG, runner/sampler/edm.py): the "edm" noise grid with
rho 7 between sigma 0.002 and 80, churn gamma = min(S_churn / steps,
sqrt(2) - 1) where S_min <= sigma <= S_max, S_noise 1.003; the Heun
correction re-evaluates at (x_hat, t_hat) with the first evaluation's
output as its self-conditioning input (the reference's quirk), so a graph
costs 2 * steps - 1 evaluations.  The draws come from the caller's
``draw(step, kind, shape)`` (step -1 the initial sample), the same that the
program is handed.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .model import Shape, denoise, mask_adjs, mask_nodes


@dataclasses.dataclass(frozen=True)
class Heun:
    steps: int = 256
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    rho: float = 7.0
    s_churn: float = 40.0
    s_min: float = 0.05
    s_max: float = 50.0
    s_noise: float = 1.003

    def sigmas(self) -> np.ndarray:
        """t_0 > ... > t_{S-1}, then 0 (float64)."""
        i = np.arange(self.steps, dtype=np.float64)
        lo, hi = self.sigma_min ** (1 / self.rho), self.sigma_max ** (1 / self.rho)
        t = (hi + i / (self.steps - 1) * (lo - hi)) ** self.rho
        return np.concatenate([t, np.zeros(1)])

    def rows(self):
        """Per step (gamma-scaled noise coefficient, t_hat, t_next, heun),
        computed in float64 and held as float32."""
        t = self.sigmas()
        out = []
        for i in range(self.steps):
            cur, nxt = float(t[i]), float(t[i + 1])
            gamma = (min(self.s_churn / self.steps, math.sqrt(2) - 1)
                     if self.s_min <= cur <= self.s_max else 0.0)
            hat = cur + gamma * cur
            coef = math.sqrt(max(hat ** 2 - cur ** 2, 0.0)) * self.s_noise
            out.append((np.float32(coef), np.float32(hat), np.float32(nxt - hat),
                        i < self.steps - 1))
        return out

    def evals(self) -> int:
        return 2 * self.steps - 1


@torch.no_grad()
def sample(P, shape: Shape, heun: Heun, flags, draw, quant=None):
    """Reverse diffusion of the batch ``flags`` [B, N] -> (adjs [B, N, N],
    nodes [B, N, 5]) in float32."""
    b, n = flags.shape
    dev = flags.device
    scale0 = float(heun.sigmas()[0])
    a = mask_adjs(draw(-1, "init_adj", (b, n, n, 1))[..., 0], flags) * scale0
    x = mask_nodes(draw(-1, "init_node", (b, n, shape.node_chans)), flags) * scale0
    sc_a, sc_x = torch.zeros_like(a), torch.zeros_like(x)
    for i, (coef, hat, h, is_heun) in enumerate(heun.rows()):
        coef_t, hat_t, h_t = (torch.tensor(v, dtype=torch.float32, device=dev)
                              for v in (coef, hat, h))
        if coef != 0.0:
            a = a + coef_t * draw(i, "churn_adj", (b, n, n))
            x = x + coef_t * draw(i, "churn_node", (b, n, shape.node_chans))
        a, x = mask_adjs(a, flags), mask_nodes(x, flags)
        sig = hat_t.expand(b)
        den_a, den_x = denoise(P, shape, a, x, flags, sig, sc_a, sc_x, quant)
        d_a = mask_adjs((a - den_a) / hat_t, flags)
        d_x = mask_nodes((x - den_x) / hat_t, flags)
        if is_heun:
            # the second evaluation at (x_hat, t_hat), fed the first's output
            den_a2, den_x2 = denoise(P, shape, a, x, flags, sig, den_a, den_x, quant)
            a_pr, x_pr = a + h_t * d_a, x + h_t * d_x
            t_pr = hat_t + h_t
            d_a2 = (a_pr - den_a2) / t_pr
            d_x2 = (x_pr - den_x2) / t_pr
            a = a + h_t * (0.5 * d_a + 0.5 * d_a2)
            x = x + h_t * (0.5 * d_x + 0.5 * d_x2)
            den_a, den_x = den_a2, den_x2
        else:
            a, x = a + h_t * d_a, x + h_t * d_x
        a, x = mask_adjs(a, flags), mask_nodes(x, flags)
        sc_a, sc_x = den_a, den_x
    return a, x


def _ddpm_to_int(v, types: int):
    """Nearest of the ``types`` levels of [-1, 1]; a boundary to the lower."""
    delta = 2.0 / (types - 1.0)
    return torch.clamp(torch.ceil((v + 1.0) / delta - 0.5), 0, types - 1)


def decode(shape: Shape, adjs, nodes, flags):
    """(adj types int32 [B, N, N], node types int32 [B, N], boxes [B, N, 4]
    cxcywh in [0, 1]); padded slots zero, no self-loops."""
    a = torch.clamp(adjs, -1.0, 1.0)
    adj_t = mask_adjs(_ddpm_to_int(a, shape.edge_types), flags)
    adj_t = adj_t * (1.0 - torch.eye(a.shape[-1], device=a.device))
    node_t = mask_nodes(_ddpm_to_int(torch.clamp(nodes[..., 0], -1.0, 1.0), shape.node_types),
                        flags)
    boxes = mask_nodes(nodes[..., 1:] * 0.5 + 0.5, flags)
    return adj_t.to(torch.int32), node_t.to(torch.int32), boxes
