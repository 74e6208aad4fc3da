"""MMD kernels over histogram samples — vectorized, no process pools.

The port's copy of diffusesg_tpu/eval/mmd.py (numpy, no JAX), the
counterpart of the reference MMD layer (reference:
DiffuseSG/evaluation/mmd.py).  The reference computes kernel sums with
ProcessPoolExecutor over Python loops and uses pyemd (C++) for the
gaussian_emd kernel; here samples are zero-padded to a common support and
kernels evaluate as dense pairwise numpy matrix ops.  The 1-D EMD with
Toeplitz |i-j| ground distance has the exact closed form
sum |CDF(x) - CDF(y)| for equal-mass histograms (which compute_mmd
guarantees by normalizing), so no native EMD solver is needed.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


def pad_to_common(samples1: Sequence[np.ndarray], samples2: Sequence[np.ndarray]):
    """Stack two lists of 1-D histograms into [n, L] arrays, zero-padded to the
    common support length (reference pads pairwise, mmd.py:17-29 — equivalent
    for these kernels since extra zero bins change nothing)."""
    support = max([len(s) for s in samples1] + [len(s) for s in samples2])

    def _stack(samples):
        out = np.zeros((len(samples), support), dtype=np.float64)
        for i, s in enumerate(samples):
            out[i, :len(s)] = s
        return out

    return _stack(samples1), _stack(samples2)


def gaussian_kernel_matrix(x: np.ndarray, y: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    """exp(-||x - y||^2 / (2 sigma^2)) for all pairs: [n, L] x [m, L] -> [n, m]
    (reference scalar kernel: mmd.py:65-77)."""
    x2 = (x ** 2).sum(-1)[:, None]
    y2 = (y ** 2).sum(-1)[None, :]
    d2 = np.maximum(x2 + y2 - 2.0 * x @ y.T, 0.0)
    return np.exp(-d2 / (2 * sigma * sigma))


def gaussian_tv_kernel_matrix(x: np.ndarray, y: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    """exp(-TV(x, y)^2 / (2 sigma^2)), TV = |x - y|_1 / 2 (mmd.py:80-93)."""
    d = np.abs(x[:, None, :] - y[None, :, :]).sum(-1) / 2.0
    return np.exp(-d * d / (2 * sigma * sigma))


def gaussian_emd_kernel_matrix(x: np.ndarray, y: np.ndarray, sigma: float = 1.0,
                               distance_scaling: float = 1.0) -> np.ndarray:
    """exp(-EMD(x, y)^2 / (2 sigma^2)) with |i-j| ground distance (mmd.py:32-62).

    Closed form via CDF difference — exact for equal-mass histograms (pyemd
    with a Toeplitz ground matrix reduces to this in 1-D).
    """
    cx = np.cumsum(x, axis=-1)
    cy = np.cumsum(y, axis=-1)
    d = np.abs(cx[:, None, :] - cy[None, :, :]).sum(-1) / distance_scaling
    return np.exp(-d * d / (2 * sigma * sigma))


KERNEL_NAME_TO_FUNC: dict[str, Callable] = {
    "gaussian": gaussian_kernel_matrix,
    "gaussian_tv": gaussian_tv_kernel_matrix,
    "gaussian_emd": gaussian_emd_kernel_matrix,
}


def retrieve_kernels(kernel_ls) -> list[Callable]:
    """Name(s) -> kernel matrix function(s) (reference: bbox_metrics.py:129-137)."""
    names = kernel_ls if isinstance(kernel_ls, list) else [kernel_ls]
    out = []
    for item in names:
        if callable(item):
            out.append(item)
        else:
            out.append(KERNEL_NAME_TO_FUNC[item])
    return out


def compute_mmd(samples1: Sequence[np.ndarray], samples2: Sequence[np.ndarray],
                kernel="gaussian", is_hist: bool = True, sigma: float = 1.0) -> float:
    """Biased MMD^2 between two sets of histograms (reference: mmd.py:138-161,
    including the diagonal terms in the self-discrepancies)."""
    kfn = retrieve_kernels(kernel)[0]
    if is_hist:
        samples1 = [s / s.sum() if s.sum() != 0 else s for s in map(np.asarray, samples1)]
        samples2 = [s / s.sum() if s.sum() != 0 else s for s in map(np.asarray, samples2)]
    x, y = pad_to_common(samples1, samples2)
    k_xx = kfn(x, x, sigma)
    k_yy = kfn(y, y, sigma)
    k_xy = kfn(x, y, sigma)
    return float(k_xx.mean() + k_yy.mean() - 2.0 * k_xy.mean())


# scalar-kernel aliases matching the reference call signatures (used by tests)
def gaussian(x, y, sigma=1.0):
    x, y = pad_to_common([np.asarray(x)], [np.asarray(y)])
    return float(gaussian_kernel_matrix(x, y, sigma)[0, 0])


def gaussian_tv(x, y, sigma=1.0):
    x, y = pad_to_common([np.asarray(x)], [np.asarray(y)])
    return float(gaussian_tv_kernel_matrix(x, y, sigma)[0, 0])


def gaussian_emd(x, y, sigma=1.0, distance_scaling=1.0):
    x, y = pad_to_common([np.asarray(x)], [np.asarray(y)])
    return float(gaussian_emd_kernel_matrix(x, y, sigma, distance_scaling)[0, 0])
