"""Performance utilities: FLOPs estimate, peak rate, device-memory probe.

The port's copy of diffusesg_tpu/utils/perf.py.  ``estimate_model_flops``
is the same analytic count (the reference's flops() methods,
DiffuseSG/model/diffusesg/diffusesg.py:144-155,283-295,340-344,408-412,
488-494,579-584); the peak table holds the card this port targets and the
memory probe reads ``torch.cuda.memory_stats``.  Spans and counters are
utils/tracing.py's.
"""
from __future__ import annotations


def estimate_model_flops(config) -> dict:
    """Analytic FLOPs for one denoiser forward (batch 1), per stage.

    Per Swin block L*(4*C^2 + mlp_ratio*2*C^2) + windowed attention
    2*nW*w^2*w^2*C; patch merge / breakup; patch embed / read-out."""
    from ..models.channels import get_node_adj_model_input_output_channels
    in_chans, out_adj, out_node = get_node_adj_model_input_output_channels(config)
    if config.train.self_cond:
        in_chans *= 2
    n = config.dataset.max_node_num
    p = config.model.patch_size
    dim0 = config.model.feature_dims[-1]
    depths = list(config.model.depths)
    window = config.model.window_size
    mlp_ratio = 4.0

    res = n // p
    total = 0
    per_stage = []
    # patch embed + read-out
    total += res * res * (p * p * in_chans) * dim0 * 2
    total += res * res * dim0 * dim0 * 2 * 3  # read_out: up-proj + two 1x1

    def _block_flops(L, c, w):
        attn_mm = L * (3 * c * c + c * c) * 2           # qkv + proj
        nw = L // (w * w)
        attn = nw * 2 * (w * w) * (w * w) * c * 2       # scores + probs@v
        mlp = L * 2 * c * int(mlp_ratio * c) * 2
        return attn_mm + attn + mlp

    num_layers = len(depths)
    for i in range(num_layers):
        c = dim0 * 2 ** i
        r = res // 2 ** i
        w = min(window, r)
        L = r * r
        stage = depths[i] * _block_flops(L, c, w) * 2   # down + mirrored up
        if i < num_layers - 1:
            stage += (r // 2) ** 2 * 4 * c * 2 * c * 2  # merge + breakup
        per_stage.append(stage)
        total += stage
    # readout MLPs over the N x N grid
    total += n * n * dim0 * (dim0 + out_adj) * 2
    total += n * dim0 * (dim0 + out_node) * 2
    return {"total": int(total), "per_stage": [int(s) for s in per_stage]}


_PEAK_BF16_TFLOPS = {
    # dense bf16 tensor-core peak, NVIDIA H100 SXM data sheet (700 W)
    "h100": 989.0,
}


def device_peak_tflops(device_kind: str, dtype: str = "bfloat16") -> float | None:
    """Peak TFLOP/s of one card for FLOP/s shares, or None when unknown.

    Only bf16 peaks are tabulated (the full configs compute in bf16); other
    dtypes return None rather than a wrong denominator."""
    if dtype not in ("bfloat16", "bf16"):
        return None
    kind = (device_kind or "").lower()
    for key, peak in _PEAK_BF16_TFLOPS.items():
        if key in kind:
            return peak
    return None


def device_memory_stats() -> dict:
    """Per-card memory use from ``torch.cuda.memory_stats`` (the reference's
    get_gpu_memory_status analogue); empty without a card."""
    import torch
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
