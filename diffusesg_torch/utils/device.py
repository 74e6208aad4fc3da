"""Device policy of the port's entry points: the card unless asked otherwise."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The entry points run on ``cuda`` by default.  Without a card they
    raise instead of carrying on elsewhere; pass ``device="cpu"`` to run the
    plain versions on the CPU (the tests do)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("diffusesg_torch runs on a CUDA device and none is available; "
                           "pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
