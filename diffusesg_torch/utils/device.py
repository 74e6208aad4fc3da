"""Device policy of the port's entry points: the card unless asked otherwise."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The entry points run on ``cuda`` by default: card 0, or the process's
    own card ``cuda:LOCAL_RANK`` when a rendezvous is configured
    (parallel/distributed.py).  Without a card they raise instead of
    carrying on elsewhere; pass ``device="cpu"`` to run the plain versions on
    the CPU (the tests do)."""
    from ..parallel.distributed import detect_rendezvous, local_rank
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and detect_rendezvous() is not None:
        dev = torch.device("cuda", local_rank())
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("diffusesg_torch runs on a CUDA device and none is available; "
                           "pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
