"""Multi-process bootstrap on ``torch.distributed``.

Counterpart of diffusesg_tpu/parallel/distributed.py (the reference's
``utils/dist_training.py:100-126``): one process per card, PyTorch's idiom
and the reference's.  The rendezvous comes from the same environment
variables, read in the same order: this package's ``DSG_*``, then torchrun's
``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``, then Open MPI's
``OMPI_COMM_WORLD_*``.  On the card the process group uses NCCL, on the CPU
gloo.  With none of the variables set no process group starts and every
entry point runs on one device as before.

The JAX package's ``FencedJit`` has no counterpart: XLA builds a
communicator for each compiled program when the program first runs, while
``init_process_group`` builds it once, here.  What the fence guarded against
(one process reaching a collective minutes after its peers) has one cause
left in the port, the kernels' nvcc build at first use; ``load_kernels``
lets local rank 0 build while the others wait at a barrier.
"""
from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

# how long a rendezvous or a collective may wait for a peer
DEFAULT_TIMEOUT_S = 1800.0


def detect_rendezvous() -> dict | None:
    """Rendezvous parameters from the environment, or None when none is set
    (diffusesg_tpu/parallel/distributed.py:22-50, the same variables in the
    same order, the same keys)."""
    env = os.environ
    if "DSG_COORDINATOR" in env:
        return {
            "coordinator_address": env["DSG_COORDINATOR"],
            "num_processes": int(env["DSG_NUM_PROCESSES"]),
            "process_id": int(env["DSG_PROCESS_ID"]),
        }
    if "MASTER_ADDR" in env and "RANK" in env and "WORLD_SIZE" in env:
        return {
            "coordinator_address": f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '12355')}",
            "num_processes": int(env["WORLD_SIZE"]),
            "process_id": int(env["RANK"]),
        }
    if "OMPI_COMM_WORLD_RANK" in env and "MASTER_ADDR" in env:
        return {
            "coordinator_address": f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '12355')}",
            "num_processes": int(env["OMPI_COMM_WORLD_SIZE"]),
            "process_id": int(env["OMPI_COMM_WORLD_RANK"]),
        }
    return None


def local_rank() -> int:
    """This process's card on its host: ``LOCAL_RANK`` (torchrun's; set it
    with the ``DSG_*`` rendezvous too) or ``OMPI_COMM_WORLD_LOCAL_RANK``; 0
    when neither is set."""
    for var in ("LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK"):
        if var in os.environ:
            return int(os.environ[var])
    return 0


def maybe_initialize_distributed(device: str | torch.device = "cuda") -> bool:
    """Start the process group once per process when a rendezvous is
    configured; returns True when a process group is up after the call.

    NCCL when ``device`` is the card (``torch.cuda.set_device(LOCAL_RANK)``
    first), gloo when it is the CPU.  A configured rendezvous that fails
    raises, as does one that asks for the card where there is none: a
    process that carried on alone would take itself for rank 0 and write the
    same checkpoints and logs as the real one.  ``DSG_DIST_TIMEOUT``
    (seconds, default 30 minutes) bounds the wait for peers.
    """
    if dist.is_initialized():
        return True
    rdv = detect_rendezvous()
    if rdv is None:
        return False
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"a rendezvous is configured ({rdv}) for the card, and no CUDA "
                               "device is available; pass --device cpu for gloo on the CPU")
        backend = "nccl"
        torch.cuda.set_device(local_rank())
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {dev}")
    timeout_s = float(os.environ.get("DSG_DIST_TIMEOUT", DEFAULT_TIMEOUT_S))
    try:
        dist.init_process_group(backend, init_method=f"tcp://{rdv['coordinator_address']}",
                                world_size=rdv["num_processes"], rank=rdv["process_id"],
                                timeout=datetime.timedelta(seconds=timeout_s))
        barrier()  # the collective warm-up of the JAX package, as one barrier
    except Exception as e:
        if dist.is_initialized():
            dist.destroy_process_group()
        raise RuntimeError(f"a rendezvous was configured ({rdv}) and the {backend} process "
                           f"group did not start: {e}") from e
    logging.info("torch.distributed (%s): rank %d of %d, local rank %d", backend,
                 dist.get_rank(), dist.get_world_size(), local_rank())
    return True


def barrier() -> None:
    """A barrier across the process group (on the card, on this process's
    card); nothing without one."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def load_kernels() -> None:
    """Load the kernel library, local rank 0 building it first while its
    peers wait at a barrier: a build at first use inside a step would hold
    one rank in nvcc while the others wait in the step's collective."""
    from ..ops import cuda_build
    if dist.is_initialized() and local_rank() == 0:
        cuda_build.build()
    barrier()
    cuda_build.lib()


def shutdown() -> None:
    """Destroy the process group if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
