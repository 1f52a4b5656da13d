"""Joining a process group: one process drives one device.

The counterpart of ``prior_diffuse_tpu/parallel/distributed.py`` for
``torch.distributed``.  ``python -m torch.distributed.run
--nproc_per_node=N ...`` starts one process per device and gives each
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``; :func:`initialize` joins that group.  Without that
environment (and without an explicit rank and world size) it returns False
and contacts nothing, as the JAX package's does on one host.  A failed
``init_process_group`` raises: there is no quiet single-process run in its
place.

Usage (the same script in every process)::

    from prior_diffuse_tpu_torch.parallel import distributed, mesh
    distributed.initialize()                 # env-driven, no-op alone
    dp = mesh.DataParallel(distributed.local_device("cuda"))
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def initialize(backend: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None, init_method: Optional[str] = None,
               device="cuda") -> bool:
    """Join the process group; True if this process is now one of a group.

    ``rank`` and ``world_size`` default to ``RANK`` and ``WORLD_SIZE`` and
    ``init_method`` to ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``); with
    neither the arguments nor the environment it returns False.  The
    backend defaults to ``nccl`` for a CUDA ``device`` and ``gloo`` for
    the CPU; a caller may name it (two ranks sharing one card take gloo:
    NCCL refuses two ranks on one device)."""
    if dist.is_initialized():
        return True
    if rank is None and world_size is None and not {"RANK", "WORLD_SIZE"} <= set(os.environ):
        return False
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return True


def local_device(device="cuda") -> torch.device:
    """The device of this process: ``cuda:LOCAL_RANK`` (made current) for a
    CUDA ``device`` under ``torch.distributed.run``, else ``device``.  A
    local rank without a card of its own raises: ranks never share a card
    unasked."""
    device = torch.device(device)
    if device.type != "cuda" or "LOCAL_RANK" not in os.environ:
        return device
    local = int(os.environ["LOCAL_RANK"])
    count = torch.cuda.device_count()
    if local >= count:
        raise RuntimeError(f"LOCAL_RANK {local} has no card of its own: this host has "
                           f"{count} CUDA device(s); start at most {count} processes a host")
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def data_shard() -> Tuple[int, int]:
    """``(rank, world size)`` of this process; ``(0, 1)`` outside a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_main() -> bool:
    """Whether this process writes logs, metrics, checkpoints and wavs:
    rank 0 of the group, or a process outside one."""
    return data_shard()[0] == 0
