"""Multi-process runtime setup for the proving group (PyTorch port of
keyless_zk_tpu/parallel/distributed.py, on torch.distributed).

One process per card: each joins one process group, NCCL between cards
and gloo on the CPU, and the sharded kernels (parallel/sharded.py) run
their collectives over it.

Usage (one process per card):

    from keyless_zk_tpu_torch.parallel import distributed
    distributed.initialize("tcp://10.0.0.1:29500", world_size=4, rank=r)
    mesh = distributed.global_mesh()

The address, world size and rank are given explicitly, or through the
environment (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK, as torchrun
sets them). Nothing is discovered: where no address is configured,
initialize() is a no-op that returns False, so every code path works
unchanged in one process.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .. import device as devices


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    device=devices.DEFAULT,
) -> bool:
    """Join the process group. Returns True if distributed mode is active,
    False for the single-process fallback (no address configured). The
    backend follows `device`: NCCL for a CUDA device (bound to this
    process's card), gloo for the CPU."""
    if dist.is_initialized():
        return True
    if init_method is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        init_method = "env://"
    if init_method is None:
        return False  # single-process mode
    world_size = world_size if world_size is not None else int(os.environ["WORLD_SIZE"])
    rank = rank if rank is not None else int(os.environ["RANK"])
    dev = devices.resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init_method, world_size=world_size, rank=rank, device_id=dev)
    else:
        dist.init_process_group("gloo", init_method=init_method, world_size=world_size, rank=rank)
    return True


def global_mesh():
    """The mesh over every process of the group (parallel/sharded.py
    `make_mesh`)."""
    from .sharded import make_mesh

    return make_mesh()


def local_batch_slice(global_batch: int) -> tuple[int, int]:
    """[start, end) of this process's slice of a globally sharded batch."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    per = -(-global_batch // n)
    return min(i * per, global_batch), min((i + 1) * per, global_batch)
