"""Multi-process launch helpers.

The counterpart of :mod:`plasma_control_tpu.parallel.launch` on
``torch.distributed``. Each process calls :func:`initialize_distributed`
once, before it builds a mesh (:mod:`.mesh`):

* with explicit arguments, it joins a ``tcp://`` rendezvous at
  ``coordinator_address`` (``host:port``) as rank ``process_id`` of
  ``num_processes``;
* launched by ``torchrun``, which sets ``MASTER_ADDR``, ``MASTER_PORT``,
  ``RANK`` and ``WORLD_SIZE``, it joins through ``env://`` (torch reads those
  variables itself: the counterpart of the JAX package's pod
  auto-bootstrap);
* otherwise it stays single-process and returns ``False``.

The backend follows ``device_type``: NCCL for ``"cuda"`` (the default, as
for :func:`.mesh.make_mesh`), each process on the card of its local rank
(``LOCAL_RANK``, else the rank modulo the cards of the host), and gloo for
``"cpu"``, which the caller asks for by name; any other value is refused.
There is no fallback: with ``"cuda"`` and no card it raises before any
process group is made. NCCL takes one card per rank; several ranks on one
card need a gloo group, which the caller makes with
``torch.distributed.init_process_group("gloo", ...)`` before building a mesh.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize_distributed", "is_multihost", "process_summary"]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device_type: str = "cuda",
) -> bool:
    """Join the process group if one is configured; True if more than one
    process takes part. A no-op returning the same answer once a group
    exists."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"initialize_distributed: device_type {device_type!r} is neither "
                         "'cuda' nor 'cpu'")
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and not {"MASTER_ADDR", "RANK", "WORLD_SIZE"} <= set(os.environ):
        return False
    cuda = device_type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("initialize_distributed: device_type='cuda' needs a CUDA card and "
                           "none is available; pass device_type='cpu' for a gloo group on "
                           "the CPU")
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("initialize_distributed: pass coordinator_address, num_processes "
                             "and process_id together")
        init, rank, world = f"tcp://{coordinator_address}", process_id, num_processes
    else:
        init, rank, world = "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if cuda:
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init, rank=rank,
                            world_size=world)
    return dist.get_world_size() > 1


def is_multihost() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_summary() -> str:
    """``"process r/R, 1 local / R global devices"``: each process drives
    one device."""
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    return f"process {rank}/{world}, 1 local / {world} global devices"
