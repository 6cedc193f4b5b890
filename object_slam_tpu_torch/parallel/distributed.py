"""Process-group wiring: one call from a single process to many.

Counterpart of object_slam_tpu/parallel/distributed.py. Call
``maybe_initialize_distributed()`` once at process start in each rank
(``torchrun`` starts one per card); the observation-sharded BA
(parallel/sharded_ba.py) then reduces over ``global_group()``. With
nothing configured the call does nothing and returns False, so the same
driver runs on one process.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from object_slam_tpu_torch.device import resolve_device


def maybe_initialize_distributed(coordinator: str | None = None,
                                 num_processes: int | None = None,
                                 process_id: int | None = None,
                                 device=None, backend: str | None = None,
                                 timeout_s: float = 600.0) -> bool:
    """Initialize torch.distributed when a multi-process launch is
    configured; return True iff a process group is active.

    Precedence: explicit arguments, then torchrun's MASTER_ADDR /
    MASTER_PORT / WORLD_SIZE / RANK. coordinator is ``host:port`` or an
    init-method URL (``tcp://host:port``, ``file:///path``). The backend
    is NCCL on the card (each rank on card LOCAL_RANK, else its rank
    modulo the card count) and gloo with ``device="cpu"``; ``backend``
    overrides it (gloo for several ranks on one card, which NCCL
    refuses). Collectives that wait longer than timeout_s raise."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator = "env://"
    if coordinator is None:
        return False
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", process_id))
        kw["device_id"] = torch.device(
            "cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(kw["device_id"])
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    return True


def global_group():
    """The group over every rank (the counterpart of the reference's 1-D
    ``global_mesh``), None when no process group is active."""
    return dist.group.WORLD if dist.is_initialized() else None
