"""The multi-process rendezvous: the JAX package's `parallel/distributed.py`
on `torch.distributed`.

Env contract (the one `tools/launch.py` sets, and the reference's
`init_process_group(backend='nccl', init_method='env://')`):
- `WORLD_SIZE`, `RANK` and `LOCAL_RANK` (default: `RANK`);
- `COORDINATOR_ADDRESS` as `host:port` (the JAX contract), which becomes
  `MASTER_ADDR` / `MASTER_PORT`; an explicit `MASTER_ADDR` / `MASTER_PORT`
  pair is taken as it is;
- `DIST_INIT_TIMEOUT_S` bounds the rendezvous and every collective (300 s).

The backend is NCCL on `cuda:{LOCAL_RANK}`, or gloo on the CPU under
`--platform cpu`. Nothing falls back: a failed NCCL rendezvous raises, and
a card that is missing raises. At world size 1 no group starts unless the
caller asks for one (`need_group`: a parallel flag was given).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return rank() == 0


def _env_rendezvous() -> None:
    coord = os.environ.get("COORDINATOR_ADDRESS")
    if coord and "MASTER_ADDR" not in os.environ:
        host, _, port = coord.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"COORDINATOR_ADDRESS {coord!r} is not host:port")
        os.environ["MASTER_ADDR"] = host
        os.environ["MASTER_PORT"] = port


def initialize(platform: Optional[str] = None, need_group: bool = False
               ) -> dict:
    """Join the process group the environment describes. Returns
    {"rank", "world_size", "local_rank", "device", "backend"}; `device` is
    the rank's own device (`cuda:{LOCAL_RANK}`, or the CPU under `platform`
    'cpu'). Idempotent: a second call reports the group that exists."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    rnk = int(os.environ.get("RANK", 0))
    local = int(os.environ.get("LOCAL_RANK", rnk))
    from ..models.layers import resolve_device
    cpu = platform == "cpu"
    device = resolve_device("cpu" if cpu else f"cuda:{local}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = "gloo" if cpu else "nccl"
    if not dist.is_initialized() and (world > 1 or need_group):
        _env_rendezvous()
        if world == 1:
            os.environ.setdefault("MASTER_ADDR", "localhost")
            if "MASTER_PORT" not in os.environ:
                import socket
                with socket.socket() as s:
                    s.bind(("localhost", 0))
                    os.environ["MASTER_PORT"] = str(s.getsockname()[1])
        timeout = datetime.timedelta(
            seconds=float(os.environ.get("DIST_INIT_TIMEOUT_S", 300)))
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method="env://",
                                world_size=world, rank=rnk, timeout=timeout,
                                **kw)
    if dist.is_initialized():
        backend = dist.get_backend()
    return {"rank": rank(), "world_size": world_size(), "local_rank": local,
            "device": device, "backend": backend}


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def init_runtime(args, logger=None, need_group: Optional[bool] = None
                 ) -> dict:
    """The drivers' first call (the JAX `tasks/common.py` `init_runtime`):
    the rendezvous, then rank 0 logs and the other ranks log warnings only
    (the reference demotes non-rank-0 loggers the same way). `need_group`
    defaults to whether a parallel flag asks for one."""
    if need_group is None:
        need_group = (max(1, getattr(args, "model_parallel", 1) or 1) > 1
                      or max(1, getattr(args, "pipeline_parallel", 1) or 1) > 1
                      or bool(getattr(args, "fsdp", False))
                      or bool(getattr(args, "sequence_parallel", False)))
    info = initialize(getattr(args, "platform", None), need_group=need_group)
    if info["world_size"] > 1 and info["rank"] != 0:
        logging.disable(logging.INFO)
    if logger is not None and info["world_size"] > 1:
        logger.info(f"multi-process runtime: rank {info['rank']}/"
                    f"{info['world_size']} on {info['device']} "
                    f"({info['backend']})")
    return info


__all__ = ["initialize", "init_runtime", "is_main_process", "world_size",
           "rank", "barrier", "shutdown"]
