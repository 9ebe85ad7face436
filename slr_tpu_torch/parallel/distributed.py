"""Process-group set-up under torchrun (counterpart of
slr_tpu/parallel/distributed.py).

torchrun starts one process per rank and gives each `RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`. `init_distributed` reads
them, binds the rank's device and joins the process group; without
`WORLD_SIZE` it does nothing, and the process renders alone:

    torchrun --nproc_per_node N -m slr_tpu_torch scene.txt

NCCL runs one rank per GPU. Two ranks on one card need `backend="gloo"`,
which the caller asks for; it is never chosen in NCCL's place.
"""
from __future__ import annotations

import datetime
import os

import torch

# The device `init_distributed` bound this rank to (None: not initialized).
_DEVICE: torch.device | None = None
# How long a collective may wait: the other ranks wait at a barrier while
# rank 0 renders bpt, debug or photon mapping alone.
TIMEOUT = datetime.timedelta(minutes=60)


def init_distributed(backend: str | None = None, device=None,
                     init_method: str | None = None) -> bool:
    """Join the process group torchrun describes; returns whether the
    process is one rank of several launched together.

    `device`: "cpu" for CPU ranks (gloo), else the CUDA device
    `cuda:LOCAL_RANK` (or the one given). `backend` defaults to "nccl" for
    CUDA and "gloo" for the CPU. Under gloo, ranks whose LOCAL_RANK has no
    card of its own share the cards round robin; NCCL refuses that.
    `init_method` defaults to torchrun's environment ("env://"); a
    "file://" store suits processes started by hand. Call it once, before
    anything touches the device."""
    global _DEVICE
    if not os.environ.get("WORLD_SIZE"):
        return False
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = None if device is None else torch.device(device)
    cpu = dev is not None and dev.type == "cpu"
    backend = backend or ("gloo" if cpu else "nccl")
    if backend == "nccl" and cpu:
        raise ValueError("NCCL needs CUDA devices; CPU ranks use gloo")
    if cpu:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' for CPU ranks under gloo")
        n_cards = torch.cuda.device_count()
        if dev is None or dev.index is None:
            if local >= n_cards and backend == "nccl":
                raise RuntimeError(
                    f"LOCAL_RANK {local} has no card of its own ({n_cards} "
                    f"visible): NCCL runs one rank per GPU; ask for "
                    f"backend='gloo' to share a card")
            dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = dev
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world, timeout=TIMEOUT, **kwargs)
    _DEVICE = dev
    return True


def bound_device() -> torch.device | None:
    """The device `init_distributed` bound this rank to, if it ran."""
    return _DEVICE


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    global _DEVICE
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None
