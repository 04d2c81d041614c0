"""Data parallelism over `torch.distributed`, one process per card (the
JAX package's `parallel/mesh.py` and its trainer's
`maybe_init_distributed`).

The JAX package can put several chips under one process (`auto_mesh`).
Here each card has a process of its own, launched by `torchrun` (or by an
explicit `init_distributed`): a process drives `local_device()`, a batch
is the concatenation of every rank's rows in rank order, and the modules
that shard (the train step, the trainer, the sampler, the serving replay
channel) call the collectives below.  Without a process group every
function here is the one-process identity: `rank()` 0, `world()` 1.

The backend is `nccl` when each rank owns its card and `gloo` on the CPU.
NCCL refuses two ranks on one card; a caller that puts two ranks on one
card names `gloo` itself (gloo's collectives run on the host, so the
helpers below stage CUDA tensors through host memory for it).  A process
group that fails to start raises: no rank ever goes on alone.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from music_generator_tpu_torch.device import DeviceLike


def init_distributed(rank: int, world: int, addr: str,
                     backend: Optional[str] = None,
                     device: DeviceLike = None,
                     timeout_s: float = 600.0) -> None:
    """Join the process group at `addr` (``tcp://host:port``) as `rank`
    of `world`.  `backend` defaults to nccl for a CUDA `device` (the
    default) and gloo for the CPU.  Raises when the group does not form
    within `timeout_s`."""
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                          rank)))
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"nccl rank {rank} needs card {dev.index}, and "
                f"{torch.cuda.device_count()} are visible: one rank per "
                f"card (two ranks on one card take backend='gloo')")
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=addr, rank=int(rank), world_size=int(world),
        timeout=datetime.timedelta(seconds=timeout_s))


def maybe_init_distributed(device: DeviceLike = None) -> bool:
    """Join the process group a launcher describes: fires on torchrun's
    environment (WORLD_SIZE > 1, with MASTER_ADDR, MASTER_PORT, RANK) or on
    DEEPJ_DISTRIBUTED=1; DEEPJ_DISTRIBUTED=0 disables it.  Call it before
    any CUDA call.  `device` is what the entry point was asked to run on
    (None: `local_device()`).  Returns whether a group is up; a group
    that fails to start raises."""
    force = os.environ.get("DEEPJ_DISTRIBUTED")
    if force == "0":
        return False
    if dist.is_initialized():
        return True
    if not (int(os.environ.get("WORLD_SIZE", "1")) > 1 or force == "1"):
        return False
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        if var not in os.environ:
            raise RuntimeError(
                f"distributed launch without {var}: start the ranks with "
                f"torchrun, or set DEEPJ_DISTRIBUTED=0 to run alone")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = local_device()
    init_distributed(
        int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
        f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        device=dev)
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device() -> torch.device:
    """This process's card: cuda:LOCAL_RANK (torchrun sets LOCAL_RANK;
    cuda:0 without it)."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def _on_host() -> bool:
    """gloo's collectives take host tensors."""
    return dist.get_backend() == "gloo"


def _collective(fn, t: torch.Tensor, *args) -> torch.Tensor:
    """Run `fn(t, *args)` in place on `t`, through host memory on gloo."""
    if t.is_cuda and _on_host():
        host = t.cpu()
        fn(host, *args)
        t.copy_(host)
    else:
        fn(t, *args)
    return t


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


@torch.no_grad()
def _unflat(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    at = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[at:at + n].view_as(t))
        at += n


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place: ONE
    collective over a flat bucket of all of them (they share a dtype and a
    device).  Every rank ends with the same bytes."""
    if world() == 1 or not tensors:
        return
    flat = _collective(dist.all_reduce, _flat(tensors))
    flat.div_(world())
    _unflat(flat, tensors)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with rank `src`'s, in place: one collective
    per dtype."""
    if world() == 1:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = _collective(dist.broadcast, _flat(group), src)
        _unflat(flat, group)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` (equal shapes) concatenated on dim 0 in rank
    order, on every rank."""
    if world() == 1:
        return t
    src = t.cpu() if t.is_cuda and _on_host() else t.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(src)
                                 for _ in range(world())]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(t.device)


def broadcast_bytes(data: Optional[bytes], n: int, src: int = 0) -> bytes:
    """Rank `src`'s `n` bytes on every rank (the others pass None)."""
    buf = torch.zeros(n, dtype=torch.uint8)
    if rank() == src:
        buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    if world() > 1:
        if dist.get_backend() == "nccl":
            buf = buf.to(torch.cuda.current_device())
        dist.broadcast(buf, src)
    return bytes(buf.cpu().numpy().tobytes())


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def destroy() -> None:
    """Leave the process group (no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
