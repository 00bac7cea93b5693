"""Multi-process data parallelism (counterpart of the JAX
``parallel/mesh.py``; the name is kept so a reader finds it).

The JAX package spans processes with ``jax.distributed`` and one mesh axis
``'data'`` over every chip of every process. The port runs one process per
card: rank ``r`` owns ``cuda:LOCAL_RANK`` (torchrun's ``LOCAL_RANK``, else
the rank modulo the host's card count), its loaders take ``host_shard()``'s
slice of every epoch, and the ranks meet in a ``torch.distributed`` process
group: NCCL on the card, gloo on the CPU. ``-batch_size`` stays per process,
as in the JAX package, and the global batch is the ranks' local batches
concatenated in rank order (JAX ``put_sharded``).

The collectives here put their tensors on the process group's device
(NCCL takes only CUDA tensors) and hand the result back on the caller's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device


def init_distributed(coordinator_address: str = "",
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None, device=None) -> bool:
    """Join the job's process group; call once per process before any
    device use. ``coordinator_address`` ('host:port' of rank 0, or a full
    ``tcp://`` URL) takes ``num_processes`` and ``process_id``; without it
    the group comes from torchrun's environment (``env://``: ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), the counterpart of
    JAX's auto-detection. ``backend``: default NCCL when ``device`` is a
    CUDA device (the default), gloo for the CPU. On a CUDA device the
    process's current device becomes its card: ``device``'s own index when
    it names one, else the local rank's.

    Idempotent like the JAX ``init_distributed``: returns False, and leaves
    the live group alone, when the process is already in one."""
    if dist.is_initialized():
        return False
    dev = torch.device(device) if device else torch.device("cuda")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run the process group on the "
                           "CPU over gloo")
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes "
                             "and process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(
            backend, init_method="env://",
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else local_rank())
    return True


def local_rank() -> int:
    """This process's card on its host: torchrun's ``LOCAL_RANK``, else
    the rank modulo the host's card count."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_index() % max(torch.cuda.device_count(), 1)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_shard() -> Optional[tuple]:
    """(process_index, process_count) for ``DataLoader(shard=...)``, or
    None with one process: each process then loads a disjoint slice of
    every epoch."""
    n = process_count()
    return (process_index(), n) if n > 1 else None


@dataclass(frozen=True)
class DataMesh:
    """The ranks of a process group, each with one device: the port's
    counterpart of a 1-D ``'data'`` mesh that spans processes."""

    group: object
    device: torch.device

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)


def make_mesh(device=None, *, batch_size: Optional[int] = None,
              group=None) -> DataMesh:
    """The mesh of the live process group (default: the whole job), with
    this rank's ``device`` (default: the current CUDA device; raises
    without one).

    The JAX ``make_mesh`` checks that the per-process batch divides over
    the process's chips. With one device per rank every batch divides;
    what is left of the check is one rank per card, which NCCL needs: the
    card must exist, and a host's ranks (torchrun's ``LOCAL_WORLD_SIZE``)
    must not outnumber its cards."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed first (--distributed true)")
    if batch_size is not None and batch_size < 1:
        raise ValueError(f"per-process batch {batch_size} is empty")
    dev = resolve_device(device)
    if dist.get_backend(group) == "nccl":
        n_cards = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        if dev.type != "cuda" or dev.index >= n_cards or local > n_cards:
            raise ValueError(
                f"NCCL needs one rank per card: rank {process_index()} on "
                f"{dev}, {local} ranks on a host with {n_cards} cards")
    return DataMesh(group=group or dist.group.WORLD, device=dev)


_host_group = []


def host_group():
    """A gloo group over the whole job, for flags the host decides on
    (preemption): its collectives never wait for the card. The job's own
    group when that is gloo already. Made at the first call, which every
    rank must reach at the same point."""
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    if not _host_group:
        _host_group.append(dist.new_group(backend="gloo"))
    return _host_group[0]


def _group_device(group=None) -> Optional[torch.device]:
    """Where the group's collectives take their tensors: this rank's card
    under NCCL; None (the tensor's own device) under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return None


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """The ``op`` ('sum', 'max' or 'avg') of ``t`` over the group's ranks,
    on ``t``'s device; ``t`` is left as it was."""
    dev = _group_device(group)
    x = t.detach().to(dev if dev is not None else t.device, copy=True)
    if op == "avg":
        dist.all_reduce(x, dist.ReduceOp.SUM, group=group)
        x /= dist.get_world_size(group)
    else:
        dist.all_reduce(x, {"sum": dist.ReduceOp.SUM,
                            "max": dist.ReduceOp.MAX}[op], group=group)
    return x.to(t.device)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """(ranks, *t.shape): every rank's ``t`` in rank order, on ``t``'s
    device."""
    dev = _group_device(group)
    x = t.detach().to(dev if dev is not None else t.device).contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return torch.stack(out).to(t.device)
