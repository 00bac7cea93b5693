"""Data parallelism over processes and over one process's cards
(counterpart of the JAX ``parallel/mesh.py``; the name is kept so a reader
finds it).

The JAX package has one mesh axis ``'data'`` over every chip. The port
maps it in two ways, keeping its rule of one process per card for
training:

- Across cards, training (``--distributed true``, torchrun or
  ``--coordinator_address``): one process per card in a
  ``torch.distributed`` group, NCCL on the card, gloo on the CPU. Rank
  ``r`` owns ``cuda:LOCAL_RANK`` (torchrun's ``LOCAL_RANK``, else the rank
  modulo the host's card count), its loaders take ``host_shard()``'s slice
  of every epoch, and ``make_mesh`` gives the train steps their
  ``DataMesh``. ``-batch_size`` stays per process, as in the JAX package,
  and the global batch is the ranks' local batches concatenated in rank
  order (JAX ``put_sharded``). Each step equals the JAX step on that
  global batch: every BatchNorm statistic, mean and scan runs over it.
- One process over this host's cards, inference (``--data_parallel
  true``; JAX ``local_data_mesh``): a ``LocalMesh``, an ordered list of
  devices (default every visible card, which ``CUDA_VISIBLE_DEVICES``
  narrows) that shrinks to the largest count dividing the batch, as JAX
  ``make_mesh`` does. ``replicate`` keeps one copy of the model a device,
  ``split_rows`` gives each replica its contiguous rows and
  ``map_shares`` runs each replica on its rows and puts the results back
  in row order. Without ``--data_parallel`` the loops run the same code
  over a one-device mesh (``LocalMesh.of``). Launches are
  asynchronous, so one thread issuing each replica's rows to its own card
  overlaps the cards. A device may repeat (``[cpu, cpu]``, ``[cuda:0,
  cuda:0]``): its entries share one copy and, on a card, one stream.
- A (data, spatial) mesh over the process group (JAX ``make_mesh_2d``):
  ``make_mesh_2d`` gives a ``SpatialMesh`` whose ranks each hold one
  block of the global batch, rows by their data index and image columns
  by their spatial index (``image_sharding``, ``label_sharding``). The seg
  train step runs on it (``train/seg.py``); the width split and its halo
  exchange are ``parallel/spatial.py``.

The collectives here put their tensors on the process group's device
(NCCL takes only CUDA tensors) and hand the result back on the caller's.
"""

from __future__ import annotations

import copy
import os
import warnings
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device
from .spatial import SpatialLayout, column_range


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


@dataclass(frozen=True)
class SpatialMesh:
    """The ranks of a process group as a (data, spatial) grid, the port's
    counterpart of the JAX 2-D mesh (axes ``'data'``, ``'spatial'``):
    rank ``r`` is at data index ``r // spatial`` and spatial index
    ``r % spatial``, as JAX reshapes its devices. ``spatial_group`` holds
    the ranks of this rank's data index, which split the width of its
    rows; ``group`` the whole grid."""

    group: object
    device: torch.device
    spatial: int
    spatial_group: object

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def data(self) -> int:
        return self.size // self.spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    def layout(self) -> SpatialLayout:
        """A fresh ``SpatialLayout`` of this rank's spatial group."""
        return SpatialLayout(self.spatial_group, self.spatial,
                             self.spatial_index)


def make_mesh_2d(device=None, *, spatial: int = 2) -> SpatialMesh:
    """The (data, spatial) mesh of the job's process group: ``spatial``
    ranks split each image's width, the world size over ``spatial`` data
    indices split the batch. Use it where a rank's batch would drop below
    one image or its activations outgrow the card at full resolution
    (JAX ``make_mesh_2d``). Every rank makes every spatial group, so
    every rank must call this at the same point. ``device`` and the NCCL
    check as ``make_mesh``."""
    base = make_mesh(device)
    world = base.size
    if spatial < 1 or world % spatial:
        raise ValueError(f"spatial {spatial} does not divide the "
                         f"{world} ranks")
    mine = base.group
    if spatial < world:
        for d in range(world // spatial):
            sub = dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
            if base.rank // spatial == d:
                mine = sub
    return SpatialMesh(group=base.group, device=base.device,
                       spatial=spatial, spatial_group=mine)


def image_sharding(mesh: SpatialMesh, image: torch.Tensor) -> torch.Tensor:
    """This rank's block of a global NHWC ``image`` batch: its data
    index's rows and its spatial index's columns (JAX
    ``image_sharding(mesh, spatial=True)``, which names the layout where
    this cuts it)."""
    n = image.shape[0]
    if n % mesh.data:
        raise ValueError(f"global batch {n} does not divide over the "
                         f"{mesh.data} data indices")
    rows = n // mesh.data
    lo, hi = column_range(image.shape[2], mesh.spatial, mesh.spatial_index)
    return image[mesh.data_index * rows:(mesh.data_index + 1) * rows, :,
                 lo:hi]


# a global (N, H, W) label batch is cut as the images are (JAX
# ``label_sharding(mesh, spatial=True)``)
label_sharding = image_sharding


# the job's group and the gloo group made over it by ``host_group``
_host_group = {}


def host_group():
    """A gloo group over the whole job, for flags and sizes the host
    decides on (preemption, the spatial step's block sizes): its
    collectives never wait for the card. The job's own group when that is
    gloo already. Made at the first call under each process group (a
    process that destroys its group and joins another gets a new one),
    which every rank must reach at the same point."""
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    if _host_group.get("job") is not dist.group.WORLD:
        _host_group["group"] = dist.new_group(backend="gloo")
        _host_group["job"] = dist.group.WORLD
    return _host_group["group"]


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


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows of ``t`` (equal-sized on every rank) as one batch
    in rank order: the global batch of a per-rank tensor."""
    return all_gather(t, group).flatten(0, 1)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, on ``t``'s device."""
    dev = _group_device(group)
    x = t.detach().to(dev if dev is not None else t.device, copy=True)
    dist.broadcast(x, src, group=group)
    return x.to(t.device)


def all_reduce_grads(params, group=None) -> None:
    """Sum the gradients of ``params`` over the group's ranks, in place,
    through one flat buffer (a parameter without a gradient gets zeros).
    The train steps write each rank's loss as its share of the global
    batch's loss, so the sum is the global batch's gradient. The reduced
    values are copied back into the gradients, which keep their
    parameters' layout (``channels_last`` convolutions)."""
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dev = _group_device(group)
    if dev is not None and flat.device != dev:
        flat = flat.to(dev)
    dist.all_reduce(flat, group=group)
    torch._foreach_copy_(grads, [part.view(g.shape) for g, part in zip(
        grads, flat.split([g.numel() for g in grads]))])


@dataclass(frozen=True)
class LocalMesh:
    """This process's devices for data-parallel inference, in row order:
    replica ``k`` on ``devices[k]`` takes the ``k``-th contiguous share of
    every batch (JAX ``local_data_mesh``). ``LocalMesh.of(mesh, device)``
    is ``mesh``, or the one-device mesh of ``device`` without one."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    @staticmethod
    def of(mesh: Optional["LocalMesh"], device) -> "LocalMesh":
        return mesh if mesh is not None else LocalMesh(
            (torch.device(device),))


def default_devices() -> List[torch.device]:
    """Every card this process sees (raises without one)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("--data_parallel needs CUDA devices; none is "
                           "visible")
    return [torch.device("cuda", i) for i in range(n)]


def local_data_mesh(batch_size: Optional[int] = None,
                    devices: Optional[Sequence] = None) -> LocalMesh:
    """A ``LocalMesh`` over ``devices`` (default ``default_devices()``).
    When ``batch_size`` does not divide over them, the mesh shrinks to the
    largest count that divides it, with the JAX ``make_mesh`` warning."""
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else default_devices())]
    n = len(devs)
    if n == 0:
        raise ValueError("a LocalMesh needs at least one device")
    if batch_size is not None and n > 1 and batch_size % n:
        keep = max(d for d in range(1, n + 1) if batch_size % d == 0)
        warnings.warn(
            f"global batch {batch_size} does not divide over {n} devices; "
            f"using {keep} device(s) and leaving {n - keep} idle — "
            f"use a batch size that is a multiple of {n} to engage every "
            f"chip", stacklevel=2)
        devs = devs[:keep]
    return LocalMesh(tuple(devs))


def replicate(mesh: LocalMesh, model: torch.nn.Module
              ) -> List[torch.nn.Module]:
    """The model of each entry of the mesh: one copy a device, made once
    and shared by the entries that repeat the device (inference changes
    no state). ``model`` itself on its own device, a deep copy
    (``channels_last``, as the port keeps its nets) on every other; the
    copies keep the model's mode."""
    copies = {next(model.parameters()).device: model}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = copy.deepcopy(model).to(
                device=dev, memory_format=torch.channels_last)
    return [copies[dev] for dev in mesh.devices]


def split_rows(mesh: LocalMesh, n: int) -> List[slice]:
    """The contiguous rows of a batch of ``n`` that each replica takes:
    equal shares where the mesh divides ``n``; a ragged tail is split as
    evenly as it goes, the first replicas one row more, and a replica
    with no row gets an empty slice (nothing is padded)."""
    q, r = divmod(n, mesh.size)
    bounds = [k * q + min(k, r) for k in range(mesh.size + 1)]
    return [slice(bounds[k], bounds[k + 1]) for k in range(mesh.size)]


def gather_parts(parts, device) -> torch.Tensor:
    """The replicas' outputs back on ``device`` as one batch in row
    order."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts])


def map_shares(fn, replicas, device, *shares):
    """``fn(replica, *share)`` for each replica whose share of the batch
    has rows, issued from this thread (each replica's launches queue on
    its own device), with the results gathered on ``device`` in row
    order: one tensor, or a tuple of them where ``fn`` returns a tuple.
    ``shares`` holds one list of the replicas' shares per argument of
    ``fn``. Every inference loop runs its batches through here, over a
    one-device mesh without ``--data_parallel``."""
    outs = [fn(r, *xs) for r, *xs in zip(replicas, *shares)
            if xs[0].shape[0]]
    if isinstance(outs[0], tuple):
        return tuple(gather_parts(parts, device) for parts in zip(*outs))
    return gather_parts(outs, device)
