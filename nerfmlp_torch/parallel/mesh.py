"""Process groups and the data-parallel layout over them.

Counterpart of ``nerfmlp_tpu/parallel/mesh.py:24-68``. The JAX package
scales by data parallelism over a 1-D device mesh with one axis, "data":
the parameters are replicated, each step's ray batch is sharded along its
batch dimension, and XLA inserts the gradient all-reduce. Here a mesh is
one process ("rank") per device in a ``torch.distributed`` process group:

  * :func:`init_distributed` starts the group (``init_multihost``), NCCL
    for ``cuda`` and gloo for ``cpu`` unless the caller names a backend;
  * :func:`make_mesh` describes this rank's place in it (:class:`Mesh`);
  * :func:`shard_batch` is ``batch_sharding``: this rank's contiguous
    slice of a global batch; :func:`replicate_` is ``replicated_sharding``:
    a broadcast from rank 0, in place;
  * :func:`all_reduce_mean_` and :func:`all_gather_rows` are the two
    collectives the train step and the sharded renderer need;
  * :func:`launch` runs a function on N ranks: N processes spawned here
    (``torch.multiprocessing``, one per device, a ``file://``
    rendezvous), or, under ``torchrun``, this process as one of them.

gloo moves CUDA tensors through the host for ``all_reduce`` and
``broadcast``, and cannot ``all_gather`` them: :func:`all_gather_rows`
then gathers a host copy. Several gloo ranks may share one card; NCCL
refuses two ranks on one GPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import sys
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from nerfmlp_torch import resolve_device

# A collective that waits longer than this raises: a rank that died or
# took another path fails the run instead of hanging it.
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a data-parallel process group: ``rank`` of
    ``world_size``, the ``group`` its collectives run in (``None``: the
    default group), the ``device`` it computes on and the group's
    ``backend`` ("nccl" or "gloo").

    A ("data", "model") mesh (``parallel/tensor_parallel.py::
    make_tp_mesh``) also holds this rank's two sub-meshes: ``data``, the
    ranks that hold the same parameter shards, and ``model``, the ranks
    whose shards make up one net."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    group: Optional[object] = None
    data: Optional["Mesh"] = None
    model: Optional["Mesh"] = None

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that logs and writes files."""
        return self.rank == 0

    @property
    def model_parallel(self) -> int:
        """The size of the "model" axis: 1 on a data-parallel mesh."""
        return 1 if self.model is None else self.model.world_size


def default_backend(device) -> str:
    """NCCL for a ``cuda`` device, gloo for ``cpu``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     device=None) -> int:
    """Start this process's default process group; returns its size.

    ``backend``: default NCCL for ``device`` ``cuda`` (the default
    device) and gloo for ``cpu``. ``init_method``, ``world_size`` and
    ``rank``: as ``torch.distributed.init_process_group`` takes them; all
    three ``None`` reads torchrun's environment (``env://``).
    ``timeout_s``: how long a collective may wait.

    Unlike the JAX package's ``init_multihost``
    (``nerfmlp_tpu/parallel/mesh.py:33-46``), which prints the error and
    goes on as one process, this raises when the group cannot start: a
    run asked for N ranks does not quietly train on one.
    """
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    if backend == "nccl" and dev.type == "cuda":
        # One card per rank, bound before the group starts.
        torch.cuda.set_device(local_device(dev, backend, int(os.environ.get(
            "LOCAL_RANK", rank if rank is not None
            else os.environ.get("RANK", 0)))))
    kwargs = {}
    if init_method is not None:
        kwargs = dict(init_method=init_method, world_size=world_size,
                      rank=rank)
    dist.init_process_group(
        backend=backend, timeout=datetime.timedelta(seconds=timeout_s),
        **kwargs)
    return dist.get_world_size()


def _local_rank() -> int:
    """This process's index on its host: torchrun's ``LOCAL_RANK``, else
    its global rank."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()
                              if dist.is_initialized() else 0))


def local_device(device, backend: str,
                 index: Optional[int] = None) -> torch.device:
    """The device a rank computes on: ``cpu``, or ``cuda:{local rank}``
    (``index``, default :func:`_local_rank`; modulo the visible cards
    under gloo, whose ranks may share one)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    index = _local_rank() if index is None else index
    if backend != "nccl":
        index %= torch.cuda.device_count()
    elif index >= torch.cuda.device_count():
        raise RuntimeError(
            f"rank {index} has no card of its own ({torch.cuda.device_count()}"
            " visible): NCCL refuses two ranks on one GPU; use gloo")
    return torch.device("cuda", index)


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh of the running process group over all its ranks.
    ``n_devices``, where given, must be the group's size: start as many
    ranks as devices. ``device``: ``cuda`` (default) or ``cpu``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "init_distributed (or launch) first")
    world = dist.get_world_size()
    if n_devices not in (None, 0, world):
        raise ValueError(f"make_mesh(n_devices={n_devices}) in a group of "
                         f"{world} ranks: start one rank per device")
    backend = dist.get_backend()
    return Mesh(rank=dist.get_rank(), world_size=world,
                device=local_device(resolve_device(device), backend),
                backend=backend)


def shard_rows(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous rows of ``n``; ``n % world_size != 0`` is
    refused, as JAX's sharding of the batch axis refuses it."""
    if n % mesh.world_size:
        raise ValueError(f"a batch of {n} rays does not split over "
                         f"{mesh.world_size} ranks: use a multiple of "
                         f"{mesh.world_size}")
    per = n // mesh.world_size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch, mesh: Optional[Mesh], axis: int = 0):
    """This rank's contiguous slice of a global batch (a tensor or numpy
    array) along ``axis``; the batch itself without a mesh."""
    if mesh is None:
        return batch
    index = [slice(None)] * batch.ndim
    index[axis] = shard_rows(batch.shape[axis], mesh)
    return batch[tuple(index)]


@torch.no_grad()
def replicate_(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Rank 0's values into every rank's ``tensors``, in place."""
    if mesh is None or mesh.world_size == 1:
        return
    for t in tensors:
        dist.broadcast(t, src=_global_rank(mesh, 0), group=mesh.group)


def _global_rank(mesh: Mesh, rank: int) -> int:
    return rank if mesh.group is None else dist.get_global_rank(mesh.group,
                                                                rank)


def all_reduce_mean_(flat: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over the ranks of ``flat``, in place: one ``all_reduce``
    (sum), then a division by the world size. Every rank gets the same
    bits."""
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    return flat.div_(mesh.world_size)


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each), concatenated along dim
    0 in rank order, on every rank. gloo gathers CUDA tensors through a
    host copy."""
    if mesh.world_size == 1:
        return t
    t = t.contiguous()
    if mesh.backend == "nccl":
        out = t.new_empty((mesh.world_size * t.shape[0],) + t.shape[1:])
        dist.all_gather_into_tensor(out, t, group=mesh.group)
        return out
    host = t.cpu()
    parts = [torch.empty_like(host) for _ in range(mesh.world_size)]
    dist.all_gather(parts, host, group=mesh.group)
    return torch.cat(parts).to(t.device)


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank of ``mesh`` (nothing without one)."""
    if mesh is None or mesh.world_size == 1:
        return
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


# --------------------------------------------------------------------- #
# Running a function on N ranks
# --------------------------------------------------------------------- #
def under_torchrun() -> bool:
    """Whether this process is one rank of a ``torchrun`` launch."""
    return "TORCHELASTIC_RUN_ID" in os.environ or (
        "RANK" in os.environ and "WORLD_SIZE" in os.environ
        and "MASTER_ADDR" in os.environ)


def _rank_entry(rank: int, fn: Callable, args: tuple, kwargs: dict,
                world_size: int, init_method: str, backend: Optional[str],
                device: str, threads: int, timeout_s: float,
                result_path: str) -> None:
    """One spawned rank: its group, its mesh, ``fn(mesh, *args,
    **kwargs)``; rank 0 saves the result for the parent. Ranks other than 0 print nothing to
    standard output (errors still reach standard error)."""
    torch.set_num_threads(threads)
    os.environ["LOCAL_RANK"] = str(rank)
    if rank:
        sys.stdout = open(os.devnull, "w")
    init_distributed(backend, init_method, world_size, rank, timeout_s,
                     device)
    try:
        result = fn(make_mesh(device=device), *args, **kwargs)
        if rank == 0:
            torch.save(result, result_path)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n_ranks: int, args: tuple = (),
           kwargs: Optional[dict] = None, device="cuda",
           backend: Optional[str] = None,
           timeout_s: float = DEFAULT_TIMEOUT_S):
    """``fn(mesh, *args, **kwargs)`` on ``n_ranks`` data-parallel ranks;
    returns rank 0's result.

    Under ``torchrun`` this process is one of the ranks: the group starts
    from its environment (whose size must be ``n_ranks``, or
    ``n_ranks`` 0) and ``fn`` runs here, returning this rank's result.
    Otherwise ``n_ranks`` processes are spawned, each pinned to
    ``torch.get_num_threads() // n_ranks`` intra-op threads (at least 1),
    meeting at a ``file://`` rendezvous in a temporary directory; ``fn``
    must be importable by name (a module-level function of the package)
    and ``args`` picklable. A rank that raises fails the call with its
    traceback. Kernels are built before the spawn, so that ranks do not
    all compile them at once.
    """
    dev = resolve_device(device)
    if under_torchrun():
        init_distributed(backend, timeout_s=timeout_s, device=dev)
        try:
            mesh = make_mesh(n_ranks or None, device=dev)
            return fn(mesh, *args, **(kwargs or {}))
        finally:
            dist.destroy_process_group()
    if n_ranks < 1:
        raise ValueError(f"launch: {n_ranks} ranks")
    if dev.type == "cuda":
        from nerfmlp_torch.ops import _build

        _build.build()
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="nerfmlp_ranks_")
    try:
        result_path = os.path.join(tmp, "result.pt")
        threads = max(1, torch.get_num_threads() // n_ranks)
        mp.start_processes(
            _rank_entry, nprocs=n_ranks, join=True, start_method="spawn",
            args=(fn, tuple(args), dict(kwargs or {}), n_ranks,
                  "file://" + os.path.join(tmp, "store"), backend,
                  dev.type, threads, timeout_s, result_path))
        # Written by rank 0 of this call, in this call's directory.
        return torch.load(result_path, weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
