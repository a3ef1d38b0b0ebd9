"""Multi-process scaffolding for the row-sharded paths (the port of
``nvdb_tpu.dist.multihost``, on ``torch.distributed``).

Each process holds the row shards of its own devices; ``global_row_mesh``
numbers the rows of every process in rank order, so each process's rows
are one contiguous block of the file and ``load_sharded`` reads only that
block. The sharded functions run unchanged: their merge all-gathers the
[S_local, B, k] partials over the process group, so every process returns
the same answer.

- ``init_from_env()`` joins the process group named by ``NVDB_COORD``
  (``host:port`` of rank 0), ``NVDB_NPROC`` (the process count) and
  ``NVDB_PROC_ID`` (this rank), the JAX package's names. Without all three
  it does nothing; a second call is harmless. The JAX package's
  ``NVDB_MULTIHOST=1`` asks a TPU pod's runtime for its topology and has no
  meaning here.
- The tools join in ``tools._common.setup_device``, as the JAX tools do in
  ``setup_jax``; their ``--shards`` mesh then spans the processes.
- The backend follows one rule (``choose_backend``): ``nccl`` when every
  process on this host has a card of its own (at least as many visible
  cards as local processes: ``LOCAL_WORLD_SIZE`` where a launcher sets it,
  else ``NVDB_NPROC``), ``gloo`` otherwise, with the partials crossing on
  the host. NCCL refuses two ranks on one device.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from nvdb_tpu_torch.dist import mesh as mesh_lib
from nvdb_tpu_torch.store.store import ShardedVectorStore

ENV = ("NVDB_COORD", "NVDB_NPROC", "NVDB_PROC_ID")


def _dist():
    import torch.distributed as dist

    return dist


def joined() -> bool:
    """Whether this process is in a process group."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def _local_procs(nproc: int) -> tuple:
    """(processes on this host, this process's index among them)."""
    rank = int(os.environ.get("NVDB_PROC_ID", "0"))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", nproc))
    return local, int(os.environ.get("LOCAL_RANK", rank % max(local, 1)))


def choose_backend(local_nproc: int) -> str:
    """``nccl`` when this host has a card for each of its processes, else ``gloo``."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_nproc:
        return "nccl"
    return "gloo"


def init_from_env(backend: Optional[str] = None) -> bool:
    """Join the process group the env names; True if this process is in one.
    ``backend``: the group's backend (default ``choose_backend``; ``gloo``
    for a run on the CPU, whose partials never touch a card)."""
    if joined():
        return True
    coord = os.environ.get("NVDB_COORD")
    nproc = os.environ.get("NVDB_NPROC")
    proc_id = os.environ.get("NVDB_PROC_ID")
    if not (coord and nproc and proc_id is not None):
        return False
    local, local_rank = _local_procs(int(nproc))
    backend = backend or choose_backend(local)
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    _dist().init_process_group(backend, init_method=f"tcp://{coord}",
                               world_size=int(nproc), rank=int(proc_id))
    return True


def local_device() -> torch.device:
    """This process's card: ``cuda:<local rank>``, shared round-robin when
    the host has fewer cards than processes (as under ``gloo``)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise ValueError("no CUDA devices visible")
    world = _dist().get_world_size() if joined() else 1
    return torch.device("cuda", _local_procs(world)[1] % n)


def _default_devices() -> Optional[list]:
    """This process's devices: every visible card in one process (None:
    ``row_mesh``'s default); in a group, the cards of this host split among
    its processes (shared when there are fewer cards than processes, as
    under ``gloo``)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not joined() or n == 0:
        return None
    local, local_rank = _local_procs(_dist().get_world_size())
    if n < local:
        return [local_device()]
    per = n // local
    return [torch.device("cuda", local_rank * per + i) for i in range(per)]


def global_row_mesh(n_q: int = 1, devices: Optional[Sequence] = None) -> mesh_lib.Mesh:
    """A rows x q mesh over the devices of every process: this process's
    ``devices`` (default ``_default_devices()``; fails by name without a
    card) make its rows, numbered after those of the lower ranks. Every
    process must bring as many devices."""
    local = mesh_lib.row_mesh(None, n_q, _default_devices() if devices is None else devices)
    if not joined():
        return local
    dist = _dist()
    backend = dist.get_backend()
    rows = torch.tensor([len(local.devices)],
                        device=local.first if backend == "nccl" else "cpu")
    every = [torch.empty_like(rows) for _ in range(dist.get_world_size())]
    dist.all_gather(every, rows)
    counts = [int(c) for c in every]
    if len(set(counts)) != 1:
        raise ValueError(f"processes hold unequal row counts {counts}")
    L = counts[0]
    return mesh_lib.Mesh(local.devices, row_offset=dist.get_rank() * L,
                         n_rows=L * len(counts), backend=backend)


def from_rank0(obj):
    """Rank 0's ``obj`` on every process (``broadcast_object_list``; its
    tensors come back on the devices they were pickled from), ``obj``
    itself outside a group."""
    if not joined():
        return obj
    box = [obj if _dist().get_rank() == 0 else None]
    _dist().broadcast_object_list(box, src=0)
    return box[0]


def load_sharded(path: str, mesh: Optional[mesh_lib.Mesh] = None,
                 row_block: int = 1024) -> ShardedVectorStore:
    """Each process loads its own rows of a vecbin file, straight from the
    mmap'd file onto its devices (``ShardedVectorStore.from_vecbin``): no
    process reads the rows of another or holds the whole matrix."""
    return ShardedVectorStore.from_vecbin(path, mesh if mesh is not None else global_row_mesh(),
                                          row_block=row_block)


def process_summary(mesh: Optional[mesh_lib.Mesh] = None) -> str:
    """One line of topology for logs: rank, process count, this process's
    devices and all of them (the mesh's when one is given, else the visible
    cards), and the process-group backend."""
    dist = _dist()
    multi = joined()
    rank, world = (dist.get_rank(), dist.get_world_size()) if multi else (0, 1)
    if mesh is not None:
        local = len(mesh.devices) * mesh.shape[mesh_lib.QUERIES]
        total = mesh.shape[mesh_lib.ROWS] * mesh.shape[mesh_lib.QUERIES]
    else:
        local = torch.cuda.device_count() if torch.cuda.is_available() else 0
        total = local * world
    backend = dist.get_backend() if multi else "none"
    return (f"process {rank}/{world} local_devices={local} global_devices={total} "
            f"backend={backend}")
