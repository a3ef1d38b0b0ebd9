"""Device meshes of the row-sharded paths (the port of ``nvdb_tpu.dist.mesh``).

A ``Mesh`` is a [rows][q] grid of torch devices: the store is sharded over
``rows`` and a query batch may also be split over ``q``. The JAX package's
``row_sharding`` and ``replicated`` only describe a placement; here
``shard_rows`` and ``replicate`` place the tensors themselves, one per row
of the mesh. A grid may name one device many times
(``[torch.device("cpu")] * 8``, ``[torch.device("cuda", 0)] * 4``): each row
is a shard all the same, and a shard on its store's own device is a view.

Across processes (``multihost.global_row_mesh``) a mesh holds this
process's rows only, from ``row_offset`` on, of ``n_rows`` in all, and
``gather_rows`` / ``sum_rows`` carry the per-row partials between the
processes over the ``torch.distributed`` group (through the host under
``gloo``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

ROWS = "rows"
QUERIES = "q"


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: Tuple[Tuple[torch.device, ...], ...]   # this process's [rows][q] grid
    row_offset: int = 0           # global index of this process's first row
    n_rows: int = 0               # rows of every process together (0: this grid's)
    backend: Optional[str] = None  # torch.distributed backend when rows span processes

    def __post_init__(self):
        if not self.devices or len({len(r) for r in self.devices}) != 1:
            raise ValueError("a mesh is a non-empty grid of equal rows")
        if self.n_rows == 0:
            object.__setattr__(self, "n_rows", len(self.devices))

    @property
    def shape(self) -> dict:
        return {ROWS: self.n_rows, QUERIES: len(self.devices[0])}

    @property
    def local_rows(self) -> range:
        """The global indices of the rows this process holds."""
        return range(self.row_offset, self.row_offset + len(self.devices))

    def row_device(self, s: int) -> torch.device:
        """The device of global row ``s``'s shard (its first q device)."""
        return self.devices[s - self.row_offset][0]

    @property
    def first(self) -> torch.device:
        """Where partial results are merged."""
        return self.devices[0][0]

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """[local rows, ...] on ``first`` -> [all rows, ...] on ``first``,
        in row order, the same on every process."""
        if self.backend is None:
            return t
        import torch.distributed as dist

        src = (t.cpu() if self.backend == "gloo" else t).contiguous()
        out = [torch.empty_like(src) for _ in range(dist.get_world_size())]
        dist.all_gather(out, src)
        return torch.cat(out).to(self.first)

    def sum_rows(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the processes (itself in one process)."""
        if self.backend is None:
            return t
        import torch.distributed as dist

        src = t.cpu() if self.backend == "gloo" else t.clone()
        dist.all_reduce(src)
        return src.to(self.first)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def row_mesh(n_devices: Optional[int] = None, n_q: int = 1,
             devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``n_devices`` rows by ``n_q`` query devices over ``devices``
    in order (default: every visible CUDA device; ``n_devices`` default: as
    many rows as they fill). Fails by name when there are fewer devices than
    rows x q; it never falls back to the CPU."""
    if devices is None:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        what = "CUDA devices visible"
    else:
        devs = [_device(d) for d in devices]
        what = "devices given"
    if n_devices is None:
        n_devices = len(devs) // n_q
    need = n_devices * n_q
    if n_devices < 1 or n_q < 1 or len(devs) < need:
        raise ValueError(f"row_mesh({n_devices}, n_q={n_q}) needs {max(need, 1)} devices; "
                         f"{len(devs)} {what}")
    return Mesh(tuple(tuple(devs[r * n_q:(r + 1) * n_q]) for r in range(n_devices)))


def shard_rows(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """The mesh's row shards of ``t`` that this process holds: equal blocks
    of dim 0, each on its row's device. When every row is on ``t``'s device
    the shards are views of ``t``; otherwise each is a copy, so that ``t``
    itself can be freed."""
    n_rows = mesh.shape[ROWS]
    if t.shape[0] % n_rows != 0:
        raise ValueError(f"{t.shape[0]} rows do not split into {n_rows} equal shards")
    rps = t.shape[0] // n_rows
    views = all(mesh.row_device(s) == t.device for s in mesh.local_rows)
    out = []
    for s in mesh.local_rows:
        part = t[s * rps:(s + 1) * rps]
        out.append(part if views else part.to(mesh.row_device(s), copy=True))
    return out


def replicate(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """``t`` whole on each row's device this process holds."""
    return [t.to(mesh.row_device(s)) for s in mesh.local_rows]
