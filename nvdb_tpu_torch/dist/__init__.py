"""Row-sharded search over several devices (the port of ``nvdb_tpu.dist``).

The JAX package runs one program over a device mesh with ``shard_map``. The
port keeps its single controller: one process holds a list of per-shard
tensors, one per row of the mesh, runs each shard's work on that shard's
device with the same kernels as the single-device path, and merges the
partial results on the mesh's first device. ``multihost`` spreads the rows
over processes with ``torch.distributed``; each process then holds its own
shards, and the partials are all-gathered so that every process returns the
same answer.

- ``mesh``        — ``Mesh``, ``row_mesh``, ``shard_rows``, ``replicate``.
- ``sharded``     — ``sharded_flat_topk``, ``sharded_lloyd_step``,
                    ``ShardedFlatIndex``.
- ``sharded_ivf`` — ``ShardedIVFFlatIndex``, ``ShardedIVFPQIndex``,
                    ``ShardedPartitionIndex``, ``sharded_refine``.
- ``multihost``   — ``init_from_env``, ``global_row_mesh``, ``load_sharded``,
                    ``process_summary``.
- ``dryrun``      — ``dryrun_multichip``: one step of each on tiny shapes.
"""

from nvdb_tpu_torch.dist.mesh import Mesh, replicate, row_mesh, shard_rows  # noqa: F401
from nvdb_tpu_torch.dist.sharded import ShardedFlatIndex, sharded_flat_topk  # noqa: F401
