"""One rank of a multi-process sharded flat search: the worker that the
two-process tests and ``chip_smoke.py`` start, one per rank, with
``NVDB_COORD`` / ``NVDB_NPROC`` / ``NVDB_PROC_ID`` set.

    python -m nvdb_tpu_torch.dist._worker base.vecbin queries.npy K OUT_DIR \\
        [--device cpu|cuda:0] [--shards-per-rank 2] [--row-block 1024]

Each rank joins the group, builds the global row mesh from its own
``--shards-per-rank`` shards on ``--device``, loads its rows of the vecbin
file (``load_sharded``), searches every query with ``ShardedFlatIndex``
and writes its ids to ``OUT_DIR/ids_<rank>.npy``. It prints
``process_summary``, the rows it loaded and ``OK rank=<rank>``.
``run_ranks`` starts the ranks on localhost and waits for them.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_ranks(argv, nproc: int = 2, timeout: float = 120.0) -> list:
    """Start ``nproc`` ranks of this worker with ``argv`` on a localhost
    coordinator; wait for each at most ``timeout`` seconds, killing every
    rank if one runs over. Returns [(exit code, output)] by rank."""
    with socket.socket() as sock:   # a free localhost port for the coordinator
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(nproc):
        env = dict(os.environ, NVDB_COORD=f"localhost:{port}", NVDB_NPROC=str(nproc),
                   NVDB_PROC_ID=str(rank))
        env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen([sys.executable, "-m", "nvdb_tpu_torch.dist._worker",
                                       *argv], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    out = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=timeout)
            out.append((p.returncode, text))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("base")
    p.add_argument("queries", help=".npy of f32 queries [Q, d]")
    p.add_argument("k", type=int)
    p.add_argument("out_dir")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--shards-per-rank", type=int, default=2)
    p.add_argument("--row-block", type=int, default=1024)
    args = p.parse_args(argv)

    from nvdb_tpu_torch.dist import multihost
    from nvdb_tpu_torch.dist.sharded import ShardedFlatIndex

    if not multihost.init_from_env():
        raise SystemExit("error: NVDB_COORD, NVDB_NPROC and NVDB_PROC_ID must be set")
    import torch.distributed as dist

    rank = dist.get_rank()
    mesh = multihost.global_row_mesh(devices=[torch.device(args.device)] * args.shards_per_rank)
    print(multihost.process_summary(mesh), flush=True)
    store = multihost.load_sharded(args.base, mesh, row_block=args.row_block)
    r0 = mesh.row_offset * store.rows_per_shard
    print(f"rank {rank} rows [{r0}, {r0 + len(store.shards) * store.rows_per_shard}) "
          f"valid {sum(s.n for s in store.shards)} of {store.n}", flush=True)
    _, ids = ShardedFlatIndex(store, mesh).search(np.load(args.queries), args.k)
    np.save(os.path.join(args.out_dir, f"ids_{rank}.npy"), ids)
    dist.barrier()
    dist.destroy_process_group()
    print(f"OK rank={rank}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
