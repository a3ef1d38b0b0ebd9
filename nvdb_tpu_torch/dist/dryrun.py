"""One step of each sharded path on tiny shapes (the port of
``__graft_entry__.dryrun_multichip``).

    python -m nvdb_tpu_torch.dist.dryrun 4            # four visible cards
    python -m nvdb_tpu_torch.dist.dryrun 8 --cpu      # eight CPU shards

On an n-device mesh (rows x 2 query devices when n is even and at least
4): one sharded flat search step, one sharded Lloyd step, and one sharded
IVF-PQ search whose refine store is row-sharded, so ``sharded_refine``
runs; on a card every step runs the port's kernels. ``devices`` may repeat
one device (``[torch.device("cuda", 0)] * 4``).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch


def _synth(n: int, d: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """Run the three steps over ``devices`` (default: the visible cards;
    fails by name with fewer than ``n_devices``); returns their shapes and
    the Lloyd objective."""
    from nvdb_tpu_torch.dist import mesh as meshmod
    from nvdb_tpu_torch.dist.sharded import sharded_flat_topk, sharded_lloyd_step
    from nvdb_tpu_torch.dist.sharded_ivf import ShardedIVFPQIndex
    from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
    from nvdb_tpu_torch.store import ShardedVectorStore

    n_q = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = meshmod.row_mesh(n_devices // n_q, n_q=n_q, devices=devices)
    S = mesh.shape[meshmod.ROWS]
    n, d, b, k = 64 * S, 128, 8 * n_q, 5
    base = _synth(n, d, seed=0)
    store = ShardedVectorStore.from_numpy(base, mesh, "f32", row_block=32)
    queries = torch.from_numpy(store.pad_queries(_synth(b, d, seed=1))).to(mesh.first)

    vals, ids = sharded_flat_topk(mesh, queries, store.vectors, None, store.n, k,
                                  shard_queries=n_q > 1)
    assert vals.shape == (b, k) and ids.shape == (b, k)
    assert int(ids.max()) < store.n and int(ids.min()) >= 0

    cents0 = torch.from_numpy(store.pad_queries(base[:8])).to(mesh.first)
    cents1, obj = sharded_lloyd_step(mesh, store.vectors, cents0, store.n)
    assert cents1.shape == cents0.shape and bool(torch.isfinite(obj))

    # the compressed index over n row shards, the refine store sharded with it
    pmesh = meshmod.row_mesh(n_devices, devices=devices)
    pqi = IVFPQIndex.build(base, nlist=2 * pmesh.shape[meshmod.ROWS], m=8, use_opq=False,
                           train_size=n, n_iters=2, seed=3, device=pmesh.first)
    spq = ShardedIVFPQIndex.from_index(pqi, pmesh)
    ref_store = ShardedVectorStore.from_numpy(base, pmesh, "f32", row_block=8)
    _, pi = spq.search(_synth(b, d, seed=2), k, nprobe=2 * pmesh.shape[meshmod.ROWS],
                       refine_k=4 * k, refine_store=ref_store)
    assert pi.shape == (b, k) and int(pi.max()) < n and int(pi.min()) >= 0
    out = dict(mesh=mesh.shape, search=tuple(vals.shape), obj=float(obj),
               ivfpq_mesh=pmesh.shape, ivfpq=tuple(pi.shape))
    print(f"dryrun_multichip OK: mesh={mesh.shape} search {tuple(vals.shape)} train "
          f"obj={float(obj):.4f} sharded-ivfpq+sharded-refine {tuple(pi.shape)} on "
          f"{mesh.first}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("n", type=int, help="devices of the mesh")
    p.add_argument("--cpu", action="store_true", help="n shards on the CPU")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, [torch.device("cpu")] * args.n if args.cpu else None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
