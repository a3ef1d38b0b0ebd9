"""Sharded flat scan and Lloyd step (the port of ``nvdb_tpu.dist.sharded``).

Each row shard is scanned on its device by ``dispatch.flat_topk``, the
single-device path's kernel, with its own valid-row count (a shard of
padding alone has none and returns (-inf, -1)); local ids become global
ids, and one merge of the [S, B, k] partials gives the global top-k by
(score desc, id desc), the port's order. JAX's ``lax.top_k`` over the same
partials prefers the lower shard at a tie, so ids may differ from JAX's at
equal scores. Queries may also be split over the mesh's ``q`` axis.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from nvdb_tpu_torch.dist import mesh as meshmod
from nvdb_tpu_torch.kernels import dispatch, kmeans, ops


def _ordered(vals: torch.Tensor, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, W] candidates sorted by (score desc, id desc): two stable sorts,
    no host sync (``ops.merge_topk`` first narrows with a count read back
    to the host, which would stall every call of a sharded path)."""
    order = torch.argsort(ids, dim=1, descending=True, stable=True)
    vals, ids = torch.gather(vals, 1, order), torch.gather(ids, 1, order)
    order = torch.argsort(vals, dim=1, descending=True, stable=True)
    return torch.gather(vals, 1, order), torch.gather(ids, 1, order)


def merge_partials(vals: Sequence[torch.Tensor], ids: Sequence[torch.Tensor], k: int,
                   mesh: meshmod.Mesh, dedup_width: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k of the local row shards' [B, kk] partials (global ids,
    -1 empty), merged on ``mesh.first`` after the partials of every process
    are gathered, by (score desc, id desc), (-inf, -1) past the candidates.
    ``dedup_width`` > 0 (replicated indexes): the best that many, then each
    id once at its best score (``ops.dedup_topk``'s rule)."""
    av = mesh.gather_rows(torch.stack([v.to(mesh.first) for v in vals]))   # [S, B, kk]
    ai = mesh.gather_rows(torch.stack([i.to(mesh.first) for i in ids]))
    S, B, kk = av.shape
    av, ai = _ordered(av.permute(1, 0, 2).reshape(B, S * kk),
                      ai.permute(1, 0, 2).reshape(B, S * kk))
    if dedup_width:
        # by id, each id's copies in score order: all but the first go
        order = torch.argsort(ai[:, :dedup_width], dim=1, stable=True)
        sv, si = torch.gather(av, 1, order), torch.gather(ai, 1, order)
        dup = torch.zeros_like(si, dtype=torch.bool)
        dup[:, 1:] = si[:, 1:] == si[:, :-1]
        av, ai = _ordered(torch.where(dup, ops.NEG_INF, sv), torch.where(dup, -1, si))
    if av.shape[1] < k:
        pad = k - av.shape[1]
        av = torch.cat([av, torch.full((B, pad), ops.NEG_INF, device=av.device)], dim=1)
        ai = torch.cat([ai, torch.full((B, pad), -1, dtype=ai.dtype, device=ai.device)], dim=1)
    return av[:, :k], ai[:, :k]


def _global_ids(ids: torch.Tensor, offset: int) -> torch.Tensor:
    return torch.where(ids >= 0, ids + offset, -1)


def _local_n(n_valid: int, s: int, rps: int) -> int:
    return min(max(int(n_valid) - s * rps, 0), rps)


def sharded_flat_topk(
    mesh: meshmod.Mesh,
    queries: torch.Tensor,                       # [B, Dp] f32, any device
    vectors: Sequence[torch.Tensor],             # this process's row shards [Np / S, Dp]
    scales: Optional[Sequence[torch.Tensor]],    # their [Np / S] f32 scales (int8)
    n_valid: int,
    k: int,
    backend: str = "auto",
    shard_queries: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global exact top-k over a row-sharded store: shard s scans its rows
    with ``clip(n_valid - s * rps, 0, rps)`` valid, its ids shifted by
    ``s * rps``. With ``shard_queries`` the batch is split into the mesh's
    q blocks, block j scanned on each row's j-th device, and the blocks'
    results are concatenated. Returns [B, k] scores and global ids on
    ``mesh.first``."""
    rps = vectors[0].shape[0]
    n_q = mesh.shape[meshmod.QUERIES] if shard_queries else 1
    B = queries.shape[0]
    if B % n_q != 0:
        raise ValueError(f"{B} queries do not split into {n_q} query blocks")
    bq = B // n_q
    outs = []
    for j in range(n_q):
        q = queries[j * bq:(j + 1) * bq]
        pv, pi = [], []
        for li, s in enumerate(mesh.local_rows):
            dev = mesh.devices[li][j]
            v, i = dispatch.flat_topk(q.to(dev), vectors[li].to(dev),
                                      None if scales is None else scales[li].to(dev),
                                      _local_n(n_valid, s, rps), k, backend=backend)
            pv.append(v)
            pi.append(_global_ids(i, s * rps))
        outs.append(merge_partials(pv, pi, k, mesh))
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def sharded_lloyd_step(
    mesh: meshmod.Mesh,
    data: Sequence[torch.Tensor],   # this process's row shards [Np / S, Dp] f32
    centroids: torch.Tensor,        # [K, Dp] f32
    n_valid: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration over a row-sharded corpus: each shard's partial
    sums, counts and squared distances over its valid rows
    (``kmeans._lloyd_step``, on its device), summed over the shards, then
    the update (a centroid with no member keeps its place). Returns (the
    centroids [K, Dp], the mean squared distance over the ``n_valid`` rows)
    on ``mesh.first``. Padding rows count nowhere: the JAX package takes
    their counts off but leaves their squared distances in its objective
    (``ROADMAP.md`` queue 3)."""
    rps = data[0].shape[0]
    K, D = centroids.shape
    first = mesh.first
    sums = torch.zeros((K, D), dtype=torch.float32, device=first)
    counts = torch.zeros((K,), dtype=torch.float32, device=first)
    obj = torch.zeros((), dtype=torch.float32, device=first)
    cents = centroids.to(torch.float32)
    for li, s in enumerate(mesh.local_rows):
        x = data[li][:_local_n(n_valid, s, rps)].to(torch.float32)
        su, co, ob = kmeans._lloyd_step(x[None], cents.to(x.device)[None])
        sums += su[0].to(first)
        counts += co[0].to(first)
        obj += ob[0].to(first)
    sums, counts, obj = mesh.sum_rows(sums), mesh.sum_rows(counts), mesh.sum_rows(obj)
    new = sums / torch.clamp(counts, min=1.0)[:, None]
    cents = cents.to(first)
    return (torch.where(counts[:, None] > 0.5, new, cents),
            obj / float(max(int(n_valid), 1)))


class ShardedFlatIndex:
    """Exact flat index over a ``ShardedVectorStore``: the multi-device
    ``FlatIndex`` (each shard scanned by the flat kernel on its device)."""

    def __init__(self, store, mesh: Optional[meshmod.Mesh] = None, backend: str = "auto"):
        if backend not in dispatch.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.mesh = mesh if mesh is not None else store.mesh
        self.store = store
        self.backend = backend

    def search_device(self, queries: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Padded [B, Dp] f32 queries in; [B, k] scores and global ids on the
        mesh's first device out."""
        st = self.store
        return sharded_flat_topk(self.mesh, queries, st.vectors, st.scales, st.n, k,
                                 backend=self.backend)

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host queries [Q, d] in, host (scores [Q, k], ids [Q, k]) out."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        qp = torch.from_numpy(self.store.pad_queries(queries)).to(self.mesh.first)
        vals, ids = self.search_device(qp, k)
        return vals.cpu().numpy(), ids.cpu().numpy()


def per_shard(values, li: int, dev: torch.device) -> Optional[torch.Tensor]:
    """Row ``li``'s entry of a per-shard list on ``dev``; a single tensor
    (replicated) moved to ``dev``; None stays None."""
    if values is None:
        return None
    t = values if torch.is_tensor(values) else values[li]
    return t.to(dev)
