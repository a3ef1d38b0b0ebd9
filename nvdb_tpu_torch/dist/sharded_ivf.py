"""Sharded IVF-Flat, IVF-PQ and partition search, and the sharded refine
(the port of ``nvdb_tpu.dist.sharded_ivf``).

The inverted lists, their payload and their centroids are split over the
mesh's rows in contiguous blocks of ``nlist_pad / S`` lists (nlist padded
to a multiple of S with poisoned lists: centroid 1e3 in dim 0, ids -1,
zero payload). Each shard ranks its own centroids, probes
``max(1, min(ceil(nprobe / S), nlist_pad / S))`` of its lists with the
single-device block (``_ivf_search_block``, ``_ivfpq_search_block``: the
probe, table and ADC kernels on a card), and the [S, B, k] partials merge
into the global top-k. ``nprobe`` is the total over the shards, so the
probe set differs from the single-device one by design. A padded list has
no live slot: the coarse ranking masks it as dead (as the JAX package's
``_coarse_probes`` does), and the kernels read no row of it.

``sharded_refine`` reranks candidate ids over a row-sharded store: each
shard reranks the candidates whose rows it owns, by local id (-1 where
another shard owns the row), with the rerank kernel, and its winners go
back to global ids before the merge.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from nvdb_tpu_torch.dist import mesh as meshmod
from nvdb_tpu_torch.dist.sharded import _global_ids, merge_partials, per_shard
from nvdb_tpu_torch.index.ivf_flat import IVFFlatIndex, _ivf_search_block, coarse_terms
from nvdb_tpu_torch.index.ivf_pq import _ivfpq_search_block, _matmul
from nvdb_tpu_torch.kernels import adc_scan, dispatch
from nvdb_tpu_torch.store.store import ShardedVectorStore
from nvdb_tpu_torch.utils import cdiv, round_up

POISON = 1e3   # dim 0 of a padded list's centroid


def _pad_lists(arrays: Sequence[Tuple[str, torch.Tensor]], nlist: int, S: int
               ) -> List[Tuple[str, torch.Tensor]]:
    """Pad the list axis to a multiple of S: centroids poisoned (far from
    every query), slot ids -1, slot scales 1, payload zero."""
    nl_pad = round_up(nlist, S)
    if nl_pad == nlist:
        return list(arrays)
    out = []
    for name, a in arrays:
        shape = (nl_pad - nlist,) + tuple(a.shape[1:])
        if name == "centroids":
            pad = torch.zeros(shape, dtype=a.dtype, device=a.device)
            pad[:, 0] = POISON
        elif name == "slot_ids":
            pad = torch.full(shape, -1, dtype=a.dtype, device=a.device)
        elif name == "slot_scales":
            pad = torch.ones(shape, dtype=a.dtype, device=a.device)
        else:
            pad = torch.zeros(shape, dtype=a.dtype, device=a.device)
        out.append((name, torch.cat([a, pad])))
    return out


def _split_lists(arrays, nlist: int, mesh: meshmod.Mesh) -> dict:
    """Pad the list axis for the mesh and give each of this process's rows
    its contiguous block (a view on the index's own device)."""
    padded = _pad_lists(arrays, nlist, mesh.shape[meshmod.ROWS])
    return {name: meshmod.shard_rows(a, mesh) for name, a in padded}


def _per_shard_lists(lists: List[torch.Tensor], n_rows: int) -> int:
    return lists[0].shape[0] * n_rows


def _row_sharded_over(store, mesh: meshmod.Mesh) -> bool:
    """True if ``store`` is row-sharded over this mesh's rows (the refine
    then runs sharded: no device holds the whole store)."""
    return (isinstance(store, ShardedVectorStore)
            and store.mesh.shape[meshmod.ROWS] == mesh.shape[meshmod.ROWS]
            and store.mesh.local_rows == mesh.local_rows)


def _probes_per_shard(nprobe: int, nlist: int, S: int) -> int:
    return max(1, min(cdiv(nprobe, S), nlist // S))


def _pad_host_queries(queries: np.ndarray, d: int, dp: int) -> np.ndarray:
    queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
    qp = np.zeros((queries.shape[0], dp), np.float32)
    qp[:, :d] = queries[:, :d]
    return qp


def _host_search(fn, queries: np.ndarray, d: int, dp: int, k: int, q_chunk: int,
                 device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """Host queries through ``fn`` (a ``search_device``) ``q_chunk`` at a time."""
    qp = _pad_host_queries(queries, d, dp)
    qn = qp.shape[0]
    vals = np.empty((qn, k), np.float32)
    ids = np.empty((qn, k), np.int64)
    for s in range(0, qn, q_chunk):
        v, i = fn(torch.from_numpy(qp[s:s + q_chunk]).to(device))
        vals[s:s + q_chunk] = v.cpu().numpy()
        ids[s:s + q_chunk] = i.cpu().numpy()
    return vals, ids


class ShardedIVFFlatIndex:
    """IVF-Flat with its lists (centroids, packed payload, slot ids and
    scales) split over the mesh's rows; each field is a list, one tensor
    per row this process holds."""

    def __init__(self, mesh: meshmod.Mesh, centroids, packed, slot_ids, slot_scales,
                 n: int, d: int):
        self.mesh = mesh
        self.centroids = centroids
        self.packed = packed
        self.slot_ids = slot_ids
        self.slot_scales = slot_scales
        self.n = n
        self.d = d
        self._fills = [None] * len(slot_ids)
        self._coarse = [None] * len(slot_ids)

    @property
    def nlist(self) -> int:
        """Lists of all shards together, padding included."""
        return _per_shard_lists(self.centroids, self.mesh.shape[meshmod.ROWS])

    @property
    def lcap(self) -> int:
        return self.packed[0].shape[1]

    @property
    def d_padded(self) -> int:
        return self.centroids[0].shape[1]

    @property
    def index_bytes(self) -> int:
        p = self.packed[0]
        per_list = self.lcap * (p.shape[2] * p.element_size() + 4) + self.d_padded * 4
        if self.slot_scales is not None:
            per_list += self.lcap * 4
        return self.nlist * per_list

    def fills(self, li: int) -> torch.Tensor:
        """Row ``li``'s cached list fills (``adc_scan.list_fills``)."""
        if self._fills[li] is None:
            self._fills[li] = adc_scan.list_fills(self.slot_ids[li])
        return self._fills[li]

    def coarse_terms(self, li: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Row ``li``'s cached coarse-ranking terms (a padded list is dead)."""
        if self._coarse[li] is None:
            self._coarse[li] = coarse_terms(self.centroids[li], self.slot_ids[li])
        return self._coarse[li]

    @classmethod
    def from_index(cls, ivf: IVFFlatIndex, mesh: Optional[meshmod.Mesh] = None
                   ) -> "ShardedIVFFlatIndex":
        """Split a built single-device index over the mesh (default: every
        visible card)."""
        mesh = mesh if mesh is not None else meshmod.row_mesh()
        arrays = [("centroids", ivf.centroids), ("packed", ivf.packed),
                  ("slot_ids", ivf.slot_ids)]
        if ivf.slot_scales is not None:
            arrays.append(("slot_scales", ivf.slot_scales))
        parts = _split_lists(arrays, ivf.nlist, mesh)
        return cls(mesh, parts["centroids"], parts["packed"], parts["slot_ids"],
                   parts.get("slot_scales"), ivf.n, ivf.d)

    def search_device(self, queries: torch.Tensor, k: int, nprobe: int,
                      backend: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
        """Padded [B, Dp] f32 queries in, [B, k] scores and ids on the mesh's
        first device out. ``nprobe`` is the total over the shards."""
        per = _probes_per_shard(nprobe, self.nlist, self.mesh.shape[meshmod.ROWS])
        pv, pi = [], []
        for li in range(len(self.packed)):
            dev = self.packed[li].device
            v, i = _ivf_search_block(queries.to(dev), self.centroids[li], self.packed[li],
                                     self.slot_ids[li], per_shard(self.slot_scales, li, dev),
                                     k, per, backend=backend, fills=self.fills(li),
                                     terms=self.coarse_terms(li))
            pv.append(v)
            pi.append(i)
        return merge_partials(pv, pi, k, self.mesh)

    def search(self, queries: np.ndarray, k: int, nprobe: int, q_chunk: int = 32,
               backend: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        """Host queries [Q, d] in, host (scores, ids) out."""
        return _host_search(lambda q: self.search_device(q, k, nprobe, backend=backend),
                            queries, self.d, self.d_padded, k, q_chunk, self.mesh.first)


def sharded_refine(
    mesh: meshmod.Mesh,
    queries: torch.Tensor,                      # [B, Dp] f32
    cand_ids: torch.Tensor,                     # [B, R] global ids (-1 padded)
    vectors: Sequence[torch.Tensor],            # this process's row shards
    scales: Optional[Sequence[torch.Tensor]],   # their scales (int8)
    k: int,
    metric: str = "l2",
    backend: str = "auto",
    norms2: Optional[Sequence[torch.Tensor]] = None,     # each shard's (store.norms2())
    res_cents=None,    # residual-int8: [nlist, Dp] f32, or one per shard
    res_ids: Optional[Sequence[torch.Tensor]] = None,    # residual-int8: each shard's
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact rerank over a row-sharded store: shard s reranks, on its device
    and through ``dispatch.exact_refine`` (the rerank kernel on a card), the
    candidates in its rows by local id, -1 elsewhere; its top min(k, R)
    return to global ids and the partials merge. Candidate ids are unique,
    so the merge needs no dedup. Pass the store's ``norms2`` in serving
    loops (l2; a residual store needs them); queries scoring a residual
    store live in its centroids' space."""
    if res_cents is not None and res_ids is None:
        raise ValueError("res_cents requires res_ids")
    rps = vectors[0].shape[0]
    kk = min(k, cand_ids.shape[1])
    pv, pi = [], []
    for li, s in enumerate(mesh.local_rows):
        dev = vectors[li].device
        cid = cand_ids.to(dev)
        lid = cid - s * rps
        own = (cid >= 0) & (lid >= 0) & (lid < rps)
        v, i = dispatch.exact_refine(
            queries.to(dev), torch.where(own, lid, -1).to(torch.int32), vectors[li],
            per_shard(scales, li, dev), kk, metric=metric,
            norms2=per_shard(norms2, li, dev), backend=backend,
            res_cents=per_shard(res_cents, li, dev), res_ids=per_shard(res_ids, li, dev))
        pv.append(v)
        pi.append(_global_ids(i, s * rps))
    return merge_partials(pv, pi, k, mesh)


def _refine(mesh: meshmod.Mesh, queries: torch.Tensor, cand: torch.Tensor, store, k: int,
            metric: str, backend: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact refine of merged candidates against ``store``: sharded
    when it is row-sharded over ``mesh``, on its own device otherwise. The
    store's norms go in wherever a kernel or its plain version scores l2."""
    sharded = _row_sharded_over(store, mesh)
    first = store.vectors[0] if sharded else store.vectors
    norms2 = (store.norms2()
              if metric == "l2" and dispatch.refine_path(backend, first) != "oracle"
              else None)
    res = dict(res_cents=store.res_cents, res_ids=store.res_ids)
    if sharded:
        return sharded_refine(mesh, queries, cand, store.vectors, store.scales, k,
                              metric=metric, backend=backend, norms2=norms2, **res)
    dev = store.device
    v, i = dispatch.exact_refine(queries.to(dev), cand.to(dev), store.vectors, store.scales,
                                 k, metric=metric, norms2=norms2, backend=backend, **res)
    return v.to(mesh.first), i.to(mesh.first)


class ShardedIVFPQIndex:
    """IVF-PQ with its lists (centroids, codes, slot ids) split over the
    mesh's rows, the rotation and codebooks whole on every shard's device.
    Each shard scores its probed lists by ADC (on a card the fused scans,
    which build the tables in shared memory: the key scan in the id mode of
    ``ids_mode()`` for refine candidates, the dma scan otherwise); the merged
    candidates are refined after the merge, sharded when the refine store is
    row-sharded over the same mesh."""

    def __init__(self, mesh: meshmod.Mesh, rotation: Optional[torch.Tensor], centroids,
                 codebooks, codes, slot_ids, n: int, d: int, m: int, replicas: int = 1):
        self.mesh = mesh
        self.rotation = rotation      # [Dp, Dp] on mesh.first, or None
        self.centroids = centroids    # per row: [nlist_pad / S, Dp]
        self.codebooks = codebooks    # per row: [M, 256, dsub]
        self.codes = codes            # per row: [nlist_pad / S, M, Lcap]
        self.slot_ids = slot_ids      # per row: [nlist_pad / S, Lcap]
        self.n = n
        self.d = d
        self.m = m
        self.replicas = replicas      # > 1: a row in several lists (dedup merge)
        self._fills = [None] * len(codes)
        self._coarse = [None] * len(codes)
        self._ids_mode = None

    @property
    def nlist(self) -> int:
        return _per_shard_lists(self.centroids, self.mesh.shape[meshmod.ROWS])

    @property
    def lcap(self) -> int:
        return self.codes[0].shape[2]

    @property
    def d_padded(self) -> int:
        return self.centroids[0].shape[1]

    @property
    def index_bytes(self) -> int:
        b = self.nlist * (self.m * self.lcap + self.lcap * 4 + self.d_padded * 4)
        b += self.codebooks[0].numel() * 4
        if self.rotation is not None:
            b += self.rotation.numel() * 4
        return b

    def fills(self, li: int) -> torch.Tensor:
        if self._fills[li] is None:
            self._fills[li] = adc_scan.list_fills(self.slot_ids[li])
        return self._fills[li]

    def coarse_terms(self, li: int) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._coarse[li] is None:
            self._coarse[li] = coarse_terms(self.centroids[li], self.slot_ids[li])
        return self._coarse[li]

    @classmethod
    def from_index(cls, pq_idx, mesh: Optional[meshmod.Mesh] = None) -> "ShardedIVFPQIndex":
        mesh = mesh if mesh is not None else meshmod.row_mesh()
        parts = _split_lists([("centroids", pq_idx.centroids), ("codes", pq_idx.codes),
                              ("slot_ids", pq_idx.slot_ids)], pq_idx.nlist, mesh)
        rot = None if pq_idx.rotation is None else pq_idx.rotation.to(mesh.first)
        return cls(mesh, rot, parts["centroids"], meshmod.replicate(pq_idx.codebooks, mesh),
                   parts["codes"], parts["slot_ids"], pq_idx.n, pq_idx.d, pq_idx.m,
                   replicas=pq_idx.replicas)

    def ids_mode(self) -> str:
        """'key' when every shard's lists are prefix-packed and ids are unique
        (replicas == 1; a padded list has no live slot, so it is trivially
        prefix-packed), else 'dma'. Checked once, cached."""
        if self._ids_mode is None:
            ok = self.replicas <= 1 and all(adc_scan.is_prefix_packed(s)
                                            for s in self.slot_ids)
            self._ids_mode = "key" if ok else "dma"
        return self._ids_mode

    def search_device(self, queries: torch.Tensor, k: int, nprobe: int,
                      refine_k: int = 0, refine_store=None, backend: str = "auto",
                      for_refine: bool = False, refine_metric: str = "l2"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Padded [B, Dp] f32 queries in, [B, k] scores and ids on the mesh's
        first device out. ``nprobe`` is the total over the shards. The
        queries are rotated once, before the shards; refine candidates
        (``refine_k > 0`` or ``for_refine``) come from ``ids_mode()``, ADC
        results from the dma mode, as in ``IVFPQIndex.search_device``."""
        S = self.mesh.shape[meshmod.ROWS]
        per = _probes_per_shard(nprobe, self.nlist, S)
        if refine_k > 0:
            refine_k = max(refine_k, k)
        kk = max(k, refine_k)
        queries = queries.to(self.mesh.first)
        q_rot = _matmul(queries, self.rotation) if self.rotation is not None else queries
        mode = self.ids_mode() if (refine_k > 0 or for_refine) else "dma"
        pv, pi = [], []
        for li in range(len(self.codes)):
            dev = self.codes[li].device
            cuda = dispatch.refine_backend(backend, self.codes[li]) == "cuda"
            v, i = _ivfpq_search_block(q_rot.to(dev), self.centroids[li], self.codebooks[li],
                                       self.codes[li], self.slot_ids[li], kk, per, self.m,
                                       backend=backend, dedup=self.replicas,
                                       fills=self.fills(li) if cuda else None,
                                       terms=self.coarse_terms(li), ids_mode=mode)
            dispatch.check_finite(f"IVF-PQ ADC candidate scores (shard {li})", v, i)
            pv.append(v)
            pi.append(i)
        # a replicated row's copies can surface from several shards
        width = min(self.replicas * kk, S * kk) if self.replicas > 1 else 0
        v, i = merge_partials(pv, pi, kk, self.mesh, dedup_width=width)
        if refine_k > 0:
            if refine_store is None:
                raise ValueError("refine_k > 0 requires refine_store")
            # a residual-int8 store dequantizes against the rotated centroids
            rq = q_rot if refine_store.is_residual else queries
            v, i = _refine(self.mesh, rq, i[:, :refine_k], refine_store, k, refine_metric,
                           backend)
        return v[:, :k], i[:, :k]

    def search(self, queries: np.ndarray, k: int, nprobe: int, refine_k: int = 0,
               refine_store=None, q_chunk: int = 256, backend: str = "auto"
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Host queries [Q, d] in, host (scores, ids) out."""
        return _host_search(
            lambda q: self.search_device(q, k, nprobe, refine_k=refine_k,
                                         refine_store=refine_store, backend=backend),
            queries, self.d, self.d_padded, k, q_chunk, self.mesh.first)


class ShardedPartitionIndex:
    """The partition-then-rerank index over the mesh: its partitions split
    like IVF-Flat, the exact rerank (metric dot) of the merged candidates
    against the refine store after the merge, sharded when the store is
    row-sharded over the same mesh. A residual-int8 refine store is scored
    with its centroids, as ``PartitionRerankIndex`` scores it."""

    def __init__(self, ivf: ShardedIVFFlatIndex, refine_store=None):
        self.ivf = ivf
        self.refine_store = refine_store

    @classmethod
    def from_index(cls, pr, mesh: Optional[meshmod.Mesh] = None) -> "ShardedPartitionIndex":
        """``pr``: a ``PartitionRerankIndex``; its refine store is kept as it is."""
        return cls(ShardedIVFFlatIndex.from_index(pr.ivf, mesh), pr.refine_store)

    @property
    def n(self) -> int:
        return self.ivf.n

    @property
    def nlist(self) -> int:
        return self.ivf.nlist

    @property
    def lcap(self) -> int:
        return self.ivf.lcap

    @property
    def d(self) -> int:
        return self.ivf.d

    @property
    def index_bytes(self) -> int:
        return self.ivf.index_bytes

    def search_device(self, queries: torch.Tensor, k: int, nprobe: int, rerank_k: int = 0,
                      backend: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
        """Padded [B, Dp] queries in, [B, k] scores and ids out: the probe and,
        when ``rerank_k > k``, the rerank of its top ``rerank_k``."""
        if rerank_k <= k or self.refine_store is None:
            v, i = self.ivf.search_device(queries, k, nprobe, backend=backend)
            return v[:, :k], i[:, :k]
        _, cid = self.ivf.search_device(queries, rerank_k, nprobe, backend=backend)
        return _refine(self.ivf.mesh, queries, cid, self.refine_store, k, "dot", backend)

    def search(self, queries: np.ndarray, k: int, nprobe: int, rerank_k: int = 0,
               q_chunk: int = 32, backend: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        """Host queries [Q, d] in, host (scores, ids) out."""
        return _host_search(
            lambda q: self.search_device(q, k, nprobe, rerank_k=rerank_k, backend=backend),
            queries, self.d, self.ivf.d_padded, k, q_chunk, self.ivf.mesh.first)
