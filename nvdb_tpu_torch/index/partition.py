"""Partition-then-rerank index (the port of ``nvdb_tpu.index.partition``),
the package's replacement for an HNSW graph: a balanced k-means partition
with the IVF-Flat layout (bf16 payload by default) probed with exact
scoring, then an optional exact rerank of the top candidates against a
refine store (f32, or residual-int8 against the partition centroids).

On a CUDA index the probe runs the ``ivf_probe_topk`` kernel and the rerank
the ``rerank_topk`` kernel. ``backend`` reaches both: ``auto`` takes the
kernels on a CUDA index (also from the host ``search``, where the JAX
package calls its jnp probe) and the JAX package's jnp paths on the CPU;
``torch`` the kernels' plain versions; ``cuda`` the kernels or an error.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from nvdb_tpu_torch.eval import trace
from nvdb_tpu_torch.eval.recall import recall_at_k
from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.index import graphs
from nvdb_tpu_torch.index.ivf_flat import IVFFlatIndex
from nvdb_tpu_torch.kernels import dispatch
from nvdb_tpu_torch.store import VectorStore


def auto_nlist(n: int) -> int:
    """The sqrt-scaled partition count: 2^round(log2(2 sqrt(n))), clamped to
    [16, 8192] (2048 at 1M rows)."""
    return int(np.clip(2 ** int(np.round(np.log2(np.sqrt(n) * 2))), 16, 8192))


@dataclasses.dataclass
class PartitionRerankIndex:
    ivf: IVFFlatIndex
    refine_store: Optional[VectorStore]   # exact store for the rerank
    _graphs: graphs.GraphCache = dataclasses.field(
        default_factory=graphs.GraphCache, init=False, repr=False, compare=False)

    @property
    def n(self) -> int:
        return self.ivf.n

    @property
    def index_bytes(self) -> int:
        """The self-contained search structure (packed payload, ids,
        centroids); the refine store is not counted, as in the JAX
        package (it is shared deployment state, like the base file)."""
        return self.ivf.index_bytes

    def coarse_terms(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The partition's cached coarse-ranking terms (``IVFFlatIndex.coarse_terms``);
        every search of this index ranks its probes with them."""
        return self.ivf.coarse_terms()

    @classmethod
    def build(
        cls,
        rows_f32: np.ndarray,
        nlist: Optional[int] = None,
        dtype: str = "bf16",
        with_refine: bool = True,
        train_size: int = 100_000,
        n_iters: int = 10,
        pad_factor: float = 2.0,
        spill_candidates: int = 8,
        seed: int = 0,
        refine_dtype: str = "f32",     # "f32" | "res_i8"
        *,
        device,
    ) -> "PartitionRerankIndex":
        if refine_dtype not in ("f32", "res_i8"):
            raise ValueError(f"unknown refine_dtype {refine_dtype!r}")
        if nlist is None:
            nlist = auto_nlist(rows_f32.shape[0])
        ivf = IVFFlatIndex.build(rows_f32, nlist=nlist, dtype=dtype, train_size=train_size,
                                 n_iters=n_iters, pad_factor=pad_factor,
                                 spill_candidates=spill_candidates, seed=seed,
                                 device=device)
        store = None
        if with_refine and refine_dtype == "res_i8":
            store = cls._residual_store(rows_f32, ivf)
        elif with_refine:
            store = VectorStore.from_numpy(rows_f32, "f32", device=device)
        return cls(ivf=ivf, refine_store=store)

    @staticmethod
    def _residual_store(rows_f32: np.ndarray, ivf: IVFFlatIndex) -> VectorStore:
        """Residual-int8 refine store against the index's own partition
        centroids: each row's int8 codes encode row - cent[its list], whose
        range is narrower than the row's on clustered corpora, so one byte
        per dim ranks finer than plain int8, at a quarter of the f32
        store's bytes."""
        n = rows_f32.shape[0]
        sids = ivf.slot_ids.cpu().numpy()
        li, si = np.nonzero(sids >= 0)
        list_of = np.zeros(n, np.int32)
        list_of[sids[li, si]] = li.astype(np.int32)
        cents = ivf.centroids.cpu().numpy().astype(np.float32)   # [nlist, Dp]
        dp = cents.shape[1]
        if rows_f32.shape[1] != dp:
            rows_f32 = np.pad(rows_f32, ((0, 0), (0, dp - rows_f32.shape[1])))
        codes, sc = vecbin.quantize_i8(rows_f32 - cents[list_of])
        store = VectorStore.from_numpy(codes, "i8", scales=sc, device=ivf.device)
        return store.attach_residual(cents, list_of)

    @classmethod
    def from_reference(cls, ivf: dict, refine: Optional[dict] = None, *,
                       device) -> "PartitionRerankIndex":
        """Carry an index across from ``nvdb_tpu``: ``ivf`` holds the
        arguments of ``IVFFlatIndex.from_reference``, ``refine`` (optional)
        those of ``VectorStore.from_reference`` plus, for a residual store,
        ``res_cents`` and ``res_ids`` (``np.asarray`` of the JAX store's)."""
        store = None
        if refine is not None:
            refine = dict(refine)
            res_cents, res_ids = refine.pop("res_cents", None), refine.pop("res_ids", None)
            store = VectorStore.from_reference(**refine, device=device)
            if res_cents is not None:
                store.attach_residual(np.asarray(res_cents, np.float32),
                                      np.asarray(res_ids, np.int32))
        return cls(ivf=IVFFlatIndex.from_reference(**ivf, device=device),
                   refine_store=store)

    def search(self, queries: np.ndarray, k: int, nprobe: int, rerank_k: int = 0,
               backend: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        """rerank_k > k: take the top rerank_k candidates of the probe and
        rerank them exactly against the refine store (metric dot, the
        ground-truth convention)."""
        if rerank_k <= k:
            return self.ivf.search(queries, k, nprobe, backend=backend)
        vals, ids = self.ivf.search(queries, rerank_k, nprobe, backend=backend)
        store = self.refine_store
        if store is None:
            return vals[:, :k], ids[:, :k]
        q = torch.from_numpy(store.pad_queries(np.atleast_2d(queries))).to(store.device)
        cid = torch.from_numpy(ids.astype(np.int32)).to(store.device)
        rv, ri = dispatch.exact_refine(q, cid, store.vectors, store.scales, k, metric="dot",
                                       backend=backend, res_cents=store.res_cents,
                                       res_ids=store.res_ids)
        return rv.cpu().numpy(), ri.cpu().numpy()

    def search_device(self, queries: torch.Tensor, k: int, nprobe: int,
                      rerank_k: int = 0, backend: str = "auto"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Padded [B, Dp] on-device queries in, device tensors out: probe and
        optional exact rerank chained on the device, no host sync. On the
        card, with every stage on its kernel, the chain is captured once a
        shape in a CUDA graph and replayed (``index/graphs.py``); a replayed
        index serves one CUDA stream at a time."""
        with trace.span("partition.search", b=queries.shape[0], k=k, nprobe=nprobe,
                        rerank_k=rerank_k) as root:
            store = self.refine_store if rerank_k > k else None
            chain = lambda q: self._search_chain(q, k, nprobe, rerank_k, store, backend)
            paths = [dispatch.refine_backend(backend, self.ivf.packed)]
            if store is not None:
                paths.append(dispatch.refine_path(backend, store.vectors))
            if graphs.engages(queries, paths):
                return self._graphs.run(root, self._graph_parts(k, nprobe, rerank_k, store),
                                        queries, chain)
            return graphs.eager(root, chain, queries)

    def _graph_parts(self, k: int, nprobe: int, rerank_k: int,
                     store: Optional[VectorStore]) -> tuple:
        """What a served call's chain depends on besides its batch: its
        scalars, the IVF-Flat index it probes, and the rerank store with its
        tensors (``store``: None where no rerank runs)."""
        rerank = (0,) if store is None else (rerank_k, store, store.vectors, store.scales,
                                             store.res_cents, store.res_ids)
        return (k, min(nprobe, self.ivf.nlist), self.ivf) + rerank

    def _search_chain(self, queries: torch.Tensor, k: int, nprobe: int, rerank_k: int,
                      store: Optional[VectorStore], backend: str
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The device work of ``search_device``: the probe, then the rerank
        against ``store`` (None: the probe's top k alone)."""
        if store is None:
            return self.ivf.search_device(queries, k, nprobe, backend=backend)
        _, cid = self.ivf.search_device(queries, rerank_k, nprobe, backend=backend)
        return dispatch.exact_refine(queries, cid, store.vectors, store.scales, k,
                                     metric="dot", backend=backend,
                                     res_cents=store.res_cents, res_ids=store.res_ids)

    def save(self, path: str) -> None:
        """Persist the self-contained search structure (the IVF-Flat
        ``.npz``). The refine store is rebuilt from the base vecbin at load
        time."""
        self.ivf.save(path)

    @classmethod
    def load(cls, path: str, refine_rows: Optional[np.ndarray] = None, *,
             device) -> "PartitionRerankIndex":
        ivf = IVFFlatIndex.load(path, device=device)
        store = (VectorStore.from_numpy(refine_rows, "f32", device=device)
                 if refine_rows is not None else None)
        return cls(ivf=ivf, refine_store=store)

    def tune_nprobe(self, queries_val: np.ndarray, gt_val: np.ndarray, k: int,
                    target_recall: float = 0.98,
                    candidates=(1, 2, 4, 8, 16, 32, 64, 128, 256),
                    backend: str = "auto") -> int:
        """Smallest nprobe whose recall (probe only, no rerank) on the
        validation set reaches the target."""
        for np_ in candidates:
            if np_ > self.ivf.nlist:
                break
            _, ids = self.search(queries_val, k, np_, backend=backend)
            if recall_at_k(ids, gt_val, k=k) >= target_recall:
                return np_
        return min(self.ivf.nlist, candidates[-1])
