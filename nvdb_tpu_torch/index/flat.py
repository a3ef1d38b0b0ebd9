"""Exact flat-scan index (the port of ``nvdb_tpu.index.flat``).

B queries share one stream of the base. A batch runs at its own size: the
JAX package's power-of-two batch buckets, which only bound jit recompiles,
are not needed. On the card ``search_device`` captures its chain once a
shape in a CUDA graph and replays it (``index/graphs.py``).
"""

from __future__ import annotations

import sys
import time
from typing import Tuple

import numpy as np
import torch

from nvdb_tpu_torch.eval import trace
from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.index import graphs
from nvdb_tpu_torch.kernels import dispatch, ops
from nvdb_tpu_torch.store import VectorStore
from nvdb_tpu_torch.utils import round_up


def quantize_queries_i8(queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 query quantization (max-abs / 127, round half
    to even, clamp to ±127), the same f32 arithmetic as ``nvdb_tpu``'s
    ``FlatIndex`` quantize mode."""
    amax = queries.abs().amax(dim=1)
    qs = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q8 = torch.clamp(torch.round(queries / qs[:, None]), -127, 127).to(torch.int8)
    return q8, qs


class FlatIndex:
    """Exact top-k search over a :class:`VectorStore` by dot product.

    ``quantize_queries`` (int8 stores only): quantize queries to int8 per row
    and score int8 x int8 with exact int32 sums — query-side quantization
    noise traded for half the operand bytes (opt-in).

    ``refine_k`` (with ``quantize_queries``): the exact-i8 mode. The int8 x
    int8 scan returns its top ``max(refine_k, k)``, then the exact rerank
    (``dispatch.exact_refine``, metric dot) re-scores those candidates with
    the original f32 queries, restoring the f32-query ranking. Ignored
    unless the index is in quantize mode, as in ``nvdb_tpu``."""

    def __init__(self, store: VectorStore, backend: str = "auto",
                 quantize_queries: bool = False, refine_k: int = 0,
                 metric: str = "dot"):
        if metric not in ("dot", "l2"):
            raise ValueError(f"unknown metric {metric!r}")
        if backend not in dispatch.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.store = store
        self.backend = backend
        self.metric = metric
        self.quantize_queries = (quantize_queries and metric == "dot"
                                 and store.dtype_code == vecbin.DTYPE_I8)
        self.refine_k = refine_k if self.quantize_queries else 0
        self._graphs = graphs.GraphCache()

    def search_device(self, queries: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """queries [B, Dp] f32, already padded and on the store's device;
        returns device tensors (scores [B, k] f32, ids [B, k] int32). On the
        card, with every stage on its kernel (metric dot), the chain is
        captured once a shape in a CUDA graph and replayed, bit for bit the
        eager call (``index/graphs.py``); a replayed index serves one CUDA
        stream at a time."""
        with trace.span("flat.search", b=queries.shape[0], k=k) as root:
            chain = lambda q: self._search_chain(q, k)
            if graphs.engages(queries, self._paths()):
                return self._graphs.run(root, self._graph_parts(k), queries, chain)
            return graphs.eager(root, chain, queries)

    def _paths(self) -> list:
        """The path each stage of a call resolves to: the scan's (metric l2
        runs the plain ops on any device, ``dispatch.flat_topk``), then the
        exact refine's in the exact-i8 mode."""
        vectors = self.store.vectors
        paths = [dispatch.refine_backend(self.backend, vectors)
                 if self.metric == "dot" else "torch"]
        if self.refine_k:
            paths.append(dispatch.refine_path(self.backend, vectors))
        return paths

    def _graph_parts(self, k: int) -> tuple:
        """What a served call's chain depends on besides its batch: its
        scalars (the store is the index's own)."""
        return (k, self.backend, self.metric, self.quantize_queries, self.refine_k)

    def _search_chain(self, queries: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The device work of ``search_device``: the scan (in quantize mode
        the queries' int8 quantization first and the exact refine after)."""
        st = self.store
        if self.quantize_queries:
            q8, qs = quantize_queries_i8(queries)
            kk = max(self.refine_k, k) if self.refine_k else k
            v, i = dispatch.flat_topk(q8, st.vectors, st.scales, st.n, kk,
                                      backend=self.backend, query_scales=qs)
            if self.refine_k:
                v, i = dispatch.exact_refine(queries, i, st.vectors, st.scales, k,
                                             metric="dot", backend=self.backend)
            return v, i
        return dispatch.flat_topk(queries, st.vectors, st.scales, st.n, k,
                                  backend=self.backend, metric=self.metric)

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """queries [Q, d] f32 on host -> (scores [Q, k] f32, ids [Q, k] int32)
        on host. Copying the result back waits for the device."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        qp = torch.from_numpy(self.store.pad_queries(queries)).to(self.store.device)
        vals, ids = self.search_device(qp, k)
        return vals.cpu().numpy(), ids.cpu().numpy()

    def warmup(self, batch_sizes=(8,), k: int = 10) -> None:
        """Run the scan once per batch size: builds and loads the kernel
        library before any timed call (the reference's warmup loops,
        nvdb_bench.cpp:317-322)."""
        for b in batch_sizes:
            self.search(np.zeros((b, self.store.d), dtype=np.float32), k)


def build_ground_truth(
    store: VectorStore, queries: np.ndarray, k: int, batch: int = 256,
    backend: str = "auto", metric: str = "dot",
) -> np.ndarray:
    """Exact top-k ids for all queries — the nvdb_gt_build core
    (nvdb_gt_build.cpp:74-127). Returns uint32 ids [Q, k]."""
    idx = FlatIndex(store, backend=backend, metric=metric)
    out = []
    for s in range(0, queries.shape[0], batch):
        _, ids = idx.search(queries[s: s + batch], k)
        out.append(ids)
    return np.concatenate(out, axis=0).astype(np.uint32)


def build_ground_truth_chunked(
    path: str, queries: np.ndarray, k: int, batch: int = 256,
    row_chunk: int = 1_000_000, verbose: bool = False, metric: str = "dot",
    *, device,
) -> np.ndarray:
    """Exact f32 ground truth for a corpus larger than device memory: stream
    row chunks (mmap slice -> device), scan each against all query batches
    with the plain f32 ops (TF32 off), and k-merge the per-chunk winners on
    the host. Peak device memory is one chunk. ``verbose`` prints per-chunk
    progress to stderr."""
    f = vecbin.VecbinFile(path)
    Q, d = queries.shape
    dp = round_up(d, 128)
    qpad = np.zeros((Q, dp), np.float32)
    qpad[:, :d] = queries
    qdev = torch.from_numpy(qpad).to(device)

    all_v: list[np.ndarray] = []
    all_i: list[np.ndarray] = []
    t0 = time.perf_counter()
    for c0 in range(0, f.count, row_chunk):
        c1 = min(c0 + row_chunk, f.count)
        if verbose:
            print(f"[gt +{time.perf_counter() - t0:6.1f}s] chunk "
                  f"{c0}..{c1} of {f.count}", file=sys.stderr, flush=True)
        n = c1 - c0
        block = np.zeros((round_up(n, 1024), dp), np.float32)
        block[:n, :d] = f.rows_f32(c0, c1)
        dev = torch.from_numpy(block).to(device)
        del block
        cv = np.empty((Q, k), np.float32)
        ci = np.empty((Q, k), np.int64)
        for s in range(0, Q, batch):
            v, i = ops.scan_topk(qdev[s:s + batch], dev, None, n, k, metric=metric)
            i = i.cpu().numpy().astype(np.int64)
            cv[s:s + batch] = v.cpu().numpy()
            ci[s:s + batch] = np.where(i >= 0, i + c0, -1)
        all_v.append(cv)
        all_i.append(ci)
        del dev
    vs = np.concatenate(all_v, axis=1)               # [Q, n_chunks*k]
    isel = np.concatenate(all_i, axis=1)
    order = np.argsort(-vs, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(isel, order, axis=1).astype(np.uint32)
