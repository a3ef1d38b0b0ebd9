"""Benchmark harness: warmup + timed query loops with the reference's
accounting (nvdb_bench.cpp:316-425).

Two modes, like the reference:
- per-query: each query timed individually (latency percentiles are per-query)
- batched: queries grouped into batch_q blocks; ONE latency sample per batch
  (batch-level percentiles, nvdb_bench.cpp:392-408).

``search_fn`` returns host arrays, so every timed span ends when the device
has finished: the copy back to the host waits for it.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np

from nvdb_tpu_torch.eval.stats import LatencyStats, compute_stats

# search_fn(queries_np [b, d], k) -> (scores_np, ids_np), host-synchronous
SearchFn = Callable[[np.ndarray, int], Tuple[np.ndarray, np.ndarray]]


def run_benchmark(
    search_fn: SearchFn,
    queries: np.ndarray,
    k: int,
    batch_q: int = 1,
    warmup: int = 2,
    bytes_per_query: Optional[float] = None,
) -> Tuple[np.ndarray, LatencyStats]:
    """Run all queries through ``search_fn``; returns (ids [Q, k], stats)."""
    Q = queries.shape[0]
    b = max(batch_q, 1)

    for w in range(min(warmup, max(Q // b, 1))):
        search_fn(queries[w * b:(w + 1) * b], k)

    ids_out = np.empty((Q, k), dtype=np.int64)
    lat_ms = []
    t_all0 = time.perf_counter()
    for s in range(0, Q, b):
        chunk = queries[s:s + b]
        t0 = time.perf_counter()
        _, ids = search_fn(chunk, k)
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        ids_out[s:s + chunk.shape[0]] = ids[: chunk.shape[0]]
    total_ms = (time.perf_counter() - t_all0) * 1e3

    stats = compute_stats(lat_ms, n_queries=Q, batch_q=b,
                          bytes_per_query=bytes_per_query, total_ms=total_ms)
    return ids_out, stats
