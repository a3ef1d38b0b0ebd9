"""Latency statistics and machine-parsable result lines.

Reproduces the reference's metric vocabulary exactly: interpolated percentiles
(``pos = p/100 * (n-1)``, linear interpolation between floor/ceil samples,
nvdb_bench.cpp:370-377), Total/Avg/QPS, batch-level percentiles when query
batching is on (nvdb_bench.cpp:392-408), ``bytes_per_query`` /
``payload_equiv_bandwidth_GBps`` derived metrics (nvdb_bench.cpp:414-425), and
the single-line ``RESULT key=value ...`` record (nvdb_ivf_eval.cpp:729-779)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


def percentile(sorted_vals: Sequence[float], p: float) -> float:
    """Interpolated percentile over pre-sorted samples — the reference's pct()
    (nvdb_bench.cpp:370-377)."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    pos = (p / 100.0) * (n - 1)
    i0 = int(pos)
    i1 = min(i0 + 1, n - 1)
    frac = pos - i0
    return sorted_vals[i0] * (1.0 - frac) + sorted_vals[i1] * frac


@dataclasses.dataclass
class LatencyStats:
    total_ms: float
    n_queries: int
    n_samples: int          # per-query samples, or batch samples when batching
    avg_ms: float           # per query
    qps: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    batch_q: int = 1
    avg_batch_ms: Optional[float] = None
    bytes_per_query: Optional[float] = None
    bandwidth_gbps: Optional[float] = None

    def render(self) -> str:
        """Human-readable block in the reference's format (nvdb_bench.cpp:388-425)."""
        lines = [
            f"Total:     {self.total_ms:.3f} ms",
            f"Avg_query: {self.avg_ms:.3f} ms/query  ({self.qps:.3f} QPS)",
        ]
        tag = "batch_p" if self.batch_q > 1 else "p"
        if self.batch_q > 1:
            lines.insert(0, f"batch_samples={self.n_samples}")
            bps = 1000.0 * self.n_samples / self.total_ms if self.total_ms else 0.0
            lines.append(f"Avg_batch: {self.avg_batch_ms:.3f} ms/batch  ({bps:.3f} batches/s)")
        lines += [
            f"{tag}50: {self.p50_ms:.3f} ms",
            f"{tag}95: {self.p95_ms:.3f} ms",
            f"{tag}99: {self.p99_ms:.3f} ms",
        ]
        if self.bytes_per_query is not None:
            lines.append(f"bytes_per_query={self.bytes_per_query:.0f}")
            lines.append(f"payload_equiv_bandwidth_GBps={self.bandwidth_gbps:.3f}")
        return "\n".join(lines)


def compute_stats(
    lat_ms: Sequence[float],
    n_queries: int,
    batch_q: int = 1,
    bytes_per_query: Optional[float] = None,
    total_ms: Optional[float] = None,
) -> LatencyStats:
    """``lat_ms`` holds per-query samples (batch_q==1) or per-batch samples."""
    s = sorted(lat_ms)
    total = total_ms if total_ms is not None else float(sum(lat_ms))
    avg = total / n_queries if n_queries else 0.0
    qps = 1000.0 * n_queries / total if total > 0 else 0.0
    bw = None
    if bytes_per_query is not None:
        # bytes * 1e-6 / ms == GB/s (nvdb_bench.cpp:421)
        bw = bytes_per_query * 1e-6 / avg if avg > 0 else 0.0
    return LatencyStats(
        total_ms=total,
        n_queries=n_queries,
        n_samples=len(s),
        avg_ms=avg,
        qps=qps,
        p50_ms=percentile(s, 50),
        p95_ms=percentile(s, 95),
        p99_ms=percentile(s, 99),
        batch_q=batch_q,
        avg_batch_ms=(total / len(s) if (batch_q > 1 and s) else None),
        bytes_per_query=bytes_per_query,
        bandwidth_gbps=bw,
    )


def result_line(**kv) -> str:
    """Single-line machine-parsable record: ``RESULT k=v k=v ...``
    (nvdb_ivf_eval.cpp:729-779). Floats rendered with 6 decimals like the
    reference's setprecision(6)."""
    parts = ["RESULT"]
    for key, v in kv.items():
        if isinstance(v, bool):
            v = int(v)
        if isinstance(v, float):
            parts.append(f"{key}={v:.6f}")
        else:
            parts.append(f"{key}={v}")
    return " ".join(parts)
