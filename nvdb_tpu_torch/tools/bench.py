"""The flat-scan benchmark harness — the nvdb_bench analogue (apps/nvdb_bench.cpp).

    python -m nvdb_tpu_torch.tools.bench base.vecbin q.vecbin 10 --batch-q 128 \\
        --gt gt.gtbin [--quantize-queries] [--backend auto|cuda|torch] \\
        [--device cuda|cpu]

Reports Total / Avg / QPS / p50 / p95 / p99 (batch-level when batching),
bytes_per_query and payload_equiv_bandwidth_GBps (nvdb_bench.cpp:369-425),
recall@k against a gtbin file, and a machine-parsable RESULT line. Every
timed batch ends with the copy of its ids to the host.
"""

from __future__ import annotations

import numpy as np

from nvdb_tpu_torch import config
from nvdb_tpu_torch.eval.harness import run_benchmark
from nvdb_tpu_torch.eval.recall import recall_at_k
from nvdb_tpu_torch.eval.stats import result_line
from nvdb_tpu_torch.formats import gtbin, vecbin
from nvdb_tpu_torch.tools._common import fail, make_parser, setup_device


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("base")
    p.add_argument("query")
    p.add_argument("k", type=int)
    p.add_argument("--batch-q", type=int, default=1)
    p.add_argument("--warmup", type=int,
                   default=config.EvalConfig.from_env().warmup)
    p.add_argument("--gt", default=None, help="gtbin file for recall@k")
    p.add_argument("--quantize-queries", action="store_true",
                   help="int8 stores: quantize queries to int8 and score "
                        "int8 x int8 with exact int32 sums (adds query "
                        "quantization noise)")
    args = p.parse_args(argv)
    device = setup_device(args)

    from nvdb_tpu_torch.index.flat import FlatIndex
    from nvdb_tpu_torch.store import VectorStore

    qf = vecbin.VecbinFile(args.query)
    queries = qf.rows_f32()
    store = VectorStore.from_vecbin(args.base, device=device)
    index = FlatIndex(store, backend=args.backend,
                      quantize_queries=args.quantize_queries)

    dev_name = "cpu"
    if device.type == "cuda":
        import torch

        dev_name = torch.cuda.get_device_name(device).replace(" ", "_")
    print(f"N={store.n} dim={store.d} dtype={vecbin.dtype_name(store.dtype_code)} "
          f"Q={qf.count} k={args.k} backend={args.backend} device={dev_name}")

    ids, stats = run_benchmark(
        index.search, queries, args.k, batch_q=args.batch_q,
        warmup=args.warmup, bytes_per_query=store.payload_bytes)
    print(stats.render())

    recall = None
    if args.gt:
        info, gt_ids = gtbin.read_gtbin(args.gt)
        if info.Q != qf.count or info.k < args.k:
            fail(f"GT shape mismatch: {info} vs Q={qf.count} k={args.k}")
        recall = recall_at_k(ids, np.asarray(gt_ids), k=args.k)
        print(f"recall@{args.k}={recall:.4f}")

    kv = dict(mode="flat", backend=args.backend, device=dev_name,
              N=store.n, dim=store.d, dtype=vecbin.dtype_name(store.dtype_code),
              Q=qf.count, k=args.k, batch_q=args.batch_q,
              avg_ms=stats.avg_ms, qps=stats.qps,
              p50_ms=stats.p50_ms, p95_ms=stats.p95_ms, p99_ms=stats.p99_ms,
              bytes_per_query=int(stats.bytes_per_query),
              bandwidth_gbps=stats.bandwidth_gbps)
    if recall is not None:
        kv["recall"] = recall
    print(result_line(**kv))
    return recall


if __name__ == "__main__":
    main()
