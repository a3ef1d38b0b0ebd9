"""The flat-scan benchmark harness — the nvdb_bench analogue (apps/nvdb_bench.cpp).

    python -m nvdb_tpu_torch.tools.bench base.vecbin q.vecbin 10 --batch-q 128 \\
        --gt gt.gtbin [--quantize-queries [--refine-k R]] [--device-queries] \\
        [--backend auto|cuda|torch] [--device cuda|cpu]

Reports Total / Avg / QPS / p50 / p95 / p99 (batch-level when batching),
bytes_per_query and payload_equiv_bandwidth_GBps (nvdb_bench.cpp:369-425),
recall@k against a gtbin file, and a machine-parsable RESULT line with the
JAX package's keys and the device name. Every timed batch ends with the
copy of its ids to the host. ``--shards N > 1`` row-shards the store over N
devices (``dist.ShardedFlatIndex``; with ``--device cpu`` N CPU shards) and
fails by name with fewer visible cards; in a process group
(``NVDB_COORD`` / ``NVDB_NPROC`` / ``NVDB_PROC_ID``) the shards span the
processes, each loading only its rows. As in the JAX tool, the query
quantization and ``--device-queries`` apply to one device only.
"""

from __future__ import annotations

import numpy as np

from nvdb_tpu_torch import config
from nvdb_tpu_torch.eval.harness import run_benchmark
from nvdb_tpu_torch.eval.recall import recall_at_k
from nvdb_tpu_torch.eval.stats import result_line
from nvdb_tpu_torch.formats import gtbin, vecbin
from nvdb_tpu_torch.tools._common import fail, make_parser, setup_device, tool_mesh


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("base")
    p.add_argument("query")
    p.add_argument("k", type=int)
    p.add_argument("--batch-q", type=int, default=1)
    p.add_argument("--warmup", type=int,
                   default=config.EvalConfig.from_env().warmup)
    p.add_argument("--shards", type=int, default=1,
                   help=">1: row-shard the store over this many devices")
    p.add_argument("--gt", default=None, help="gtbin file for recall@k")
    p.add_argument("--quantize-queries", action="store_true",
                   help="int8 stores: quantize queries to int8 and score "
                        "int8 x int8 with exact int32 sums (adds query "
                        "quantization noise)")
    p.add_argument("--refine-k", type=int, default=0,
                   help="with --quantize-queries: the exact-i8 mode, an f32-query "
                        "dot rerank of the scan's top REFINE_K")
    p.add_argument("--device-queries", action="store_true",
                   help="upload the query pool once and slice batches on the device "
                        "(no host-to-device copy in the timed loop)")
    args = p.parse_args(argv)
    device = setup_device(args)

    from nvdb_tpu_torch.index.flat import FlatIndex
    from nvdb_tpu_torch.store import ShardedVectorStore, VectorStore

    qf = vecbin.VecbinFile(args.query)
    queries = qf.rows_f32()
    if args.shards > 1:
        from nvdb_tpu_torch.dist.sharded import ShardedFlatIndex

        mesh = tool_mesh(args, args.shards)
        store = ShardedVectorStore.from_vecbin(args.base, mesh)
        index = ShardedFlatIndex(store, mesh=mesh, backend=args.backend)
    else:
        store = VectorStore.from_vecbin(args.base, device=device)
        index = FlatIndex(store, backend=args.backend,
                          quantize_queries=args.quantize_queries, refine_k=args.refine_k)

    dev_name = "cpu"
    if device.type == "cuda":
        import torch

        dev_name = torch.cuda.get_device_name(device).replace(" ", "_")
    print(f"N={store.n} dim={store.d} dtype={vecbin.dtype_name(store.dtype_code)} "
          f"Q={qf.count} k={args.k} backend={args.backend} device={dev_name} "
          f"shards={args.shards}")

    search_fn = index.search
    if args.device_queries and args.shards == 1:
        import torch

        pool = torch.from_numpy(store.pad_queries(queries)).to(device)
        base_addr = queries.__array_interface__["data"][0]
        row_stride = queries.strides[0]

        def search_fn(qs, k):
            # the batch's first row, from the slice's offset in `queries`
            start = (qs.__array_interface__["data"][0] - base_addr) // row_stride
            v, i = index.search_device(pool[start:start + qs.shape[0]], k)
            return v.cpu().numpy(), i.cpu().numpy()

    ids, stats = run_benchmark(
        search_fn, queries, args.k, batch_q=args.batch_q,
        warmup=args.warmup, bytes_per_query=store.payload_bytes)
    print(stats.render())

    recall = None
    if args.gt:
        info, gt_ids = gtbin.read_gtbin(args.gt)
        if info.Q != qf.count or info.k < args.k:
            fail(f"GT shape mismatch: {info} vs Q={qf.count} k={args.k}")
        recall = recall_at_k(ids, np.asarray(gt_ids), k=args.k)
        print(f"recall@{args.k}={recall:.4f}")

    kv = dict(mode="flat", backend=args.backend, device=dev_name, shards=args.shards,
              refine_k=args.refine_k, N=store.n, dim=store.d, dtype=vecbin.dtype_name(store.dtype_code),
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
