"""Partition-then-rerank recall / latency eval, the nvdb_hnsw_eval analogue
(the port of ``nvdb_tpu.tools.pr_eval``): builds the index, then for each
nprobe (the efSearch analogue) times the search and scores recall against
exact ground truth (a cached gtbin, or built untimed on the fly).

    python -m nvdb_tpu_torch.tools.pr_eval base.vecbin q.vecbin [--gt gt.gtbin] \\
        --nprobe 16 32 --rerank-k 50 [--k 10] [--batch-q 64] [--chained [--wave 4]] \\
        [--refine-dtype f32|res_i8] [--tune 0.95] [--backend auto|cuda|torch] \\
        [--device cuda|cpu]

Default mode: ``idx.search`` per host batch of ``--batch-q`` queries (the
harness's avg / p99 / QPS). ``--chained``: query blocks staged on the device
and ``search_device`` (probe + rerank) chained over all of them with one
fetch at the end; ``--wave W`` also fetches every W-th batch for wave
latency percentiles. Each point prints a ``RESULT key=value ...`` line with
the device name; ``main`` returns those records as dicts. ``--shards S >
1`` splits the built index's partitions over S devices
(``dist.ShardedPartitionIndex``; with ``--device cpu`` S CPU shards; fewer
visible cards fail by name), ``nprobe`` the total over the shards, the kind
``partition-rerank-sharded<S>``; it refuses ``--chained``, the
single-device serving loop, as the JAX tool does. In a process group
(``NVDB_COORD`` / ``NVDB_NPROC`` / ``NVDB_PROC_ID``) the shards span the
processes, and every process serves rank 0's build.
"""

from __future__ import annotations

import time

import numpy as np

from nvdb_tpu_torch.eval.harness import run_benchmark
from nvdb_tpu_torch.eval.recall import recall_at_k
from nvdb_tpu_torch.eval.stats import compute_stats, result_line
from nvdb_tpu_torch.formats import gtbin, vecbin
from nvdb_tpu_torch.tools._common import fail, make_parser, setup_device, tool_mesh


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("base")
    p.add_argument("query")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--nprobe", type=int, nargs="+", default=[4, 16, 64],
                   help="efSearch-analogue sweep")
    p.add_argument("--nlist", type=int, default=None)
    p.add_argument("--rerank-k", type=int, default=0)
    p.add_argument("--dtype", default="bf16", choices=["f32", "bf16", "i8"])
    p.add_argument("--refine-dtype", default="f32", choices=["f32", "res_i8"],
                   help="rerank store: exact f32, or residual-int8 against the "
                        "partition centroids (4x smaller)")
    p.add_argument("--gt", default=None, help="cached gtbin; omitted = exact GT on the fly")
    p.add_argument("--batch-q", type=int, default=8)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--tune", type=float, default=None,
                   help="report the smallest nprobe hitting this recall")
    p.add_argument("--shards", type=int, default=1,
                   help=">1: shard the partitions over this many devices (nprobe "
                        "becomes the total over the shards)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chained", action="store_true",
                   help="pre-staged device query blocks, batches chained on the "
                        "device with one trailing fetch")
    p.add_argument("--wave", type=int, default=0,
                   help="with --chained: fetch every WAVE-th batch for wave latency "
                        "percentiles; 0 disables")
    args = p.parse_args(argv)
    device = setup_device(args)

    import torch

    from nvdb_tpu_torch.index.flat import build_ground_truth
    from nvdb_tpu_torch.index.partition import PartitionRerankIndex
    from nvdb_tpu_torch.store import VectorStore

    rows = vecbin.VecbinFile(args.base).rows_f32()
    queries = vecbin.VecbinFile(args.query).rows_f32()
    Q = queries.shape[0]
    dev_name = (torch.cuda.get_device_name(device).replace(" ", "_")
                if device.type == "cuda" else "cpu")

    t0 = time.perf_counter()
    idx = PartitionRerankIndex.build(rows, nlist=args.nlist, dtype=args.dtype,
                                     with_refine=args.rerank_k > 0,
                                     refine_dtype=args.refine_dtype, seed=args.seed,
                                     device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"partitions={idx.ivf.nlist} lcap={idx.ivf.lcap} "
          f"index_MB={idx.index_bytes / 1e6:.1f} N={idx.n} spilled={idx.ivf.n_spilled} "
          f"build_s={time.perf_counter() - t0:.2f} device={dev_name}")
    kind = "partition-rerank"

    if args.gt:
        info, g = gtbin.read_gtbin(args.gt)
        if info.Q != Q or info.k < args.k:
            fail(f"GT shape mismatch: gt(Q={info.Q},k={info.k}) vs eval(Q={Q},k={args.k})")
        gt_ids = np.asarray(g)
    else:
        store = VectorStore.from_numpy(rows, "f32", device=device)
        gt_ids = build_ground_truth(store, queries, args.k, backend=args.backend)
        del store

    if args.tune is not None:
        best = idx.tune_nprobe(queries, gt_ids, args.k, target_recall=args.tune,
                               backend=args.backend)
        print(f"tuned nprobe for recall>={args.tune}: {best}")

    if args.shards > 1:
        from nvdb_tpu_torch.dist import multihost
        from nvdb_tpu_torch.dist.sharded_ivf import ShardedPartitionIndex

        mesh = tool_mesh(args, args.shards)
        if mesh.backend is not None:
            # every process serves rank 0's partitions: a build on a card
            # is not bit-reproducible, and each process keeps only its lists
            idx = multihost.from_rank0(idx)
        idx = ShardedPartitionIndex.from_index(idx, mesh)
        kind = f"partition-rerank-sharded{args.shards}"
    if args.chained and args.shards > 1:
        fail("--chained is the single-device serving loop; use ivf_eval --shards for "
             "sharded timing")

    common = dict(kind=kind, rerank_k=args.rerank_k, Q=Q, k=args.k, dtype=args.dtype,
                  refine_dtype=args.refine_dtype, backend=args.backend, device=dev_name)
    results = []

    def emit(**kv):
        print(result_line(**kv))
        results.append(kv)

    b = max(args.batch_q, 1)
    n_batches = (Q + b - 1) // b
    dp = idx.ivf.d_padded if args.shards > 1 else idx.ivf.centroids.shape[1]
    qpad = np.zeros((n_batches * b, dp), np.float32)
    qpad[:Q, :queries.shape[1]] = queries
    for np_ in args.nprobe:
        if args.chained:
            blocks = [torch.from_numpy(qpad[s * b:(s + 1) * b]).to(device)
                      for s in range(n_batches)]

            def fused(block, np_=np_):
                return idx.search_device(block, args.k, np_, rerank_k=args.rerank_k,
                                         backend=args.backend)

            fused(blocks[0])[1].cpu()   # load the kernels, warm up
            for w in range(min(args.warmup, n_batches)):
                fused(blocks[w])[1].cpu()
            t0 = time.perf_counter()
            outs = []
            wave_ts = [t0]
            for s, x in enumerate(blocks):
                outs.append(fused(x))
                if args.wave > 0 and (s + 1) % args.wave == 0:
                    outs[-1][1].cpu()   # its completion closes the wave
                    wave_ts.append(time.perf_counter())
            outs[-1][1].cpu()           # one trailing fetch
            dt = time.perf_counter() - t0
            final_ids = np.concatenate([i.cpu().numpy()[:, :args.k] for _, i in outs])[:Q]
            recall = recall_at_k(final_ids, gt_ids, k=args.k)
            ms_q = dt * 1000.0 / (n_batches * b)
            extra = {}
            if args.wave > 0 and len(wave_ts) > 2:
                wl = np.diff(np.asarray(wave_ts))[1:] * 1000.0  # wave 0 absorbs the ramp
                ws = compute_stats(list(wl), n_queries=len(wl), batch_q=1)
                extra = dict(wave=args.wave, wave_p50_ms=ws.p50_ms, wave_p95_ms=ws.p95_ms,
                             wave_p99_ms=ws.p99_ms, p99_ms_per_q=ws.p99_ms / (args.wave * b))
            print(f"\n--- nprobe={np_} (rerank_k={args.rerank_k}, chained) ---")
            print(f"recall@{args.k}={recall:.4f}")
            emit(**common, nprobe=np_, batch_q=b, chained=1, total_avg_ms=ms_q,
                 qps=1000.0 / ms_q if ms_q > 0 else 0.0, recall=recall,
                 index_mb=idx.index_bytes / 1e6, **extra)
            continue

        def search_fn(qs, k, np_=np_):
            return idx.search(qs, k, np_, rerank_k=args.rerank_k, backend=args.backend)

        ids, stats = run_benchmark(search_fn, queries, args.k, batch_q=b,
                                   warmup=args.warmup)
        recall = recall_at_k(ids, gt_ids, k=args.k)
        print(f"\n--- nprobe={np_} (rerank_k={args.rerank_k}) ---")
        print(stats.render())
        print(f"recall@{args.k}={recall:.4f}")
        emit(**common, nprobe=np_, batch_q=b, avg_ms=stats.avg_ms, p99_ms=stats.p99_ms,
             qps=stats.qps, recall=recall, index_mb=idx.index_bytes / 1e6)
    return results


if __name__ == "__main__":
    main()
