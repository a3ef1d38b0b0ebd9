"""IVF-Flat / IVF-PQ + refine eval harness, the nvdb_ivf_eval analogue (the
port of ``nvdb_tpu.tools.ivf_eval``).

    python -m nvdb_tpu_torch.tools.ivf_eval index.npz base.vecbin q.vecbin \\
        --gt gt.gtbin --nprobe 64 --refine-k 100 --k 10 --batch-q 256 \\
        [--chained [--wave W]] [--ivf-backend auto|cuda|torch] [--device cuda|cpu] \\
        [--ids-mode dma|key|gather] [--residual-refine]

Two ways to run each (nprobe, refine_k) grid point, as in the JAX package:

- staged (default; PIPELINE=staged): stage A times ANN candidate
  generation batch by batch and keeps the candidate ids; stage B times the
  exact refine over the stored candidates. The per-query total is ANN plus
  the amortized refine. Also reports ``cand_recall``, the share of the true
  top-k anywhere in the candidate set.
- ``--chained``: the fused coarse + ADC + refine ``search_device`` over all
  query batches staged on the device, one fetch at the end; ``--wave W``
  also fetches every W-th batch for wave latency percentiles.

Each grid point prints a ``RESULT key=value ...`` line with the keys of the
JAX package's tool, ``refine_backend`` being the path ``--ivf-backend``
resolves to (cuda, torch or oracle) and ``ids_mode`` present when
``--ids-mode`` is given, plus the device name; ``main`` returns those
records as dicts. Every timed batch ends in a copy to the host, so times
include the device work. The index kind is read from the ``.npz``; an
IVF-Flat payload is already exact, so its grid points with ``refine_k > 0``
are skipped, as in the JAX package.

``--ids-mode`` overrides the IVF-PQ candidate generator (default: the
index's ``ids_mode()``, ``key`` on every index ``ivf_build`` makes, for refine
candidates, and ``dma`` for ADC-only results). ``--residual-refine``: the
base vecbin holds residual int8 codes of this index
(``tools.quantize_i8 --residual``); the refine dequantizes them against the
index's centroids and scores rotated queries.

``--shards S`` (or ``--force-sharded`` at any S, 1 included) splits the
index's lists over S devices (``dist.ShardedIVFPQIndex`` /
``ShardedIVFFlatIndex``; with ``--device cpu`` S CPU shards; fewer visible
cards fail by name): ``nprobe`` is the total over the shards, the refine
store is row-sharded with the lists so stage B and the chained refine run
``dist.sharded_refine``, the kind reads ``<kind>-sharded<S>``, and
``--ids-mode`` is ignored with a warning (each shard takes the index's id
mode), as in the JAX tool. ``--one-device`` puts the S shards on this
process's one card. In a process group (``NVDB_COORD`` / ``NVDB_NPROC`` /
``NVDB_PROC_ID``, joined in ``tools._common.setup_device``) the S shards
span the processes, each loading only its rows of the refine store, and
every process ends with the same result.

With ``NVDB_DBG_DIR`` set, each staged grid point also writes its stage
spans (``eval.trace.Tracer``: ``ann`` and ``refine``, one sample per batch)
to ``NVDB_DBG_DIR/stages_<kind>_np<nprobe>_r<refine_k>_q<Q>_k<k>.tsv``,
the JAX package's file and columns.
"""

from __future__ import annotations

import functools
import itertools
import os
import time

import numpy as np

from nvdb_tpu_torch import config
from nvdb_tpu_torch.eval.recall import candidate_recall, recall_at_k
from nvdb_tpu_torch.eval.stats import compute_stats, result_line
from nvdb_tpu_torch.eval.trace import Tracer
from nvdb_tpu_torch.formats import gtbin, vecbin
from nvdb_tpu_torch.tools._common import fail, make_parser, setup_device, tool_mesh


def main(argv=None):
    ivf_env = config.IVFConfig.from_env()
    pq_env = config.PQConfig.from_env()
    eval_env = config.EvalConfig.from_env()

    p = make_parser(__doc__)
    p.add_argument("index", help="index .npz from ivf_build (either package)")
    p.add_argument("base", help="base vecbin (refine store + GT dims)")
    p.add_argument("query")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--nprobe", type=int, nargs="+", default=[ivf_env.nprobe])
    p.add_argument("--refine-k", type=int, nargs="+", default=[pq_env.refine_k],
                   help="0 disables refine; sweeps the grid with --nprobe")
    p.add_argument("--gt", default=eval_env.gt_path, help="cached gtbin (GT_PATH)")
    p.add_argument("--warmup", type=int, default=eval_env.warmup)
    p.add_argument("--batch-q", type=int, default=8)
    p.add_argument("--ann-only", action="store_true", default=eval_env.ann_only,
                   help="skip the refine stage (EVAL_MODE=ann_only)")
    p.add_argument("--ivf-backend", default="auto", choices=["auto", "cuda", "torch"],
                   help="probe / ADC / refine path: auto = the CUDA kernels on a card, the "
                        "JAX package's jnp path on the CPU; torch = the kernels' "
                        "plain versions (the A/B switch)")
    p.add_argument("--ids-mode", default=None, choices=["dma", "key", "gather"],
                   help="override the IVF-PQ candidate generator: 'key' and 'gather' "
                        "rank candidates at bf16 granularity, 'dma' at exact f32; "
                        "default: auto")
    p.add_argument("--exact-metric", default=eval_env.exact_metric,
                   choices=["l2", "dot"], help="refine ranking metric (EXACT_METRIC)")
    p.add_argument("--residual-refine", action="store_true",
                   help="the base vecbin holds residual int8 codes of this index "
                        "(quantize_i8 --residual): the refine adds the centroid back "
                        "and scores rotated queries")
    p.add_argument("--shards", type=int, default=1,
                   help=">1: shard the inverted lists over this many devices (nprobe "
                        "becomes the total over the shards)")
    p.add_argument("--force-sharded", action="store_true",
                   help="the sharded path even at --shards 1")
    p.add_argument("--one-device", action="store_true",
                   help="with --shards: every shard on this process's one card (views of "
                        "one index), as on a machine of one card")
    p.add_argument("--device-queries", action="store_true",
                   help="stage query blocks (and stage-B candidates) on the "
                        "device before the timed loops")
    p.add_argument("--chained", action="store_true",
                   help="steady-state throughput of the fused search_device over "
                        "all staged batches, one trailing fetch")
    p.add_argument("--wave", type=int, default=0,
                   help="with --chained: also fetch every WAVE-th batch for wave "
                        "latency percentiles; 0 disables")
    args = p.parse_args(argv)
    device = setup_device(args)

    import torch

    from nvdb_tpu_torch.index.ivf_flat import IVFFlatIndex
    from nvdb_tpu_torch.kernels import dispatch
    from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
    from nvdb_tpu_torch.store import ShardedVectorStore, VectorStore

    z = np.load(args.index if args.index.endswith(".npz") else args.index + ".npz")
    is_pq = "codebooks" in z.files
    kind = "ivfpq" if is_pq else "ivfflat"
    idx = (IVFPQIndex if is_pq else IVFFlatIndex).load(args.index, device=device)
    sharded = args.shards > 1 or args.force_sharded
    if sharded:
        from nvdb_tpu_torch.dist import sharded_ivf

        mesh = tool_mesh(args, args.shards)
        idx = (sharded_ivf.ShardedIVFPQIndex if is_pq
               else sharded_ivf.ShardedIVFFlatIndex).from_index(idx, mesh)
        kind = f"{kind}-sharded{args.shards}"
    dev_name = (torch.cuda.get_device_name(device).replace(" ", "_")
                if device.type == "cuda" else "cpu")

    qf = vecbin.VecbinFile(args.query)
    queries = qf.rows_f32()
    Q = queries.shape[0]

    gt_ids = None
    if args.gt:
        info, g = gtbin.read_gtbin(args.gt)
        if info.Q != Q or info.k < args.k or info.N != idx.n:
            fail(f"GT mismatch: gt(Q={info.Q},k={info.k},N={info.N}) vs "
                 f"eval(Q={Q},k={args.k},N={idx.n})")
        gt_ids = np.asarray(g)

    refine_ks = [0] if args.ann_only else list(args.refine_k)
    refine_store = None
    if max(refine_ks) > 0 and is_pq:
        # sharded: the refine store is sharded with the lists, so the refine
        # runs sharded (no device holds the whole store)
        refine_store = (ShardedVectorStore.from_vecbin(args.base, idx.mesh) if sharded
                        else VectorStore.from_vecbin(args.base, device=device))
        if args.residual_refine:
            # pair the residual codes with this index's centroids and lists
            from nvdb_tpu_torch.tools.quantize_i8 import residual_params

            r_cents, _, r_list_of = residual_params(args.index)
            refine_store.attach_residual(r_cents, r_list_of)
    refine_path = dispatch.refine_backend(args.ivf_backend, torch.empty(0, device=device))
    # --ids-mode reaches the single-device IVF-PQ candidate generator only
    im_kw = {"ids_mode": args.ids_mode} if args.ids_mode and is_pq and not sharded else {}
    if args.ids_mode and not im_kw:
        print(f"WARNING: --ids-mode {args.ids_mode} ignored "
              f"({'sharded' if sharded else 'non-PQ'} path resolves ids_mode itself); "
              f"RESULT lines will not carry it")

    print(f"kind={kind} nlist={idx.nlist} lcap={idx.lcap} N={idx.n} d={idx.d} Q={Q} "
          f"k={args.k} index_MB={idx.index_bytes / 1e6:.1f} device={dev_name}")

    b = max(args.batch_q, 1)
    dp = idx.d_padded if sharded else idx.centroids.shape[1]
    n_batches = (Q + b - 1) // b
    qpad = np.zeros((n_batches * b, dp), np.float32)
    qpad[:Q, :queries.shape[1]] = queries
    host_blocks = [qpad[s * b:(s + 1) * b] for s in range(n_batches)]
    staged = args.device_queries or args.chained

    results = []
    dbg_dir = os.environ.get("NVDB_DBG_DIR")

    def to_dev(x):
        return torch.from_numpy(x).to(device)

    def emit(**kv):
        print(result_line(**kv))
        results.append(kv)

    for nprobe, refine_k in itertools.product(args.nprobe, refine_ks):
        if not is_pq and refine_k > 0:
            continue  # the flat payload is exact: a refine would be a no-op
        do_refine = refine_k > 0
        kk = max(refine_k, args.k) if do_refine else args.k
        blocks = [to_dev(x) for x in host_blocks] if staged else host_blocks
        common = dict(kind=kind, refine_k=refine_k, nprobe=nprobe, Q=Q, k=args.k,
                      batch_q=b, backend=args.ivf_backend, device=dev_name, **im_kw,
                      refine_backend=refine_path)

        if args.chained:
            def fused(block):
                if not is_pq:
                    return idx.search_device(block, args.k, nprobe, backend=args.ivf_backend)
                return idx.search_device(block, args.k, nprobe, refine_k=refine_k,
                                         refine_store=refine_store,
                                         backend=args.ivf_backend,
                                         refine_metric=args.exact_metric, **im_kw)

            fused(blocks[0])[1].cpu()  # load the kernels, warm up
            for w in range(min(args.warmup, n_batches)):
                fused(blocks[w])[1].cpu()
            t0 = time.perf_counter()
            outs = []
            wave_ts = [t0]
            for s, x in enumerate(blocks):
                outs.append(fused(x))
                if args.wave > 0 and (s + 1) % args.wave == 0:
                    outs[-1][1].cpu()  # its completion closes the wave
                    wave_ts.append(time.perf_counter())
            outs[-1][1].cpu()          # one trailing fetch
            dt = time.perf_counter() - t0
            final_ids = np.concatenate([i.cpu().numpy()[:, :args.k] for _, i in outs])[:Q]
            recall = recall_at_k(final_ids, gt_ids, k=args.k) if gt_ids is not None else -1.0
            ms_q = dt * 1000.0 / (n_batches * b)
            extra = {}
            if args.wave > 0 and len(wave_ts) > 2:
                wl = np.diff(np.asarray(wave_ts))[1:] * 1000.0  # wave 0 absorbs the ramp
                ws = compute_stats(list(wl), n_queries=len(wl), batch_q=1)
                extra = dict(wave=args.wave, wave_p50_ms=ws.p50_ms, wave_p95_ms=ws.p95_ms,
                             wave_p99_ms=ws.p99_ms, p99_ms_per_q=ws.p99_ms / (args.wave * b))
            emit(**common, chained=1, refine_enabled=int(do_refine), total_avg_ms=ms_q,
                 qps=1000.0 / ms_q if ms_q > 0 else 0.0, recall=recall,
                 index_mb=idx.index_bytes / 1e6, **extra)
            continue

        def ann_step(block, nprobe=nprobe, kk=kk, do_refine=do_refine):
            q = block if torch.is_tensor(block) else to_dev(block)
            if is_pq:
                # for_refine: stage B re-scores these candidates exactly, so
                # stage A takes the refine candidates' generator
                _, i = idx.search_device(q, kk, nprobe, backend=args.ivf_backend,
                                         for_refine=do_refine, **im_kw)
            else:
                _, i = idx.search_device(q, kk, nprobe, backend=args.ivf_backend)
            return i.cpu().numpy()

        # ---- stage A: ANN candidate generation, timed per batch ----------
        # (each step ends in its copy to the host, so a span holds the
        # device's work)
        tr = Tracer()
        for w in range(min(args.warmup, n_batches)):
            ann_step(blocks[w])
        cand = np.empty((n_batches * b, kk), np.int64)
        for s in range(n_batches):
            with tr.span("ann"):
                cand[s * b:(s + 1) * b] = ann_step(blocks[s])
        ann_stats = compute_stats(tr.samples_ms["ann"], n_queries=Q, batch_q=b)

        # ---- stage B: exact refine over the stored candidates ------------
        ref_stats = None
        final_ids = cand[:Q, :args.k]
        if do_refine:
            from nvdb_tpu_torch.index.ivf_pq import _matmul

            cblocks = [np.ascontiguousarray(cand[s * b:(s + 1) * b, :refine_k],
                                            dtype=np.int32) for s in range(n_batches)]
            if staged:
                cblocks = [to_dev(c) for c in cblocks]
            norms2 = refine_store.norms2() if args.exact_metric == "l2" else None
            residual = refine_store.is_residual
            rot = idx.rotation if residual else None
            if sharded:
                # each shard reranks the candidates whose rows it owns
                from nvdb_tpu_torch.dist.sharded_ivf import sharded_refine

                refine = functools.partial(sharded_refine, idx.mesh)
            else:
                refine = dispatch.exact_refine

            def refine_step(block, cblock):
                q = block if torch.is_tensor(block) else to_dev(block)
                c = cblock if torch.is_tensor(cblock) else to_dev(cblock)
                if rot is not None:
                    # residual codes live in the index's rotated space: rotate
                    # the refine queries (the dot is rotation-invariant)
                    q = _matmul(q, rot)
                _, i = refine(
                    q, c, refine_store.vectors, refine_store.scales, args.k,
                    metric=args.exact_metric, norms2=norms2, backend=args.ivf_backend,
                    res_cents=refine_store.res_cents if residual else None,
                    res_ids=refine_store.res_ids if residual else None)
                return i.cpu().numpy()

            for w in range(min(args.warmup, n_batches)):
                refine_step(blocks[w], cblocks[w])
            out = np.empty((n_batches * b, args.k), np.int64)
            for s in range(n_batches):
                with tr.span("refine"):
                    out[s * b:(s + 1) * b] = refine_step(blocks[s], cblocks[s])
            ref_stats = compute_stats(tr.samples_ms["refine"], n_queries=Q, batch_q=b)
            final_ids = out[:Q]

        recall = recall_at_k(final_ids, gt_ids, k=args.k) if gt_ids is not None else -1.0
        cand_recall = (candidate_recall(cand[:Q], gt_ids, k=args.k)
                       if (gt_ids is not None and do_refine) else recall)
        print(f"\n--- nprobe={nprobe} refine_k={refine_k} ---")
        print("ANN-only (stage A):")
        print(ann_stats.render())
        refine_ms_per_q = 0.0
        if ref_stats is not None:
            print("Refine (stage B):")
            print(ref_stats.render())
            refine_ms_per_q = ref_stats.avg_ms
        if recall >= 0:
            print(f"recall@{args.k}={recall:.4f} cand_recall={cand_recall:.4f}")
        if dbg_dir:
            os.makedirs(dbg_dir, exist_ok=True)
            tr.dump_tsv(os.path.join(
                dbg_dir, f"stages_{kind}_np{nprobe}_r{refine_k}_q{Q}_k{args.k}.tsv"))
        total = ann_stats.avg_ms + refine_ms_per_q
        # total = per-query ANN + amortized refine (nvdb_ivf_eval.cpp:659-662)
        emit(**common, device_queries=int(args.device_queries),
             refine_enabled=int(do_refine), ann_avg_ms=ann_stats.avg_ms,
             ann_p99_ms=ann_stats.p99_ms, refine_ms_per_q=refine_ms_per_q,
             total_avg_ms=total, total_p99_ms=ann_stats.p99_ms + refine_ms_per_q,
             qps=1000.0 / total if total > 0 else 0.0, recall=recall,
             cand_recall=cand_recall, index_mb=idx.index_bytes / 1e6)
    return results


if __name__ == "__main__":
    main()
