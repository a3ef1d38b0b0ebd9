"""Exact ground truth: the exact top-k of every query over a base, written
as a gtbin file. The port of ``nvdb_tpu.tools.gt_build`` (the
nvdb_gt_build analogue, apps/nvdb_gt_build.cpp:74-127).

    python -m nvdb_tpu_torch.tools.gt_build base.vecbin q.vecbin gt.gtbin [--k 10] \\
        [--batch 256] [--row-chunk ROWS] [--host] [--metric dot|l2] \\
        [--device cuda|cpu] [--backend auto|cuda|torch]

Three paths, as in the JAX package:
- the device path (default): the base as one ``VectorStore`` on the device,
  ``index.flat.build_ground_truth``, which runs the flat kernel on a card;
- ``--row-chunk ROWS`` (or automatically when the f32 base exceeds ~12 GB):
  the base streamed in row chunks through the plain f32 scan, winners
  merged on the host (``build_ground_truth_chunked``);
- ``--host``: the native host scan (``nvdb_tpu_torch.native.topk_dot_f32``),
  an oracle independent of the device; dot metric only.
"""

from __future__ import annotations

import time

from nvdb_tpu_torch import config
from nvdb_tpu_torch.formats import gtbin, vecbin
from nvdb_tpu_torch.tools._common import make_parser, setup_device


def main(argv=None):
    eval_env = config.EvalConfig.from_env()
    p = make_parser(__doc__)
    p.add_argument("base")
    p.add_argument("query")
    p.add_argument("out")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--host", action="store_true", default=eval_env.gt_host,
                   help="build GT with the native C++ host scan instead of the device "
                        "(independent oracle; GT_MODE=host analogue)")
    p.add_argument("--row-chunk", type=int, default=0,
                   help="stream the base in row chunks of this size (exact chunked scan "
                        "+ host k-merge), for corpora larger than device memory. 0 = "
                        "auto: chunk when the f32 working set exceeds ~12 GB")
    p.add_argument("--metric", default=eval_env.exact_metric, choices=["dot", "l2"],
                   help="ranking metric (EXACT_METRIC=DOT|L2 analogue): identical ids on "
                        "normalized corpora; l2 is exact on un-normalized ones. l2 is "
                        "device-path only")
    args = p.parse_args(argv)
    if args.host and args.metric == "l2":
        raise SystemExit("--host oracle is dot-metric only; drop --host or "
                         "use --metric dot")

    bf = vecbin.VecbinFile(args.base)
    qf = vecbin.VecbinFile(args.query)
    t0 = time.perf_counter()
    if args.host:
        from nvdb_tpu_torch import native

        _, ids = native.topk_dot_f32(bf.rows_f32(), qf.rows_f32(), args.k)
    else:
        device = setup_device(args)
        row_chunk = args.row_chunk
        if row_chunk == 0 and bf.count * bf.dim * 4 > 12 * 1024**3:
            row_chunk = 1_000_000
        if row_chunk > 0:
            from nvdb_tpu_torch.index.flat import build_ground_truth_chunked

            ids = build_ground_truth_chunked(args.base, qf.rows_f32(), args.k,
                                             batch=args.batch, row_chunk=row_chunk,
                                             verbose=True, metric=args.metric,
                                             device=device)
        else:
            from nvdb_tpu_torch.index.flat import build_ground_truth
            from nvdb_tpu_torch.store import VectorStore

            store = VectorStore.from_vecbin(args.base, device=device)
            ids = build_ground_truth(store, qf.rows_f32(), args.k, batch=args.batch,
                                     backend=args.backend, metric=args.metric)
    dt = time.perf_counter() - t0
    gtbin.write_gtbin(args.out, ids, dim=bf.dim, N=bf.count)
    print(f"wrote GT [{qf.count} x {args.k}] over N={bf.count} in {dt:.2f}s "
          f"-> {args.out}")
    return ids


if __name__ == "__main__":
    main()
