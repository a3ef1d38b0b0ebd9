"""Write a synthetic L2-normalized vecbin corpus: the port of
``nvdb_tpu.tools.synth`` (the benchmarking stand-in for the reference's
embedding pipeline, scripts/build_vecbin_chunked.py).

    python -m nvdb_tpu_torch.tools.synth out.vecbin --count 1000000 --dim 768 \\
        [--seed 0] [--clusters K [--spread 0.25]] [--low-rank INTRINSIC] \\
        [--hard INTRINSIC] [--dtype f32|bf16|i8] [--raw12] [--resume]

Host only. Rows are made in chunks of 262,144, each seeded by its row
offset, by the generators of ``nvdb_tpu_torch.formats.synth``, so the file
is the JAX tool's byte for byte, and ``--resume`` continues an interrupted
write (or extends a smaller file of the same seed) from its last whole chunk.
"""

from __future__ import annotations

import os

import numpy as np

from nvdb_tpu_torch.formats import synth, vecbin
from nvdb_tpu_torch.tools._common import make_parser

CHUNK = 262144


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("out")
    p.add_argument("--count", type=int, required=True)
    p.add_argument("--dim", type=int, required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--clusters", type=int, default=0,
                   help="0 = iid gaussian; else mixture-of-gaussians")
    p.add_argument("--spread", type=float, default=0.25)
    p.add_argument("--low-rank", type=int, default=0, metavar="INTRINSIC",
                   help=">0: low-intrinsic-dimension manifold data (the realistic "
                        "regime for PQ/OPQ; real embeddings are low-rank)")
    p.add_argument("--hard", type=int, default=0, metavar="INTRINSIC",
                   help=">0: hierarchical Zipf topic corpus with strong overlap — "
                        "recall-vs-nprobe actually slopes")
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16", "i8"])
    p.add_argument("--raw12", action="store_true", help="legacy raw12 header")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted write (or extend a smaller same-seed "
                        "file to a larger --count): chunks are seeded by row offset, "
                        "so the payload prefix is identical either way. f32/bf16 only.")
    args = p.parse_args(argv)
    if args.raw12 and args.dtype != "f32":
        p.error("--raw12 is an f32-only legacy format (use --dtype f32)")

    resume_rows = 0
    if args.resume and os.path.exists(args.out):
        payload = os.path.getsize(args.out) - vecbin.HEADER_BYTES
        row_bytes = args.dim * (1 if args.dtype == "i8" else 2 if args.dtype == "bf16" else 4)
        # down to a chunk boundary: a chunk's seed is its row offset, so
        # regenerating from the boundary reproduces an uninterrupted run
        resume_rows = max(payload // row_bytes // CHUNK * CHUNK, 0)
    with vecbin.StreamingVecbinWriter(args.out, args.dim, args.dtype,
                                      resume_rows=resume_rows) as w:
        done = resume_rows
        if resume_rows:
            print(f"resuming at row {resume_rows}", flush=True)
        while done < args.count:
            n = min(CHUNK, args.count - done)
            if args.hard > 0:
                rows = synth.hard(n, args.dim, intrinsic=args.hard,
                                  topics=max(args.clusters, 256), seed=args.seed,
                                  chunk_seed=done)
            elif args.low_rank > 0:
                rows = synth.low_rank(n, args.dim, intrinsic=args.low_rank,
                                      n_clusters=max(args.clusters, 64), spread=args.spread,
                                      seed=args.seed, chunk_seed=done)
            elif args.clusters > 0:
                # the same seed gives the same centers in every chunk
                rows = synth.clustered(n, args.dim, args.clusters, args.spread,
                                       seed=args.seed, chunk_seed=done)
            else:
                rows = synth.normalized_gaussian(n, args.dim, seed=args.seed + done)
            if args.dtype == "i8":
                w.append(*vecbin.quantize_i8(rows))
            elif args.dtype == "bf16":
                w.append(vecbin.to_bf16(rows))
            else:
                w.append(rows)
            done += n
    info = vecbin.VecbinFile(args.out).info
    print(f"wrote {info.count} x {info.dim} {info.dtype_str} -> {args.out}")
    if args.raw12:
        # copy out before rewriting: the reader maps the file being replaced
        f = vecbin.VecbinFile(args.out)
        rows = np.array(f.vectors)
        del f
        vecbin.write_vecbin(args.out, rows, legacy_raw12=True)
        print("rewrote as raw12")
    return info


if __name__ == "__main__":
    main()
