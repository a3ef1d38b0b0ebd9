"""Build an IVF-Flat or IVF-(O)PQ index from a vecbin base, the
nvdb_ivf_build / nvdb_ivfpq_build analogue (the port of
``nvdb_tpu.tools.ivf_build``).

    python -m nvdb_tpu_torch.tools.ivf_build base.vecbin index.npz --kind ivfflat \\
        --nlist 4096 --dtype bf16 [--pad-factor 1.5] [--spill-candidates 4] \\
        [--device cuda|cpu]
    python -m nvdb_tpu_torch.tools.ivf_build base.vecbin index.npz --kind ivfpq \\
        --nlist 4096 --pq-m 96 --opq [--train 50000] [--pad-factor 2.5] \\
        [--corpus-refine ITERS]
    python -m nvdb_tpu_torch.tools.ivf_build base.vecbin repacked.npz --kind ivfpq \\
        --repack-from index.npz [--pad-factor 4.0] [--spill-candidates 8] [--replicas 2]

Flag defaults honor the reference's env vars (IVF_NLIST, IVF_TRAIN, PQ_M,
USE_OPQ, OPQ_NITER); ``--pad-factor`` defaults to 1.5 for ivfflat and 2.5
for ivfpq, and on ``--repack-from`` to 2.5 and 4.0. The ``.npz`` it writes
loads in ``nvdb_tpu`` too, and the index ``--repack-from`` reads may come
from either package.
"""

from __future__ import annotations

import time

from nvdb_tpu_torch import config
from nvdb_tpu_torch.eval import trace
from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.tools._common import make_parser, setup_device


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("base")
    p.add_argument("out", help="output index path (.npz)")
    ivf_env = config.IVFConfig.from_env()
    pq_env = config.PQConfig.from_env()
    p.add_argument("--kind", default="ivfflat", choices=["ivfflat", "ivfpq"])
    p.add_argument("--nlist", type=int, default=ivf_env.nlist)
    p.add_argument("--train", type=int, default=ivf_env.train_size)
    p.add_argument("--iters", type=int, default=ivf_env.n_iters)
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16", "i8"],
                   help="packed payload dtype (ivfflat only)")
    p.add_argument("--pq-m", type=int, default=pq_env.m)
    p.add_argument("--opq", dest="opq", action="store_true", default=pq_env.use_opq)
    p.add_argument("--no-opq", dest="opq", action="store_false")
    p.add_argument("--opq-iters", type=int, default=pq_env.opq_iters)
    p.add_argument("--pad-factor", type=float, default=None,
                   help="list capacity = pad_factor * N/nlist (default: 1.5 "
                        "ivfflat, 2.5 ivfpq)")
    p.add_argument("--spill-candidates", type=int, default=4,
                   help="overflow rows try their S nearest lists before the "
                        "last-resort pour into any free list")
    p.add_argument("--repack-from", default=None, metavar="IDX",
                   help="reuse a trained index's rotation/centroids/codebooks and only "
                        "re-pack (+ re-encode for pq) the lists at the new "
                        "--pad-factor/--spill-candidates")
    p.add_argument("--replicas", type=int, default=1,
                   help="ivfpq --repack-from only: encode each row in its top-R lists")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--corpus-refine", type=int, default=0, metavar="ITERS",
                   help=">0: corpus-scale Lloyd passes + dead-centroid reseeding after "
                        "the subsample k-means")
    args = p.parse_args(argv)
    if args.repack_from and args.kind == "ivfflat" and args.replicas != 1:
        p.error("--replicas is ivfpq-only (flat payload replication doubles "
                "full-vector memory; use ivfpq)")
    if args.pad_factor is None:
        # a repack exists to escape tight packing: the roomier defaults
        if args.repack_from:
            args.pad_factor = 2.5 if args.kind == "ivfflat" else 4.0
        else:
            args.pad_factor = 1.5 if args.kind == "ivfflat" else 2.5
    device = setup_device(args)

    f = vecbin.VecbinFile(args.base)
    rows = f.rows_f32()
    t0 = time.perf_counter()
    with trace.recording() as rec:
        idx = _build(args, rows, device)
    if args.kind == "ivfflat":
        shape = f"dtype={vecbin.dtype_name(idx.dtype_code)}"
    else:
        shape = f"m={idx.m} replicas={idx.replicas}"
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    idx.save(args.out)
    print(f"built {args.kind} nlist={idx.nlist} lcap={idx.lcap} {shape} over N={f.count} "
          f"in {dt:.2f}s on {device}; index_bytes={idx.index_bytes} "
          f"({idx.index_bytes / 1e6:.1f} MB) spilled={idx.n_spilled} -> {args.out}")
    for r in rec.records:
        if r.name.startswith("build."):
            a = r.attrs
            print(f"  {r.name}: {(r.end_ns - r.start_ns) / 1e9:.3f} s, rows={a['rows']} "
                  f"where={a['where']} h2d_bytes={a['h2d_bytes']} d2h_bytes={a['d2h_bytes']}")
    return idx


def _build(args, rows, device):
    """The index ``args`` ask for, built (or repacked) from ``rows``."""
    from nvdb_tpu_torch.index.ivf_flat import IVFFlatIndex
    from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex

    if args.repack_from and args.kind == "ivfpq":
        return IVFPQIndex.repack(IVFPQIndex.load(args.repack_from, device=device), rows,
                                 pad_factor=args.pad_factor,
                                 spill_candidates=args.spill_candidates, replicas=args.replicas)
    if args.repack_from:
        return IVFFlatIndex.repack(IVFFlatIndex.load(args.repack_from, device=device), rows,
                                   pad_factor=args.pad_factor,
                                   spill_candidates=args.spill_candidates)
    if args.kind == "ivfflat":
        return IVFFlatIndex.build(
            rows, nlist=args.nlist, dtype=args.dtype, train_size=args.train,
            n_iters=args.iters, pad_factor=args.pad_factor,
            spill_candidates=args.spill_candidates, seed=args.seed,
            corpus_refine_iters=args.corpus_refine, device=device)
    return IVFPQIndex.build(
        rows, nlist=args.nlist, m=args.pq_m, use_opq=args.opq, train_size=args.train,
        n_iters=args.iters, opq_iters=args.opq_iters, pad_factor=args.pad_factor,
        spill_candidates=args.spill_candidates, seed=args.seed,
        corpus_refine_iters=args.corpus_refine, device=device)

if __name__ == "__main__":
    main()
