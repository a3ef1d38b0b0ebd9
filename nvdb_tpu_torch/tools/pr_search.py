"""Load a saved partition index and print the top-k ids of each query, the
nvdb_hnsw_search analogue (the port of ``nvdb_tpu.tools.pr_search``);
``--nprobe`` is the efSearch-analogue knob.

    python -m nvdb_tpu_torch.tools.pr_search index.npz q.vecbin [--k 10] \\
        [--nprobe 64] [--base base.vecbin --rerank-k 50] [--device cuda|cpu]
"""

from __future__ import annotations

from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.tools._common import make_parser, setup_device


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("index")
    p.add_argument("query")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--nprobe", type=int, default=64)
    p.add_argument("--base", default=None, help="base vecbin to enable exact rerank")
    p.add_argument("--rerank-k", type=int, default=0)
    args = p.parse_args(argv)
    device = setup_device(args)

    from nvdb_tpu_torch.index.partition import PartitionRerankIndex

    refine_rows = vecbin.VecbinFile(args.base).rows_f32() if args.base else None
    idx = PartitionRerankIndex.load(args.index, refine_rows=refine_rows, device=device)
    qf = vecbin.VecbinFile(args.query)
    vals, ids = idx.search(qf.rows_f32(), args.k, args.nprobe, rerank_k=args.rerank_k,
                           backend=args.backend)
    for qi in range(ids.shape[0]):
        print(f"query {qi}: " + " ".join(
            f"{ids[qi, r]}({vals[qi, r]:.4f})" for r in range(args.k)))
    return vals, ids


if __name__ == "__main__":
    main()
