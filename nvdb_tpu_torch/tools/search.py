"""Run a few queries through the exact flat index and print their top-k ids
and scores: the port of ``nvdb_tpu.tools.search`` (the nvdb_search
analogue, apps/nvdb_search.cpp:26-40).

    python -m nvdb_tpu_torch.tools.search base.vecbin q.vecbin [--k 10] [--q 1] \\
        [--device cuda|cpu] [--backend auto|cuda|torch]

On a card ``FlatIndex.search`` runs the flat kernel.
"""

from __future__ import annotations

from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.tools._common import make_parser, setup_device


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("base")
    p.add_argument("query")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--q", type=int, default=1, help="number of queries to run")
    args = p.parse_args(argv)
    device = setup_device(args)

    from nvdb_tpu_torch.index.flat import FlatIndex
    from nvdb_tpu_torch.store import VectorStore

    store = VectorStore.from_vecbin(args.base, device=device)
    qf = vecbin.VecbinFile(args.query)
    queries = qf.rows_f32(0, min(args.q, qf.count))
    vals, ids = FlatIndex(store, backend=args.backend).search(queries, args.k)
    for qi in range(queries.shape[0]):
        print(f"query {qi}:")
        for rank in range(args.k):
            print(f"  #{rank}: id={ids[qi, rank]} score={vals[qi, rank]:.6f}")
    return vals, ids


if __name__ == "__main__":
    main()
