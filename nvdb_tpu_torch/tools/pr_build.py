"""Build and save a partition-then-rerank index, the nvdb_hnsw_build
analogue (the port of ``nvdb_tpu.tools.pr_build``): the build knob is the
partition count (``--nlist``, the M / efConstruction analogue; default the
sqrt-auto count).

    python -m nvdb_tpu_torch.tools.pr_build base.vecbin index.npz [--nlist N] \\
        [--dtype bf16] [--device cuda|cpu]

The ``.npz`` is the IVF-Flat file of the partitions and loads in either
package.
"""

from __future__ import annotations

import time

from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.tools._common import make_parser, setup_device


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("base")
    p.add_argument("out")
    p.add_argument("--nlist", type=int, default=None, help="None = sqrt-auto")
    p.add_argument("--dtype", default="bf16", choices=["f32", "bf16", "i8"])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    device = setup_device(args)

    from nvdb_tpu_torch.index.partition import PartitionRerankIndex

    f = vecbin.VecbinFile(args.base)
    t0 = time.perf_counter()
    idx = PartitionRerankIndex.build(f.rows_f32(), nlist=args.nlist, dtype=args.dtype,
                                     with_refine=False, n_iters=args.iters, seed=args.seed,
                                     device=device)
    idx.save(args.out)
    print(f"built partitions={idx.ivf.nlist} lcap={idx.ivf.lcap} over N={f.count} in "
          f"{time.perf_counter() - t0:.2f}s on {device}; "
          f"index_MB={idx.index_bytes / 1e6:.1f} -> {args.out}")
    return idx


if __name__ == "__main__":
    main()
