"""Take the first N rows of a vecbin into a new file, streamed in chunks:
the port of ``nvdb_tpu.tools.slice`` (the nvdb_slice analogue,
tools/nvdb_slice.cpp:54-70).

    python -m nvdb_tpu_torch.tools.slice src.vecbin out.vecbin --n 65536 [--raw12]

Host only; writes the JAX tool's file byte for byte, in the source's dtype
(int8 with its scales), or legacy raw12 f32 with ``--raw12``.
"""

from __future__ import annotations

import numpy as np

from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.tools._common import make_parser


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("src")
    p.add_argument("out")
    p.add_argument("--n", type=int, required=True)
    p.add_argument("--raw12", action="store_true",
                   help="write legacy raw12 f32 output (reference behaviour)")
    args = p.parse_args(argv)

    f = vecbin.VecbinFile(args.src)
    n = min(args.n, f.count)
    if args.raw12:
        vecbin.write_vecbin(args.out, f.rows_f32(0, n), legacy_raw12=True)
    else:
        with vecbin.StreamingVecbinWriter(args.out, f.dim, f.info.dtype_str) as w:
            chunk = 262144
            for s in range(0, n, chunk):
                e = min(s + chunk, n)
                sc = np.asarray(f.scales[s:e]) if f.scales is not None else None
                w.append(np.asarray(f.vectors[s:e]), sc)
    print(f"wrote first {n} rows -> {args.out}")
    return n


if __name__ == "__main__":
    main()
