"""Sample random rows of a vecbin, check them for NaN / Inf and print their
L2 norms, cheap invariants of L2-normalized embeddings: the port of
``nvdb_tpu.tools.sanity`` (the nvdb_sanity analogue, apps/nvdb_sanity.cpp:32-47).

    python -m nvdb_tpu_torch.tools.sanity file.vecbin [--samples 8] [--seed 12345]

Host only; the same rows as the JAX tool (the same numpy draw). Exits 2 when
a sampled row is not finite.
"""

from __future__ import annotations

import sys

import numpy as np

from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.tools._common import make_parser


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("path")
    p.add_argument("--samples", type=int, default=8)
    p.add_argument("--seed", type=int, default=12345)
    args = p.parse_args(argv)

    f = vecbin.VecbinFile(args.path)
    rng = np.random.default_rng(args.seed)
    idx = rng.integers(0, f.count, size=min(args.samples, f.count))
    bad = 0
    norms = {}
    for i in sorted(idx.tolist()):
        row = f.rows_f32(i, i + 1)[0]
        finite = np.isfinite(row).all()
        bad += not finite
        norms[i] = float(np.linalg.norm(row))
        print(f"row {i}: norm={norms[i]:.6f} finite={int(finite)}")
    if bad:
        print(f"FAIL: {bad} rows with NaN/Inf", file=sys.stderr)
        sys.exit(2)
    print("OK")
    return norms


if __name__ == "__main__":
    main()
