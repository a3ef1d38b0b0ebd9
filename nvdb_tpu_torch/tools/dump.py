"""Print a vecbin's header and its first rows, a format smoke test: the port
of ``nvdb_tpu.tools.dump`` (the nvdb_dump analogue, apps/nvdb_dump.cpp).

    python -m nvdb_tpu_torch.tools.dump file.vecbin [--rows 3] [--cols 8]

Host only; prints what the JAX tool prints.
"""

from __future__ import annotations

import numpy as np

from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.tools._common import make_parser


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("path")
    p.add_argument("--rows", type=int, default=3)
    p.add_argument("--cols", type=int, default=8)
    args = p.parse_args(argv)

    f = vecbin.VecbinFile(args.path)
    print(f"path={args.path}")
    print(f"count={f.count} dim={f.dim} dtype={f.info.dtype_str}"
          f" legacy_raw12={int(f.info.legacy_raw12)}")
    n = min(args.rows, f.count)
    rows = f.rows_f32(0, n)
    for i in range(n):
        head = " ".join(f"{v:+.6f}" for v in rows[i, :args.cols])
        print(f"row{i}: {head}{' ...' if f.dim > args.cols else ''}")
    if f.scales is not None:
        print("scales:", " ".join(f"{s:.6g}" for s in np.asarray(f.scales[:n])))
    return rows


if __name__ == "__main__":
    main()
