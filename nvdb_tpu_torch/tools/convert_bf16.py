"""FP32 vecbin -> BF16 vecbin (round to nearest even), the port of
``nvdb_tpu.tools.convert_bf16`` (the reference's f32 -> f16 converter,
tools/nvdb_convert_f16.cpp:20-119; bf16 is the tensor cores' half type).

    python -m nvdb_tpu_torch.tools.convert_bf16 src.vecbin out.vecbin [--f16]

Runs on the host (the threaded native converter of ``nvdb_tpu_torch.native``)
and writes the JAX tool's file byte for byte. ``--f16`` writes IEEE float16
(dtype 2), which the reference's own readers take.
"""

from __future__ import annotations

import numpy as np

from nvdb_tpu_torch import native
from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.tools._common import make_parser


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("src")
    p.add_argument("out")
    p.add_argument("--f16", action="store_true",
                   help="write IEEE float16 (dtype=2) instead of bf16 — "
                        "bit-compatible with the reference's own readers")
    args = p.parse_args(argv)

    f = vecbin.VecbinFile(args.src)
    chunk = 262144
    name = "f16" if args.f16 else "bf16"
    with vecbin.StreamingVecbinWriter(args.out, f.dim, name) as w:
        for s in range(0, f.count, chunk):
            rows = f.rows_f32(s, min(s + chunk, f.count))
            w.append(rows.astype(np.float16) if args.f16
                     else native.convert_f32_to_bf16(rows))
    out = vecbin.VecbinFile(args.out)
    print(f"wrote {out.count} x {out.dim} {name} -> {args.out}")
    return out.info


if __name__ == "__main__":
    main()
