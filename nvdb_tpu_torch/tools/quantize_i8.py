"""FP32/BF16 vecbin -> INT8 (+ per-row scale) vecbin with symmetric
max-abs / 127 scaling, the nvdb_quantize_i8 analogue (the port of
``nvdb_tpu.tools.quantize_i8``, apps/nvdb_quantize_i8.cpp:49-85).

    python -m nvdb_tpu_torch.tools.quantize_i8 base.vecbin base_i8.vecbin \\
        [--residual index.npz]

``--residual INDEX``: quantize each row's residual against its list's
coarse centroid of an IVF(-PQ) index, in the index's padded, rotated space,
instead of the raw row. The output is an i8 vecbin of residual codes of dim
Dp; pair it with the same index (``VectorStore.attach_residual``,
``ivf_eval --residual-refine``) and score it with rotated queries. The
arithmetic is numpy's on the host (the rotation one f32 product per chunk),
as the JAX tool's numpy fallback, so the file is byte-equal to that tool's.
The tools' common flags (``--device``, ``--cpu``, ``--backend``,
``--debug-nans``) are accepted, as the JAX tool accepts its own, and change
nothing: no kernel runs here.
"""

from __future__ import annotations

import numpy as np

from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.tools._common import fail, make_parser

CHUNK = 262144


def residual_params(index_path: str):
    """(cents [nlist, Dp] f32, rotation [Dp, Dp] f32 | None, list_of [n]
    int32): what a residual encode or attach needs, read from the index's
    ``.npz`` on the host."""
    z = np.load(index_path)
    cents = np.asarray(z["centroids"], np.float32)
    rot = (np.asarray(z["rotation"], np.float32)
           if "rotation" in z and z["rotation"].ndim == 2 else None)
    sids = np.asarray(z["slot_ids"])
    n = int(np.asarray(z["meta"])[0]) if "meta" in z else int(sids.max()) + 1
    li, si = np.nonzero(sids >= 0)
    list_of = np.zeros(n, np.int32)
    list_of[sids[li, si]] = li.astype(np.int32)
    return cents, rot, list_of


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("src")
    p.add_argument("out")
    p.add_argument("--residual", default=None, metavar="INDEX",
                   help="quantize residuals against this IVF(-PQ) index's coarse "
                        "centroids (rotated space); pair the output with the same "
                        "index at load time")
    args = p.parse_args(argv)

    f = vecbin.VecbinFile(args.src)
    cents = rot = list_of = None
    out_dim = f.dim
    if args.residual:
        cents, rot, list_of = residual_params(args.residual)
        if list_of.shape[0] != f.count:
            fail(f"index rows ({list_of.shape[0]}) != vecbin rows ({f.count}); "
                 f"wrong index for this base?")
        out_dim = cents.shape[1]   # the index's padded dim
    with vecbin.StreamingVecbinWriter(args.out, out_dim, "i8") as w:
        for s in range(0, f.count, CHUNK):
            rows = f.rows_f32(s, min(s + CHUNK, f.count))
            if args.residual:
                if rows.shape[1] != out_dim:
                    rows = np.pad(rows, ((0, 0), (0, out_dim - rows.shape[1])))
                if rot is not None:
                    rows = rows @ rot
                rows = rows - cents[list_of[s:s + rows.shape[0]]]
            w.append(*vecbin.quantize_i8(rows))
    out = vecbin.VecbinFile(args.out)
    kind = "residual-i8" if args.residual else "i8"
    print(f"wrote {out.count} x {out.dim} {kind}(+scale) -> {args.out}")
    return out


if __name__ == "__main__":
    main()
