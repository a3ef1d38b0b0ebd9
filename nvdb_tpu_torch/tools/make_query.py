"""Sample Q unique random base rows into an FP32 query vecbin (seeded,
optionally perturbed and re-normalized; prints the chosen rows): the port
of ``nvdb_tpu.tools.make_query`` (the nvdb_make_query analogue,
tools/nvdb_make_query.cpp:56-114).

    python -m nvdb_tpu_torch.tools.make_query base.vecbin q.vecbin --q 1024 \\
        [--seed 777] [--perturb 0.05] [--raw12]

Host only; writes the JAX tool's file byte for byte (the same numpy draw).
"""

from __future__ import annotations

from nvdb_tpu_torch.formats import synth, vecbin
from nvdb_tpu_torch.tools._common import make_parser


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("base")
    p.add_argument("out")
    p.add_argument("--q", type=int, required=True)
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--perturb", type=float, default=0.0,
                   help="optional noise (re-normalized) so queries aren't exact rows")
    p.add_argument("--raw12", action="store_true")
    args = p.parse_args(argv)

    f = vecbin.VecbinFile(args.base)
    queries, idx = synth.sample_queries(f.rows_f32(), args.q, seed=args.seed,
                                        perturb=args.perturb)
    vecbin.write_vecbin(args.out, queries, legacy_raw12=args.raw12)
    shown = idx.tolist()
    suffix = ""
    if len(shown) > 32:
        shown, suffix = shown[:32], f" ... ({len(idx)} total)"
    print("chosen_indices:", " ".join(map(str, shown)) + suffix)
    print(f"wrote {args.q} x {f.dim} f32 queries -> {args.out}")
    return idx


if __name__ == "__main__":
    main()
