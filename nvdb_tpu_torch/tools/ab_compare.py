"""Paired A/B latency comparison with a 95% confidence interval, the
reference's CUDA-kernel methodology (paired runs, 30 pairs, 95% CI,
Performance_CUDA.md:77-111): the port of ``nvdb_tpu.tools.ab_compare``.

    python -m nvdb_tpu_torch.tools.ab_compare base.vecbin q.vecbin [--k 10] \\
        [--batch-q 8] [--pairs 30] [--a cuda|torch] [--b cuda|torch] [--device cuda|cpu]

Two flat-scan backends (``cuda``: the flat kernel; ``torch``: its plain
version) run interleaved (A, B, A, B, ...) on the same store and queries,
both warmed up first. Each timed search ends in its copy to the host. It
prints the mean of the per-pair deltas with its normal-approximation 95%
CI, whether the interval excludes zero, and a ``RESULT`` line with the JAX
tool's keys (``ab_a``, ``ab_b``, ``pairs``, ``mean_delta_ms``, ``ci_half_ms``).
"""

from __future__ import annotations

import math
import time

import numpy as np

from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.tools._common import make_parser, setup_device


def main(argv=None):
    p = make_parser(__doc__)
    p.add_argument("base")
    p.add_argument("query")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--batch-q", type=int, default=8)
    p.add_argument("--pairs", type=int, default=30)
    p.add_argument("--a", default="cuda", choices=["cuda", "torch"])
    p.add_argument("--b", default="torch", choices=["cuda", "torch"])
    args = p.parse_args(argv)
    device = setup_device(args)

    from nvdb_tpu_torch.index.flat import FlatIndex
    from nvdb_tpu_torch.store import VectorStore

    store = VectorStore.from_vecbin(args.base, device=device)
    queries = vecbin.VecbinFile(args.query).rows_f32()[:args.batch_q]

    idx_a = FlatIndex(store, backend=args.a)
    idx_b = FlatIndex(store, backend=args.b)
    for idx in (idx_a, idx_b):  # load the kernels, warm up both before pairing
        idx.search(queries, args.k)

    deltas = []
    for _ in range(args.pairs):
        t0 = time.perf_counter()
        idx_a.search(queries, args.k)
        ta = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        idx_b.search(queries, args.k)
        tb = (time.perf_counter() - t0) * 1e3
        deltas.append(ta - tb)

    d = np.asarray(deltas)
    mean = float(d.mean())
    half = 1.96 * float(d.std(ddof=1)) / math.sqrt(len(d))
    verdict = ("A faster" if mean + half < 0 else
               "B faster" if mean - half > 0 else "no significant difference")
    print(f"pairs={len(d)} batch_q={args.batch_q} k={args.k}")
    print(f"mean(A-B) = {mean:+.4f} ms  95% CI [{mean - half:+.4f}, {mean + half:+.4f}]")
    print(f"verdict: {verdict}")
    print(f"RESULT ab_a={args.a} ab_b={args.b} pairs={len(d)} "
          f"mean_delta_ms={mean:.6f} ci_half_ms={half:.6f}")
    return dict(ab_a=args.a, ab_b=args.b, pairs=len(d), mean_delta_ms=mean,
                ci_half_ms=half, verdict=verdict)


if __name__ == "__main__":
    main()
