"""Where the flat tensor-core kernel's time goes: the scan is timed with
three builds of ``csrc/flat_topk.cu``, two of them measurement builds
(``NVDB_FLAT_ABLATE``) whose results are wrong by design:

1. ``ring``: no filter, the TMA ring and the ``wgmma`` products alone;
2. ``compares``: every score held against thresholds that never rise, the
   candidates dropped (the most the compares can cost);
3. ``kernel``: the kernel as the port loads it.

    python -m nvdb_tpu_torch.tools.flat_breakdown [--n 1000000] [--d 768]
        [--batch 512 8] [--k 10] [--dtype bf16|i8|f32] [--qi8] [--iters 10]

The store is synthesized on the card as ``nvdb_tpu_torch.bench`` does. Each
build is timed twice in turns with CUDA events over ``--iters`` chained
scans and prints ``RESULT build=NAME batch=B ms=... device=...
power_limit_w=...``; ``main`` returns those records. Without a card it
exits 1.
"""

from __future__ import annotations

import argparse
import ctypes

from nvdb_tpu_torch.eval.stats import result_line
from nvdb_tpu_torch.tools import _ab
from nvdb_tpu_torch.tools._common import fail

BUILDS = (("ring", ("NVDB_FLAT_ABLATE=1",)), ("compares", ("NVDB_FLAT_ABLATE=2",)),
          ("kernel", ()))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--d", type=int, default=768)
    p.add_argument("--batch", type=int, nargs="+", default=[512, 8])
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--dtype", default="bf16", choices=["bf16", "i8", "f32"],
                   help="the store type; f32 is the tensor-core instance (three-way bf16 "
                        "split), whose ring includes the split of each chunk")
    p.add_argument("--qi8", action="store_true", help="with --dtype i8: int8 queries too")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the breakdown is measured on a GPU only")
    from nvdb_tpu_torch.bench import synth_queries, synth_store, time_scan
    from nvdb_tpu_torch.kernels import _build, flat_scan

    dev = torch.device("cuda", torch.cuda.current_device())
    dev_kv = _ab.device_fields(dev)
    entries = {}
    for build, defines in BUILDS:
        fn = _build.load("flat_topk", defines).nvdb_flat_topk
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[build] = fn

    store = synth_store(args.n, args.d, args.dtype, dev, seed=args.seed)
    port_lib = flat_scan._lib
    results = []
    try:
        for b in args.batch:
            qall = synth_queries(4 * b, store, seed=args.seed + 1)
            qpool = [qall[i * b:(i + 1) * b] for i in range(4)]
            runs = {build: [] for build, _ in BUILDS}
            for _ in range(2):
                for build, _ in BUILDS:
                    flat_scan._lib = lambda fn=entries[build]: fn
                    runs[build].append(time_scan(store, qpool, args.k, qi8=args.qi8,
                                                 iters=args.iters))
            for build, _ in BUILDS:
                rec = dict(build=build, batch=b, ms=sum(runs[build]) / 2,
                           ms_runs="/".join(f"{x:.4f}" for x in runs[build]),
                           dtype=("i8xi8" if args.qi8 else args.dtype), n=args.n, d=args.d,
                           k=args.k, **dev_kv)
                print(result_line(**rec), flush=True)
                results.append(rec)
    finally:
        flat_scan._lib = port_lib
    return results


if __name__ == "__main__":
    main()
