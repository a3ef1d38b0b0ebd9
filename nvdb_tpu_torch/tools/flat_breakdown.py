"""Where the flat tensor-core kernel's time goes: the scan is timed with
four builds of ``csrc/flat_topk.cu``, three of them measurement builds
(``NVDB_FLAT_ABLATE``; the library that the port loads takes none):

1. ``ring``: no filter, the TMA ring and the ``wgmma`` products alone
   (results wrong by design);
2. ``compares``: every score held against thresholds that never rise, the
   candidates dropped (the most the compares can cost; results wrong);
3. ``counters``: the kernel's results, with SM clock reads around each part
   of a tile's candidate handling and counts of tiles and candidates;
4. ``kernel``: the kernel as the port loads it.

    python -m nvdb_tpu_torch.tools.flat_breakdown [--n 1000000] [--d 768]
        [--batch 512 8] [--k 10] [--dtype bf16|i8|f32] [--qi8] [--iters 10]

The store is synthesized on the card as ``nvdb_tpu_torch.bench`` does. Each
build is timed twice in turns with CUDA events over ``--iters`` chained
scans and prints ``RESULT build=NAME batch=B ms=... device=...
power_limit_w=...``. Then the counter build scans each batch of the pool
once and prints ``RESULT build=counters``: warp-tiles (``tiles``), the share
whose thresholds a bound published by the slices raised
(``tightened_share``), the share that took the overflow rescan
(``overflow_share``), candidates drained and groups walked a warp-tile, and
the share of a warp's tile cycles spent waiting for the tile's last
products, in the compares and votes, in the marks, walk and pushes, in the
drains, reloads and publications, and in the overflow rescans. Last,
``RESULT build=split`` puts the kernel's time above the ring into those
parts in proportion to their cycles (``split``): ring alone, + compares, +
walk and push, + drain (the kernel), and the rescan's share of the kernel.
``main`` returns the records. Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
from concurrent.futures import ThreadPoolExecutor

from nvdb_tpu_torch.eval.stats import result_line
from nvdb_tpu_torch.tools import _ab
from nvdb_tpu_torch.tools._common import fail

BUILDS = (("ring", ("NVDB_FLAT_ABLATE=1",)), ("compares", ("NVDB_FLAT_ABLATE=2",)),
          ("counters", ("NVDB_FLAT_ABLATE=3",)), ("kernel", ()))
# enum Counter of csrc/flat_topk.cu, in its order
COUNTERS = ("tiles", "tightened", "overflow_tiles", "drained", "walked_groups", "cyc_tile",
            "cyc_wait", "cyc_compare", "cyc_walk", "cyc_drain", "cyc_rescan")
# the parts of a tile's candidate handling, in the order they run
PARTS = ("compare", "walk", "drain", "rescan")


def split(ring_ms: float, kernel_ms: float, counts: dict) -> dict:
    """The kernel's time above the ring alone, put into the parts of the
    candidate handling in proportion to the warps' cycles in each: the
    cumulative times ring, + compares and votes, + marks, walk and pushes,
    + drains, reloads and rescans (the kernel), and the rescans' share of
    the kernel's time."""
    cyc = {p: counts[f"cyc_{p}"] for p in PARTS}
    total = sum(cyc.values())
    above = kernel_ms - ring_ms
    part = {p: (above * cyc[p] / total if total else 0.0) for p in PARTS}
    return dict(ring_ms=ring_ms,
                compares_ms=ring_ms + part["compare"],
                walk_ms=ring_ms + part["compare"] + part["walk"],
                kernel_ms=kernel_ms,
                rescan_ms=part["rescan"],
                rescan_share=part["rescan"] / kernel_ms if kernel_ms else 0.0)


def counter_fields(counts: dict) -> dict:
    """The counter build's sums as a RESULT line's fields: warp-tiles, the
    shares of them that engaged (drained under the next tile's products) and
    overflowed, candidates drained a warp-tile, and each part's share of the
    warps' tile cycles."""
    tiles = max(counts["tiles"], 1)
    cyc_tile = max(counts["cyc_tile"], 1)
    out = dict(tiles=counts["tiles"], tightened_share=counts["tightened"] / tiles,
               overflow_share=counts["overflow_tiles"] / tiles,
               drained_per_tile=counts["drained"] / tiles,
               walked_groups_per_tile=counts["walked_groups"] / tiles)
    for p in ("wait",) + PARTS:
        out[f"{p}_cyc_share"] = counts[f"cyc_{p}"] / cyc_tile
    return out


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
    with ThreadPoolExecutor(len(BUILDS)) as ex:   # one nvcc each, side by side
        list(ex.map(lambda b: _build.build("flat_topk", b[1]), BUILDS))
    entries = {}
    for build, defines in BUILDS:
        fn = _build.load("flat_topk", defines).nvdb_flat_topk
        fn.argtypes = flat_scan.ARGTYPES
        fn.restype = ctypes.c_int
        entries[build] = fn
    read_counters = _build.load("flat_topk", dict(BUILDS)["counters"]).nvdb_flat_counters
    read_counters.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read_counters.restype = ctypes.c_int
    sums = (ctypes.c_ulonglong * len(COUNTERS))()

    def counters(reset):
        rc = read_counters(ctypes.cast(sums, ctypes.c_void_p), int(reset))
        if rc != 0:
            fail(f"reading the flat kernel's counters failed: cudaError_t {rc}")
        return dict(zip(COUNTERS, sums))

    store = synth_store(args.n, args.d, args.dtype, dev, seed=args.seed)
    port_lib = flat_scan._lib
    results = []
    common = dict(dtype=("i8xi8" if args.qi8 else args.dtype), n=args.n, d=args.d, k=args.k)
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
            ms = {build: sum(r) / 2 for build, r in runs.items()}
            for build, _ in BUILDS:
                rec = dict(build=build, batch=b, ms=ms[build],
                           ms_runs="/".join(f"{x:.4f}" for x in runs[build]), **common,
                           **dev_kv)
                print(result_line(**rec), flush=True)
                results.append(rec)
            flat_scan._lib = lambda fn=entries["counters"]: fn
            counters(reset=True)
            time_scan(store, qpool, args.k, qi8=args.qi8, iters=len(qpool), warmup=0)
            counts = counters(reset=True)
            for rec in (dict(build="counters", batch=b, scans=len(qpool),
                             **counter_fields(counts)),
                        dict(build="split", batch=b, **split(ms["ring"], ms["kernel"], counts))):
                rec.update(common, **dev_kv)
                print(result_line(**rec), flush=True)
                results.append(rec)
    finally:
        flat_scan._lib = port_lib
    return results


if __name__ == "__main__":
    main()
