"""Where the ADC scan's time goes: ``adc_topk_cuda`` is timed with three
builds of ``csrc/adc_topk.cu``, two of them measurement builds
(``NVDB_ADC_ABLATE``) whose results are wrong by design:

1. ``staging``: each probe's table (and code tile) brought into shared
   memory, nothing looked up;
2. ``lookups``: staging and every slot's M lookups and sums, no candidate
   kept (no append, no compaction);
3. ``kernel``: the kernel as the port loads it.

    python -m nvdb_tpu_torch.tools.adc_breakdown [--batch 256 8] [--nprobe 64]
        [--kk 100] [--m 96] [--lcap 640] [--nlist 4096] [--iters 10]

The index is random and made on the card: prefix-packed lists whose fills
are uniform in [0.6 Lcap, Lcap] (a live share of 0.8, the flagship
build's), random codes, distinct random probes per query, bf16 tables
uniform in [0, 4). Each build is timed twice in turns with CUDA events over
``--iters`` chained calls and prints ``RESULT build=NAME batch=B ms=...
device=... power_limit_w=...``; ``main`` returns those records. Without a
card it exits 1.
"""

from __future__ import annotations

import argparse

from nvdb_tpu_torch.eval.stats import result_line
from nvdb_tpu_torch.tools import _ab
from nvdb_tpu_torch.tools._common import fail

BUILDS = (("staging", ("NVDB_ADC_ABLATE=1",)), ("lookups", ("NVDB_ADC_ABLATE=2",)),
          ("kernel", ()))


def random_index(torch, dev, nlist: int, m: int, lcap: int, seed: int):
    """(codes [nlist, M, Lcap] uint8, slot_ids [nlist, Lcap] int32, fills
    [nlist] int32) of a prefix-packed random index on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(0, 256, (nlist, m, lcap), generator=g, device=dev,
                          dtype=torch.uint8)
    lo = int(0.6 * lcap)
    fills = torch.randint(lo, lcap + 1, (nlist,), generator=g, device=dev).to(torch.int32)
    lane = torch.arange(lcap, device=dev, dtype=torch.int32)[None, :]
    ids = torch.arange(nlist, device=dev, dtype=torch.int32)[:, None] * lcap + lane
    slot_ids = torch.where(lane < fills[:, None], ids, -1).contiguous()
    return codes, slot_ids, fills


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, nargs="+", default=[256, 8])
    p.add_argument("--nprobe", type=int, default=64)
    p.add_argument("--kk", type=int, default=100)
    p.add_argument("--m", type=int, default=96)
    p.add_argument("--lcap", type=int, default=640)
    p.add_argument("--nlist", type=int, default=4096)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the breakdown is measured on a GPU only")
    from nvdb_tpu_torch.kernels import _build, adc_scan

    dev = torch.device("cuda", torch.cuda.current_device())
    dev_kv = _ab.device_fields(dev)
    entries = {}
    for build, defines in BUILDS:
        fn = _build.load("adc_topk", defines).nvdb_adc_topk
        adc_scan.bind_adc_topk(fn)
        entries[build] = fn

    codes, slot_ids, fills = random_index(torch, dev, args.nlist, args.m, args.lcap,
                                          args.seed)
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    port_lib = adc_scan._lib
    results = []
    try:
        for b in args.batch:
            lut = (torch.rand((b, args.nprobe, args.m, 256), generator=g, device=dev)
                   * 4.0).to(torch.bfloat16)
            probes = torch.stack([torch.randperm(args.nlist, generator=g, device=dev)
                                  [:args.nprobe] for _ in range(b)]).to(torch.int32)
            live = float(fills[probes.long()].sum()) / (b * args.nprobe * args.lcap)

            def run():
                adc_scan.adc_topk_cuda(lut, probes, codes, slot_ids, args.kk, fills=fills)

            runs = {build: [] for build, _ in BUILDS}
            for _ in range(2):
                for build, _ in BUILDS:
                    adc_scan._lib = lambda fn=entries[build]: fn
                    run()
                    torch.cuda.synchronize(dev)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(args.iters):
                        run()
                    end.record()
                    end.synchronize()
                    runs[build].append(start.elapsed_time(end) / args.iters)
            for build, _ in BUILDS:
                rec = dict(build=build, batch=b, ms=sum(runs[build]) / 2,
                           ms_runs="/".join(f"{x:.4f}" for x in runs[build]),
                           nprobe=args.nprobe, m=args.m, lcap=args.lcap, kk=args.kk,
                           live_share=round(live, 4), **dev_kv)
                print(result_line(**rec), flush=True)
                results.append(rec)
            del lut, probes
    finally:
        adc_scan._lib = port_lib
    return results


if __name__ == "__main__":
    main()
