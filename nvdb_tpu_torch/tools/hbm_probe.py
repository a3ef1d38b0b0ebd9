"""Measure the HBM stream rate this card achieves: three probes read the
same bf16 array (1M x 768 by default, rows rounded up to 4096: 1.54 GB) and
reduce it to its maximum (the port of ``scripts/hbm_probe.py``):

1. ``torch_amax``: PyTorch's own reduce, the vendor-tuned ceiling (the TPU
   script's ``xla_max``);
2. ``stream``: the grid-stride stream kernel, 16-byte loads, zero compute
   (``kern`` / ``kern_p``);
3. ``ring``: the cp.async ring kernel, four tiles in flight per CTA through
   shared memory (``kern_m``: does deeper buffering lift the rate?).

    python -m nvdb_tpu_torch.tools.hbm_probe [--n 1000000] [--d 768] [--iters 20]

Each probe is timed with CUDA events over ``--iters`` chained launches after
one warm-up and prints ``RESULT probe=NAME ms=... gbps=... device=...``;
``main`` returns those records. Each kernel's maximum must equal
``torch.amax``'s, or the tool exits 2. Without a card it exits 1: the
probe has no CPU stand-in.
"""

from __future__ import annotations

import argparse

from nvdb_tpu_torch.eval.stats import result_line
from nvdb_tpu_torch.tools._common import fail
from nvdb_tpu_torch.utils import round_up


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--d", type=int, default=768)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the HBM probe runs on a GPU only")
    from nvdb_tpu_torch.kernels import hbm_stream

    dev = torch.device("cuda", torch.cuda.current_device())
    n_pad, dp = round_up(args.n, 4096), round_up(args.d, 128)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.empty((n_pad, dp), dtype=torch.bfloat16, device=dev)
    for s in range(0, n_pad, 65536):
        e = min(s + 65536, n_pad)
        x[s:e] = torch.randn((e - s, dp), generator=g, device=dev).to(torch.bfloat16)
    nbytes = x.numel() * x.element_size()
    name = torch.cuda.get_device_name(dev).replace(" ", "_")
    want = hbm_stream.stream_max_reference(x)

    probes = [("torch_amax", hbm_stream.stream_max_reference),
              ("stream", hbm_stream.stream_max_cuda),
              ("ring", hbm_stream.ring_max_cuda)]
    results = []
    for probe, fn in probes:
        got = fn(x)
        torch.cuda.synchronize(dev)
        if not torch.equal(got, want):
            fail(f"probe {probe}: max {float(got)} != torch.amax {float(want)}", code=2)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn(x)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / args.iters
        rec = dict(probe=probe, ms=ms, gbps=nbytes / ms / 1e6, bytes=nbytes,
                   max=float(got), device=name)
        print(result_line(**rec), flush=True)
        results.append(rec)
    return results


if __name__ == "__main__":
    main()
