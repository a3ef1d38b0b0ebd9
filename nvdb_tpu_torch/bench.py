"""Headline benchmark of the port: batched exact flat-scan top-k on the card.

    python -m nvdb_tpu_torch.bench [--n 1000000] [--d 768] [--batch 512]
        [--k 10] [--dtype f32|bf16|i8] [--qi8] [--iters 20] [--backend auto|torch]

The store is synthesized on the card in chunks from a seeded
``torch.Generator`` (Gaussian rows, as the JAX package's ``bench.py``), and
``dispatch.flat_topk`` scans it. After a warm-up, CUDA events time ``--iters``
chained scans; the time per scan is their span over the count.

Prints ONE JSON line to stdout: ``metric``, ``value`` (QPS), ``unit``,
``ms_per_scan``, ``gbps`` (padded store bytes streamed per second), ``device``
(the card's name) and ``power_limit_w``. Without a card it fails: it never
falls back to the CPU. Diagnostics go to stderr.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Optional, Sequence

import torch

from nvdb_tpu_torch.formats import vecbin
from nvdb_tpu_torch.index.flat import quantize_queries_i8
from nvdb_tpu_torch.kernels import dispatch, flat_scan
from nvdb_tpu_torch.store import VectorStore
from nvdb_tpu_torch.utils import round_up

_SYNTH_CHUNK = 1 << 18  # rows per synthesis chunk: bounds the f32 staging tensor


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def power_limit_w(device: torch.device) -> Optional[float]:
    """The card's power limit in watts, from nvidia-smi (None if unreadable)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(idx), "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def synth_store(n: int, d: int, dtype: str, device: torch.device, seed: int = 0,
                row_block: int = 4096) -> VectorStore:
    """A padded store of ``n`` Gaussian rows synthesized on ``device`` in
    chunks; chunk ``c`` draws from a generator seeded ``seed + c``."""
    code = vecbin.dtype_code(dtype)
    Np, Dp = round_up(n, row_block), round_up(d, 128)
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "i8": torch.int8}[dtype]
    vecs = torch.zeros((Np, Dp), dtype=tdt, device=device)
    scales = torch.ones((Np,), dtype=torch.float32, device=device) if dtype == "i8" else None
    for c, r0 in enumerate(range(0, n, _SYNTH_CHUNK)):
        r1 = min(r0 + _SYNTH_CHUNK, n)
        g = torch.Generator(device=device).manual_seed(seed + c)
        x = torch.randn((r1 - r0, d), generator=g, device=device, dtype=torch.float32)
        if dtype == "i8":
            amax = x.abs().amax(dim=1)
            sc = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
            vecs[r0:r1, :d] = torch.clamp(torch.round(x / sc[:, None]), -127, 127).to(torch.int8)
            scales[r0:r1] = sc
        else:
            vecs[r0:r1, :d] = x.to(tdt)
        del x
    return VectorStore(vecs, scales, n, d, code, code)


def synth_queries(count: int, store: VectorStore, seed: int = 1) -> torch.Tensor:
    """[count, Dp] Gaussian f32 queries on the store's device (padding dims zero)."""
    g = torch.Generator(device=store.device).manual_seed(seed)
    q = torch.zeros((count, store.d_padded), dtype=torch.float32, device=store.device)
    q[:, :store.d] = torch.randn((count, store.d), generator=g, device=store.device)
    return q


def time_scan(store: VectorStore, qpool: Sequence[torch.Tensor], k: int,
              backend: str = "auto", qi8: bool = False, iters: int = 20,
              warmup: int = 2, f32_kernel: Optional[str] = None) -> float:
    """Milliseconds per scan over ``iters`` chained scans (CUDA events),
    cycling through the query batches of ``qpool``. ``f32_kernel`` (an f32
    store only) calls the kernel's wrapper with that pass-1 kernel, the
    SIMT A/B (``"simt"``) or the default (``"tensor_core"``)."""
    if qi8:
        batches = [quantize_queries_i8(q) for q in qpool]
    else:
        batches = [(q, None) for q in qpool]

    def run(i):
        q, qs = batches[i % len(batches)]
        if f32_kernel is not None:
            return flat_scan.flat_topk_cuda(q, store.vectors, store.scales, store.n, k,
                                            f32_kernel=f32_kernel)
        return dispatch.flat_topk(q, store.vectors, store.scales, store.n, k,
                                  backend=backend, query_scales=qs)

    for i in range(warmup):
        run(i)
    torch.cuda.synchronize(store.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        run(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--dtype", default="bf16", choices=["f32", "bf16", "i8"])
    ap.add_argument("--qi8", action="store_true",
                    help="with --dtype i8: quantize queries too (int8 x int8, "
                         "exact int32 sums)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--backend", default="auto", choices=["auto", "torch"],
                    help="auto: the CUDA kernel; torch: the plain PyTorch ops")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.qi8 and args.dtype != "i8":
        ap.error("--qi8 requires --dtype i8")
    if not torch.cuda.is_available():
        log("error: no CUDA device; the headline is measured on the card only")
        sys.exit(1)
    device = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(device)
    plim = power_limit_w(device)

    store = synth_store(args.n, args.d, args.dtype, device, seed=args.seed)
    B = args.batch
    qall = synth_queries(4 * B, store, seed=args.seed + 1)
    qpool = [qall[i * B:(i + 1) * B] for i in range(4)]
    ms = time_scan(store, qpool, args.k, backend=args.backend, qi8=args.qi8,
                   iters=args.iters)

    qps = B / ms * 1e3
    gbps = store.hbm_bytes / ms / 1e6
    dt = "i8xi8" if args.qi8 else args.dtype
    log(f"{dt} {args.n}x{args.d} B={B} k={args.k} backend={args.backend}: "
        f"{ms:.4f} ms/scan {qps:.1f} QPS {gbps:.1f} GB/s on {name} ({plim} W limit)")
    line = {
        "metric": f"torch_flatscan_{dt}_{args.n // 1000}Kx{args.d}_b{B}_k{args.k}_qps",
        "value": qps,
        "unit": "QPS",
        "ms_per_scan": ms,
        "gbps": gbps,
        "backend": args.backend,
        "device": name,
        "power_limit_w": plim,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
