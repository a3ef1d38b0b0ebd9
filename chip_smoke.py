#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``nvdb_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the CUDA kernel from the sources
in the checkout, then, one phase per line group:

1. device: the card, ``nvidia-smi``'s name and power limit, torch and CUDA;
2. build: build seconds and each kernel's ptxas register / spill line;
3. kernel vs plain: the kernel against its plain PyTorch version and a
   float64 oracle on a 65,536 x 768 store (n_valid 65,000), every store
   type, B in {1, 8, 37, 512}, k in {1, 10, 128};
4. main path: ``FlatIndex.search`` of 512 queries, k = 10, over a 1M x 768
   bf16 store synthesized on the card, through ``dispatch.flat_topk``; the
   kernel's launch count is reset just before and must have risen; then
   ``tools.bench`` on a 262,144 x 384 f32 vecbin with float64 ground truth;
5. times: kernel and plain version in turns at 1M x 768, B = 512, k = 10 per
   store type and at B = 8 for bf16, and the headline line of
   ``nvdb_tpu_torch.bench``.

Every check raises on failure, so the exit code is non-zero if any phase
fails; nothing falls back to the CPU or to the plain version. Without a CUDA
device it exits 1 before printing any result. The last three lines are
``nvidia-smi``'s name and power limit, the kernels' JSON record, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

REGRET_TOL = 1e-5      # float64 score regret of the kernel's ids
VALUE_ATOL = 1e-5      # |kernel - plain| per value (f32 sums in another order),
VALUE_RTOL = 1e-5      # as in the repository's parity tests
ID_AGREE_MIN = 0.99    # share of positions where kernel and plain ids agree


def say(*a):
    print(*a, flush=True)


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def effective_f64(torch, dtype, q_f32, base_f32_t, store, scales, qq, qs):
    """float64 (queries, store) as the kernel's path sees them: bf16-rounded
    queries where the path rounds, the dequantized int8 store."""
    f64 = torch.float64
    if dtype == "f32":
        return q_f32.to(f64), base_f32_t.to(f64)
    if dtype == "bf16":
        return q_f32.to(torch.bfloat16).to(f64), store.to(f64)
    deq = store.to(f64) * scales.to(f64)[:, None]
    if dtype == "i8xi8":
        return qq.to(f64) * qs.to(f64)[:, None], deq
    return q_f32.to(torch.bfloat16).to(f64), deq


def regret(torch, s64, ids, k):
    ref = torch.topk(s64, k, dim=1).values
    got = torch.gather(s64, 1, ids.long())
    got = torch.sort(got, dim=1, descending=True).values
    return float((ref - got).max())


def phase_kernel_vs_plain(torch, dev):
    from nvdb_tpu_torch.formats import synth, vecbin
    from nvdb_tpu_torch.index.flat import quantize_queries_i8
    from nvdb_tpu_torch.kernels import flat_scan

    n_pad, n_valid, dp = 65536, 65000, 768
    base = torch.from_numpy(synth.normalized_gaussian(n_pad, dp, seed=11)).to(dev)
    qall = torch.from_numpy(synth.normalized_gaussian(512, dp, seed=12)).to(dev)
    max_err = 0.0
    for dtype in ("f32", "bf16", "i8", "i8xi8"):
        scales = qq = qs = None
        if dtype == "f32":
            store = base
        elif dtype == "bf16":
            store = base.to(torch.bfloat16)
        else:
            codes, sc = vecbin.quantize_i8(base.cpu().numpy())
            store = torch.from_numpy(codes).to(dev)
            scales = torch.from_numpy(sc).to(dev)
        if dtype == "i8xi8":
            qq, qs = quantize_queries_i8(qall)
        q64, s64_store = effective_f64(torch, dtype, qall, base, store, scales, qq, qs)
        s64_all = q64 @ s64_store[:n_valid].T
        for b in (1, 8, 37, 512):
            q = qq[:b] if qq is not None else qall[:b]
            qsb = qs[:b] if qs is not None else None
            for k in (1, 10, 128):
                kv, ki = flat_scan.flat_topk_cuda(q, store, scales, n_valid, k,
                                                  query_scales=qsb)
                torch.cuda.synchronize(dev)
                pv, pi = flat_scan.flat_topk_reference(q, store, scales, n_valid, k,
                                                       query_scales=qsb)
                tag = f"{dtype} B={b} k={k}"
                check(tuple(kv.shape) == (b, k) and tuple(ki.shape) == (b, k), f"{tag}: shape")
                check(bool(torch.isfinite(kv).all()), f"{tag}: non-finite values")
                check(bool(((ki >= 0) & (ki < n_valid)).all()), f"{tag}: id out of [0, n_valid)")
                check(bool((kv[:, 1:] <= kv[:, :-1]).all()), f"{tag}: values not sorted")
                r = regret(torch, s64_all[:b], ki, k)
                err = float((kv - pv).abs().max())
                agree = float((ki == pi).float().mean())
                check(r <= REGRET_TOL, f"{tag}: regret {r} > {REGRET_TOL}")
                check(bool(torch.allclose(kv, pv, atol=VALUE_ATOL, rtol=VALUE_RTOL)),
                      f"{tag}: values differ from plain by {err}")
                check(agree >= ID_AGREE_MIN, f"{tag}: id agreement {agree} < {ID_AGREE_MIN}")
                max_err = max(max_err, err)
                say(f"  {tag}: regret={r:.3e} max_abs_err={err:.3e} id_agree={agree:.4f}")
        del store, scales, s64_all, s64_store, q64
    del base, qall
    torch.cuda.empty_cache()
    return max_err


def phase_main_path(torch, dev):
    from nvdb_tpu_torch.bench import synth_store
    from nvdb_tpu_torch.formats import synth
    from nvdb_tpu_torch.index.flat import FlatIndex
    from nvdb_tpu_torch.kernels import flat_scan, ops

    n, d, b, k = 1_000_000, 768, 512, 10
    store = synth_store(n, d, "bf16", dev, seed=0)
    torch.cuda.synchronize(dev)
    queries = synth.normalized_gaussian(b, d, seed=13)
    index = FlatIndex(store)

    flat_scan.LAUNCHES = 0
    t0 = time.perf_counter()
    vals, ids = index.search(queries, k)
    wall = time.perf_counter() - t0
    launches = flat_scan.LAUNCHES
    say(f"  FlatIndex.search 1M x 768 bf16, B={b}, k={k}: launches={launches} "
        f"first-call wall {wall:.3f} s")
    check(launches > 0, "the main path did not launch the kernel")
    check(vals.shape == (b, k) and ids.shape == (b, k), "main path: shape")
    check(np.isfinite(vals).all(), "main path: non-finite values")
    check(((ids >= 0) & (ids < n)).all(), "main path: id out of [0, n)")

    q_t = torch.from_numpy(store.pad_queries(queries)).to(dev)
    pv, pi = ops.scan_topk(q_t, store.vectors, None, n, k)
    q64 = q_t.to(torch.bfloat16).to(torch.float64)

    def rescore(id_t):
        rows = store.vectors[id_t.long()].to(torch.float64)          # [b, k, Dp]
        s = torch.einsum("bd,bkd->bk", q64, rows)
        return torch.sort(s, dim=1, descending=True).values

    kern64 = rescore(torch.from_numpy(ids).to(dev))
    plain64 = rescore(pi)
    r = float((plain64 - kern64).max())
    err = float(np.abs(vals - pv.cpu().numpy()).max())
    agree = float(np.mean(ids == pi.cpu().numpy()))
    say(f"  vs plain: regret={r:.3e} max_abs_err={err:.3e} id_agree={agree:.4f}")
    check(r <= REGRET_TOL, f"main path: regret {r} against the plain version")
    del store, index, q_t, pv, pi
    torch.cuda.empty_cache()
    return launches


def phase_tools_bench(torch, dev):
    from nvdb_tpu_torch.formats import gtbin, synth, vecbin
    from nvdb_tpu_torch.index.flat import FlatIndex
    from nvdb_tpu_torch.store import VectorStore
    from nvdb_tpu_torch.tools import bench as bench_tool

    n, d, nq, k = 262_144, 384, 64, 10
    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    try:
        base = synth.normalized_gaussian(n, d, seed=21)
        queries, _ = synth.sample_queries(base, nq, seed=22, perturb=0.05)
        s64 = queries.astype(np.float64) @ base.astype(np.float64).T
        gt = np.argsort(-s64, axis=1, kind="stable")[:, :k]
        paths = {x: os.path.join(work, f"{x}.{'gtbin' if x == 'gt' else 'vecbin'}")
                 for x in ("base", "q", "gt")}
        vecbin.write_vecbin(paths["base"], base)
        vecbin.write_vecbin(paths["q"], queries)
        gtbin.write_gtbin(paths["gt"], gt, dim=d, N=n)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            recall = bench_tool.main([paths["base"], paths["q"], str(k), "--batch-q", "16",
                                      "--gt", paths["gt"]])
        for line in buf.getvalue().splitlines():
            if line.startswith(("N=", "recall@", "RESULT")):
                say(f"  {line}")
        if recall < 1.0:
            # near-ties may swap ids between f32 and float64: judge by regret
            idx = FlatIndex(VectorStore.from_vecbin(paths["base"], device=dev))
            _, ids = idx.search(queries, k)
            got = np.sort(np.take_along_axis(s64, ids.astype(np.int64), axis=1), axis=1)
            ref = np.sort(np.take_along_axis(s64, gt, axis=1), axis=1)
            r = float(np.max(ref - got))
            say(f"  recall {recall:.4f} < 1: regret {r:.3e}")
            check(r <= REGRET_TOL, f"tools.bench: regret {r}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_times(torch, dev):
    from nvdb_tpu_torch import bench as headline
    from nvdb_tpu_torch.bench import synth_queries, synth_store, time_scan

    n, d, k, iters = 1_000_000, 768, 10, 10
    cases = [("f32", 512, False), ("bf16", 512, False), ("i8", 512, False),
             ("i8", 512, True), ("bf16", 8, False)]
    out = {}
    for dtype, b, qi8 in cases:
        store = synth_store(n, d, dtype, dev, seed=0)
        qall = synth_queries(4 * b, store, seed=1)
        qpool = [qall[i * b:(i + 1) * b] for i in range(4)]
        runs = {"torch": [], "auto": []}
        for backend in ("torch", "auto", "auto", "torch"):
            runs[backend].append(time_scan(store, qpool, k, backend=backend,
                                           qi8=qi8, iters=iters))
        kern = sum(runs["auto"]) / 2
        plain = sum(runs["torch"]) / 2
        name = f"{'i8xi8' if qi8 else dtype} B={b} k={k}"
        gb = store.hbm_bytes / 1e9
        say(f"  {name}: kernel {kern:.4f} ms ({runs['auto']}) {b / kern * 1e3:.1f} QPS "
            f"{gb / kern * 1e3:.1f} GB/s | plain {plain:.4f} ms ({runs['torch']}) "
            f"{b / plain * 1e3:.1f} QPS {gb / plain * 1e3:.1f} GB/s")
        out[name] = (kern, plain)
        del store, qall, qpool
        torch.cuda.empty_cache()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        headline.main([])
    say(f"  headline: {buf.getvalue().strip()}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py runs on a GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nvdb_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi_line()
    say(f"[1 device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"nvidia-smi: {smi} | torch {torch.__version__} CUDA {torch.version.cuda}")

    info = _build.build("flat_topk")
    say(f"[2 build] flat_topk.cu: {info['seconds']:.2f} s (cached={info['cached']})")
    for line in info["log"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            say(f"  {line.strip()}")

    say("[3 kernel vs plain] 65,536 x 768, n_valid 65,000 "
        f"(regret <= {REGRET_TOL}, |kernel - plain| <= {VALUE_ATOL} + {VALUE_RTOL} rel, "
        f"id agreement >= {ID_AGREE_MIN})")
    max_err = phase_kernel_vs_plain(torch, dev)

    say("[4 main path] 1M x 768 bf16 store, FlatIndex.search, then tools.bench")
    launches = phase_main_path(torch, dev)
    phase_tools_bench(torch, dev)

    say("[5 times] 1M x 768, CUDA events over chained scans, plain/kernel/kernel/plain")
    times = phase_times(torch, dev)
    kern_ms, plain_ms = times["bf16 B=512 k=10"]

    say(smi)
    say(json.dumps({"kernels": [{
        "name": "flat_topk",
        "route": "cuda",
        "source": "nvdb_tpu_torch/kernels/csrc/flat_topk.cu",
        "replaces": "nvdb_tpu/kernels/flat_scan.py:417",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
