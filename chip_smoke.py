#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``nvdb_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the CUDA kernels from the
sources in the checkout (one ``nvcc`` per source, two measurement builds of
the probe source and three of the ADC source, all started together), then,
one phase per line group:

1. device: the card, ``nvidia-smi``'s name and power limit, torch and CUDA;
2. build: build seconds and each kernel's ptxas register / spill line;
3. kernel vs plain: the kernel against its plain PyTorch version and a
   float64 oracle on a 65,536 x 768 store (n_valid 65,000, which ends
   inside a row tile), every store type through the tensor-core kernel and
   f32 also through the SIMT kernel, B in {1, 8, 37, 200, 512, 600}, k in
   {1, 10, 128}; int8 x int8 must equal the plain version bit for bit; the
   f32 tensor-core instance must pass the error gate on every case: its
   largest |value - float64| at most twice the SIMT kernel's on the same
   call, and its ids equal to the SIMT kernel's wherever the float64 scores
   of the two ids differ by more than 1e-6 (printed with the plain six-pass
   decomposition's regret, ``flat_scan.six_pass_scores``);
4. main path: ``FlatIndex.search`` of 512 queries, k = 10, over a 1M x 768
   bf16 store synthesized on the card, through ``dispatch.flat_topk``; the
   kernel's launch counts (in all and by instance) are reset just before and
   must have risen; then ``tools.bench`` on a 262,144 x 384 f32 vecbin with
   float64 ground truth, whose f32 store must go to the tensor-core
   instance (so must the f32 ground truths of phases 8, 11 and 14);
5. times: kernel and plain version in turns at 1M x 768, B = 512, k = 10 per
   store type and at B = 8 for bf16 and f32 (f32: the SIMT kernel in the
   same turns), each beside its bound (the least time the card could take:
   bytes over the HBM rate or operations over the peak rate of their type,
   whichever is larger; six bf16 passes for the f32 tensor-core instance)
   and time / bound; one library call of the scores alone where there is
   one (``torch.matmul``, with TF32 off for f32, at B = 512 and 8;
   ``torch._int_mm`` for int8 x int8); the headline line of
   ``nvdb_tpu_torch.bench``;
6. ADC kernels vs plain: a random prefix-packed index at the flagship's M =
   96, dsub = 8 and Lcap = 640 (fills below kk, a dead list), B in {1, 8,
   64, 256}, P in {1, 7, 64}, kk in {10, 100, 256, 1024}, an index whose
   lists share ids (replicated rows) and one of at most 12 rows a list
   (fewer candidates than kk). The table kernel against ``pq.adc_lut`` +
   bf16 cast: at least 99.9% of the live probes' entries bit-equal, the
   rest one bf16 step off (the f32 sum of 8 products in another order than
   the library's, then one rounding). The dma scan on the kernel's own
   tables, and on a random f32 table that the wrapper rounds, against its
   plain version on the same tables; on the same tables the key and gather
   kernels bit for bit their plain version and each other, every key-mode
   value its id's ADC score truncated to bf16, every dma candidate above
   the key result's last value in it, and the ids shared with the dma
   kernel's at >= 0.95 over the phase; the fused key scan (the key and
   gather modes' default) bit for bit the key kernel and its plain version
   on the table kernel's tables in every case without shared ids, and on
   edge shapes:
   the flagship shape with a list every query probes and probes out of
   range, dsub 4 / 16 and the any-dsub instance (3 and 6), M 340 (as wide as
   the key kernel takes), lists of two tiles (Lcap 2048), fewer live lanes
   than kk, chunks of 1, 8 and 32 queries; the fused dma scan (the dma
   mode's default) bit for bit the staged route (the dma kernel on the table
   kernel's tables) and the dma scan's plain version in every case, those
   with shared ids and, at B = 1 / 8 / 256, kk 10 / 100 / 1024, lists with
   holes that hold ids twice (with the same codes and with others), no id
   twice in a row, and on the edge shapes at chunks of 1, 4 and 8;
7. rerank kernel vs plain and a float64 oracle: f32 / bf16 / int8 stores x
   l2 / dot, B in {1, 8, 256}, R in {10, 100, 256}, k in {1, 10, 100}, with
   padding ids and a repeated id, and a residual-int8 store; every call is
   one launch, and a call on a plain store runs no other operation on the
   device (every torch operator the call dispatches is recorded);
8. the IVF-PQ main path at the flagship's width: a 1M x 768 clustered f32
   vecbin written by ``tools.synth --clusters 16384 --spread 0.25 --seed 41``
   and 1,024 queries by ``tools.make_query --seed 42 --perturb 0.05``,
   ground truth by the flat kernel,
   ``tools.ivf_build --kind ivfpq --nlist 4096 --pq-m 96 --opq``, then
   ``tools.ivf_eval --chained --nprobe 64 --refine-k 100 --k 10 --batch-q
   256`` seven ways, each with the IVF-PQ launch counts reset just before and
   read just after: ``auto`` (key-mode candidates by the fused key scan, no
   table kernel), ``--key-scan tables`` (the table kernel and the key
   kernel, the A/B), ``--ids-mode dma`` (the fused dma scan, no other ADC
   kernel), ``--ids-mode dma --key-scan tables`` (the table kernel and the
   staged dma scan, its A/B, recall equal), ``--ids-mode gather`` (the fused
   key scan reading the probed lists in place, no other ADC kernel; its
   launches are the gather site's, ``adc_fused_gather``), ``--ids-mode
   gather --key-scan tables`` (the table kernel and the kernel over the
   gathered code slab, the gather site's A/B) and ``--ivf-backend torch``;
   then ``tools.quantize_i8 --residual`` of the same base against the index
   and ``ivf_eval --residual-refine`` with the kernels and with
   ``--ivf-backend torch``, and, for reference, a plain int8 store of the
   same bytes; recall@10 and QPS of each, auto within 0.005 of torch and of
   dma, the A/Bs and both gather runs equal to auto, the residual pair
   within 0.005;
9. times at B = 256, P = 64, M = 96, Lcap = 640, kk = 100 on the built index,
   each alone: rotation + coarse ranking (plain torch), the table kernel,
   the dma scan, the key scan, the gather wrapper and its two parts (the
   slab copy and the scan of the slab), the rerank wrapper at B = 256 and
   B = 8 (R = 100, k = 10, the 1M x 768 bf16 store), each kernel against
   its plain version in turns and beside its bound (the scans' bytes count
   each distinct probed list's live codes once, and the tables once; the
   bytes as probed are printed beside them); the rerank kernel
   alone (100 launches in one CUDA graph); the fused key scan at B = 256,
   8 and 1 against the two kernels it replaces (the table kernel, then the
   key scan), in turns, eagerly and as device time (calls in a CUDA graph),
   beside its bound (operations: the tables' FLOPs and the lookups' adds),
   the codebook bytes its CTAs pull from L2 and its lookups, its plain
   version, a sweep of its chunk width (1 / 4 / 8 / 16 / 32 queries), the
   call by pass (measurement builds, ``NVDB_ADC_ABLATE`` 3 / 4 / 5) and one
   call replayed from a CUDA graph; the query-term pass the fused scans open
   with, alone at B = 256, 8 and 1 (20 calls in a CUDA graph), bit for bit
   its plain version, beside its bound; the fused dma scan at kk 100 and 10 and
   B = 256, 8 and 1 against the staged route it replaces (the table kernel,
   then the staged dma scan), in turns, eagerly and as device time, bit for
   bit, with each route's peak device memory (at most 0.05 GB for the fused
   call at B = 256), beside its bound, its plain version, the cost of its
   repeated-id check and one call replayed from a CUDA graph; the whole dma
   batch and an ADC-only batch on the fused dma scan alone (no table kernel,
   nothing table-sized), bit for bit and in turns with the staged route,
   with the peak memory of each; the gather site's route (the fused key
   scan) at B = 256, 8 and 1 against the slab route it replaces (the table
   kernel, the slab copy and the scan of the slab), in turns, eagerly and
   as device time, bit for bit, with each route's peak device memory; the
   whole ``search_device``, on a call that captures its CUDA graph (its
   warm-up and capture dispatch the chain; a replay would not), whose
   operators are recorded to show that the key path makes no tensor the
   size of the tables, with its peak device memory and its graph pool's
   reserved bytes, against its plain versions and, in turns, with the two-kernel
   key path and with dma candidates in place of the key ones; the whole
   gather batch likewise (no tensor the size of the tables or the slab; bit
   for bit the slab route's and the key batch's) against its slab route,
   with the peak memory of each;
10. IVF probe kernel vs plain and a float64 oracle, both layouts (list-major,
   the default, and the query-major A/B): random packed indexes of f32 /
   bf16 / int8 payloads at Lcap 384 and 992 (lists full, with holes, filled
   below k, dead), B in {1, 8, 64, 256}, P in {1, 7, 32, 64}, k in {1, 10,
   50, 128}, and B = 256 with every query on one list, each query probing a
   list twice, and holes with out-of-range probes; the list-major grouping
   pass against its plain version;
11. the partition main path at its published width: the 1M x 768 "hard"
   corpus of ``tools.synth --hard 48 --seed 1`` and 1,000 sampled queries,
   ground truth by the flat kernel, ``tools.pr_eval --chained --nprobe 16
   32 --rerank-k 50 --batch-q 64 --wave 4`` with the kernels (probe and
   rerank launch counts reset just before and read just after) and with
   ``--backend torch``; ``tools.pr_build`` -> ``tools.pr_search``; then
   ``tools.ivf_build --kind ivfflat --nlist 4096 --dtype bf16`` ->
   ``tools.ivf_eval --chained --nprobe 64 --batch-q 256`` on both paths;
12. times: the list-major probe kernel against its plain version and
   against the query-major A/B, in turns, on the partition index (B = 64, P
   = 32, Lcap 992, k = 50) and the IVF-Flat index (B = 256, P = 64, k = 10)
   and at B = 8 and 1, with each layout's device time (20 calls in a CUDA
   graph); the bounds count each distinct probed list once (the bytes as
   probed, the distinct lists and the queries a list printed beside); the
   list-major plan's chunk widths and CTAs a SM; the call by pass (two
   measurement builds, ``NVDB_PROBE_ABLATE``, that stop after pass 0 and
   after pass 1); one call captured in a CUDA graph and replayed against an
   eager call; the partition and IVF-Flat batches by stage;
13. ``tools.hbm_probe`` (the stream and ring kernels against ``torch.amax``
   over 1M x 768 bf16: the card's HBM ceiling, which phase 12's rates are
   read against) and ``tools.gpu_sanity`` (the add1 kernel); add1 and
   ``x + 1`` are timed as 100 launches captured in one CUDA graph, so the
   figure is the device's and not the Python wrapper's; the probe kernel's
   rate of distinct bytes against the ceiling;
14. the build side and the data tools on phase 8's and phase 11's files:
   (a) ``tools.ivf_build --repack-from`` of phase 8's index at the published
   settings (pad 4.0, 8 spill candidates) and with ``--replicas 2
   --pad-factor 2.0``, then ``tools.ivf_eval --chained --nprobe 16 32 64
   --refine-k 50 --batch-q 256`` on phase 8's index, the repacked and the
   replicated one, with the kernels and (repacked, replicated) with
   ``--ivf-backend torch``: fewer spilled rows than phase 8's, the replicated
   index's candidates, an ADC-only search of the repacked index and the
   refine candidates of a copy of it with holes on the fused dma scan (no
   table kernel) with no id twice in any query's candidates, no table
   kernel in any ``ivf_eval`` run, kernel recall within 0.005 of the plain
   path's at each nprobe;
   (b) ``ivf_build --kind ivfflat --nlist 4096 --dtype bf16 --corpus-refine 2``
   on phase 11's hard corpus (its dead lists against phase 11's quantizer's,
   no more) and ``--repack-from`` phase 11's IVF-Flat index (pad 2.0, 8
   spill candidates), ``ivf_eval --chained --nprobe 64`` on both, the
   repacked one on the plain path too; (c) ``tools.gt_build`` on phase 8's
   files on the card, ids equal to phase 8's ground truth except at float64
   near-ties, and with ``--row-chunk 262144``; ``tools.slice --n 65536``,
   ``make_query --q 256`` on the slice, ``gt_build --host`` against
   ``gt_build`` there, ``search --q 4``, ``ab_compare --a cuda --b torch
   --pairs 30``, ``convert_bf16`` -> ``dump`` -> ``sanity``; the SIMT
   kernel's ground truth of phase 8's files (the A/B) against ``gt_build``'s
   on the tensor cores, equal except at float64 near-ties. Each sub-step
   prints its wall time; the launches of phase 14 join the kernels' record;
15. the dist paths (``nvdb_tpu_torch.dist``) on shards of cuda:0 (views of
   one store): (a) ``ShardedFlatIndex`` over phase 4's 1M x 768 bf16 store
   and an int8 store of the same rows at S = 4 and a bf16 store at S = 3,
   B = 512, k = 10, values bit-equal to ``FlatIndex``'s and ids equal where
   untied, the two in turns; (b) ``sharded_lloyd_step`` over phase 8's corpus
   at S = 4 against ``_lloyd_step`` on the valid rows, within 1e-4;
   (c) ``tools.ivf_eval --force-sharded --shards 1`` on phase 8's index (its
   recall equal to phase 8's), then ``ShardedIVFPQIndex`` at S = 4 (each
   shard's key candidates by the fused key scan) with the f32
   and the residual-int8 refine store row-sharded (``sharded_refine``):
   kernels against plain versions and key against dma candidates within
   0.005, the S = 4 recall beside the single device's, the batch in turns;
   (d) ``ShardedPartitionIndex`` over phase 11's index at S = 4 (nprobe 32,
   rerank 50) against its plain path within 0.005, the batch in turns, and
   IVF-Flat full probing on a small index against the flat kernel; (e) two
   ranks over gloo (``dist._worker``), two shards of cuda:0 each, each
   loading its half of phase 4's bench vecbin: both ranks' ids equal and
   equal to the one-process search; (f) ``dryrun_multichip(4)`` on cuda:0.
   The launches of the kernels in 15's runs, counted from 0 around each,
   must all have risen and join the kernels' record;
16. the A/B tools and the recall probes (``nvdb_tpu_torch.tools``), each
   run's launches counted from 0 around it and joining the kernels' record:
   ``kernel_ab`` (bf16 and f32 1M x 768, B = 512 and 8, k = 10, arms kernel
   and library, f32 also simt, 5 pairs, ``--check`` by float64 regret);
   ``refine_ab`` (bf16 1M x 768, B 8 / 64 / 256, R 50 / 100, ``--check``);
   ``adc_ab`` gen4 / gen5 / gen6 at the flagship shape (B 256, P 64, M 96,
   Lcap 640, kk 100) and at the JAX script's defaults (B 64, Lcap 1024), the
   gen4 and gen6 pairs bit-identical; ``coverage_probe`` (nprobe 16..256)
   and ``adc_rank_probe`` (nprobe 64, f32 / bf16lut / bf16score) on phase
   8's index, queries and ground truth, printed beside phase 8's recall as
   coverage x P(ADC rank <= 100 | covered), and the coverage of the S = 4
   sharded probe set at nprobe 64; ``multiproc_bench`` at its
   defaults (one process of two shards of cuda:0 against two gloo ranks),
   rank 0's recall equal to the one process's. A failed check in a tool
   exits the run.

Files go to ``build/chip_smoke``, which is removed at the end. Each phase
prints its wall time. Every check raises on failure, so the exit code is
non-zero if any phase fails; nothing falls back to the CPU or to the plain
version. Without a CUDA device it exits 1 before printing any result. The
last lines are ``nvidia-smi``'s name and power limit, the flat kernel's
launches by instance, the kernels' JSON record (launches on the main paths,
error, ms, plain ms, bound ms and what sets it, the library call's ms where
there is one; the flat kernel has three rows: bf16 / int8, f32 on the
tensor cores, f32 on the SIMT kernel; the probe kernel two: list-major and
the query-major A/B; the ADC scans six: the staged dma scan, the key kernel
and the slab gather kernel (the A/Bs), the fused key scan at the key site
and at the gather site, and the fused dma scan at the dma site; and the
query-term pass, which the fused scans launch), and
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
F32_ERR_RATIO = 2.0    # f32 on the tensor cores: largest |value - float64| against the
F32_ID_GAP = 1e-6      # SIMT kernel's on the same call; ids equal beyond this float64 gap
VALUE_ATOL = 1e-5      # |kernel - plain| per value (f32 sums in another order),
VALUE_RTOL = 1e-5      # as in the repository's parity tests
ID_AGREE_MIN = 0.99    # share of positions where kernel and plain ids agree
ADC_ATOL = 1e-4        # |ADC kernel - plain|: the same bf16 tables summed in the
                       # same order; the bound leaves room for the compiler
RECALL_GAP = 0.005     # kernel path's recall@10 against the plain path's
PR_RECALL_MIN = 0.9    # partition recall@10 at nprobe 32 (published: .9947)
# NVIDIA H100 SXM data sheet, dense rates: what a kernel's bound is reckoned from
HBM_GBPS = 3350.0
PEAK_TOPS = {"bf16": 989.0, "int8": 1979.0, "f32": 67.0}   # f32: outside the tensor cores
TABLE_EQUAL_MIN = 0.999  # share of a live probe's table entries equal bit for bit; the
                         # rest one bf16 step off (8 products summed in another order)
KEY_OVERLAP_MIN = 0.95   # key-mode ids shared with the dma kernel's over phase 6 (the TPU
                         # smoke's figure; the rest tie at the kk-th truncated value)
KERNELS = ("flat_topk", "adc_tables", "adc_topk", "rerank_topk", "ivf_probe_topk",
           "hbm_stream", "add1")   # the libraries: adc_topk.cu holds the key and gather kernels


def say(*a):
    print(*a, flush=True)


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def bound_ms(nbytes, ops, kind):
    """The least time the card could take: every input byte read once and
    every output byte written once at the HBM rate, or ``ops`` operations at
    the peak rate of their ``kind``, whichever is larger. Returns (ms, which)."""
    t_bytes = nbytes / (HBM_GBPS * 1e9) * 1e3
    t_ops = ops / (PEAK_TOPS[kind] * 1e12) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def run_tool(main, argv, keep=("RESULT",)):
    """Run a tool's ``main`` with its stdout captured; echo the lines that
    start with ``keep``; return what ``main`` returns."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    for line in buf.getvalue().splitlines():
        if line.startswith(keep):
            say(f"  {line}")
    return out


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


def value_err64(torch, s64, vals, ids):
    """Largest |value - float64 score of its id| of a kernel's result."""
    return float((vals.double() - torch.gather(s64, 1, ids.long())).abs().max())


def phase_kernel_vs_plain(torch, dev):
    """Every store type against the plain version and float64. f32 stores go
    through the tensor-core kernel (the default) and, in the same loop, the
    SIMT kernel, and the tensor-core kernel must pass the error gate: its
    largest |value - float64| no more than F32_ERR_RATIO times the SIMT
    kernel's, and its ids equal to the SIMT kernel's wherever the float64
    scores of the two ids differ by more than F32_ID_GAP. The plain
    six-pass decomposition's regret is printed beside them. Returns the
    largest |kernel - plain| per instance."""
    from nvdb_tpu_torch.formats import synth, vecbin
    from nvdb_tpu_torch.index.flat import quantize_queries_i8
    from nvdb_tpu_torch.kernels import flat_scan

    n_pad, n_valid, dp = 65536, 65000, 768
    base = torch.from_numpy(synth.normalized_gaussian(n_pad, dp, seed=11)).to(dev)
    qall = torch.from_numpy(synth.normalized_gaussian(600, dp, seed=12)).to(dev)
    max_err = {"flat_topk": 0.0, "f32_tensor_core": 0.0, "f32_simt": 0.0}
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
        # the decomposition alone, in plain torch: the split's own error
        six = flat_scan.six_pass_scores(qall, base[:n_valid]) if dtype == "f32" else None
        kernels = (flat_scan.TENSOR_CORE, flat_scan.SIMT) if dtype == "f32" else (None,)
        for b in (1, 8, 37, 200, 512, 600):
            q = qq[:b] if qq is not None else qall[:b]
            qsb = qs[:b] if qs is not None else None
            for k in (1, 10, 128):
                pv, pi = flat_scan.flat_topk_reference(q, store, scales, n_valid, k,
                                                       query_scales=qsb)
                res = {}
                for kern in kernels:
                    extra = {} if kern is None else {"f32_kernel": kern}
                    kv, ki = flat_scan.flat_topk_cuda(q, store, scales, n_valid, k,
                                                      query_scales=qsb, **extra)
                    torch.cuda.synchronize(dev)
                    tag = f"{dtype}{'' if kern is None else ' ' + kern} B={b} k={k}"
                    check(tuple(kv.shape) == (b, k) and tuple(ki.shape) == (b, k),
                          f"{tag}: shape")
                    check(bool(torch.isfinite(kv).all()), f"{tag}: non-finite values")
                    check(bool(((ki >= 0) & (ki < n_valid)).all()),
                          f"{tag}: id out of [0, n_valid)")
                    check(bool((kv[:, 1:] <= kv[:, :-1]).all()), f"{tag}: values not sorted")
                    r = regret(torch, s64_all[:b], ki, k)
                    err = float((kv - pv).abs().max())
                    agree = float((ki == pi).float().mean())
                    check(r <= REGRET_TOL, f"{tag}: regret {r} > {REGRET_TOL}")
                    check(bool(torch.allclose(kv, pv, atol=VALUE_ATOL, rtol=VALUE_RTOL)),
                          f"{tag}: values differ from plain by {err}")
                    check(agree >= ID_AGREE_MIN,
                          f"{tag}: id agreement {agree} < {ID_AGREE_MIN}")
                    if dtype == "i8xi8":   # int32 sums are exact in any order
                        check(bool(torch.equal(kv, pv)), f"{tag}: not bit-equal to plain")
                    key = "flat_topk" if kern is None else f"f32_{kern}"
                    max_err[key] = max(max_err[key], err)
                    res[kern] = (kv, ki)
                    say(f"  {tag}: regret={r:.3e} max_abs_err={err:.3e} id_agree={agree:.4f}")
                if dtype == "f32":
                    # the error gate of the tensor-core instance against the SIMT kernel
                    (tv, ti), (sv, si) = res[flat_scan.TENSOR_CORE], res[flat_scan.SIMT]
                    s64 = s64_all[:b]
                    e_tc, e_simt = value_err64(torch, s64, tv, ti), value_err64(torch, s64, sv, si)
                    gap = (torch.gather(s64, 1, ti.long()) - torch.gather(s64, 1, si.long())).abs()
                    apart = int(((ti != si) & (gap > F32_ID_GAP)).sum())
                    _, si6 = torch.topk(six[:b], k, dim=1)
                    r6 = regret(torch, s64, si6.to(torch.int32), k)
                    say(f"  f32 gate B={b} k={k}: |value - float64| tensor core {e_tc:.3e} "
                        f"simt {e_simt:.3e} (ratio {e_tc / max(e_simt, 1e-30):.2f}, limit "
                        f"{F32_ERR_RATIO}); ids apart from simt beyond a {F32_ID_GAP} gap: "
                        f"{apart}; six-pass plain regret {r6:.3e}")
                    check(e_tc <= F32_ERR_RATIO * e_simt,
                          f"f32 B={b} k={k}: tensor-core error {e_tc} > {F32_ERR_RATIO} x "
                          f"simt's {e_simt}")
                    check(apart == 0, f"f32 B={b} k={k}: {apart} ids differ from simt's "
                                      f"beyond a {F32_ID_GAP} float64 gap")
        del store, scales, s64_all, s64_store, q64, six
    del base, qall
    torch.cuda.empty_cache()
    return max_err


def flat_reset():
    """Set the flat kernel's launch counts to 0, in all and by instance."""
    from nvdb_tpu_torch.kernels import flat_scan

    flat_scan.LAUNCHES = 0
    for key in flat_scan.LAUNCHES_BY_KERNEL:
        flat_scan.LAUNCHES_BY_KERNEL[key] = 0


def flat_counts(tag, f32=False):
    """The flat kernel's launches by instance since flat_reset, printed under
    ``tag``; with ``f32``, the f32 store of that path must have gone to the
    tensor-core instance and never to the SIMT one."""
    from nvdb_tpu_torch.kernels import flat_scan

    counts = {k: v for k, v in flat_scan.LAUNCHES_BY_KERNEL.items() if v}
    say(f"  {tag}: flat kernel launches by instance {counts}")
    check(flat_scan.LAUNCHES > 0, f"{tag}: the flat kernel was not launched")
    if f32:
        check(counts.get("f32_tensor_core", 0) > 0 and "f32_simt" not in counts,
              f"{tag}: the f32 store did not go to the tensor-core instance alone")
    return counts


def probe_launches(tag):
    """The probe kernel's launches since ``ivf_scan.reset_launches()``, all
    of them list-major: no path takes the query-major A/B by itself."""
    from nvdb_tpu_torch.kernels import ivf_scan

    check(ivf_scan.LAUNCHES_BY_LAYOUT["list"] == ivf_scan.LAUNCHES,
          f"{tag}: the query-major probe kernel ran on a path "
          f"({ivf_scan.LAUNCHES_BY_LAYOUT})")
    return ivf_scan.LAUNCHES


def phase_main_path(torch, dev):
    from nvdb_tpu_torch.bench import synth_store
    from nvdb_tpu_torch.formats import synth
    from nvdb_tpu_torch.index.flat import FlatIndex
    from nvdb_tpu_torch.kernels import ops

    n, d, b, k = 1_000_000, 768, 512, 10
    store = synth_store(n, d, "bf16", dev, seed=0)
    torch.cuda.synchronize(dev)
    queries = synth.normalized_gaussian(b, d, seed=13)
    index = FlatIndex(store)

    flat_reset()
    t0 = time.perf_counter()
    vals, ids = index.search(queries, k)
    wall = time.perf_counter() - t0
    say(f"  FlatIndex.search 1M x 768 bf16, B={b}, k={k}: first-call wall {wall:.3f} s")
    launches = flat_counts("FlatIndex.search")
    check(launches.get("bf16", 0) > 0, "the main path did not launch the bf16 instance")
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


def work_paths(work, prefix, names):
    return {x: os.path.join(work, f"{prefix}_{x}") for x in names}


def remove_files(paths):
    for p in paths.values():
        if os.path.exists(p):
            os.remove(p)


def phase_tools_bench(torch, dev, work):
    from nvdb_tpu_torch.formats import gtbin, synth, vecbin
    from nvdb_tpu_torch.index.flat import FlatIndex
    from nvdb_tpu_torch.store import VectorStore
    from nvdb_tpu_torch.tools import bench as bench_tool

    n, d, nq, k = 262_144, 384, 64, 10
    paths = work_paths(work, "bench", ("base.vecbin", "q.vecbin", "gt.gtbin"))
    base = synth.normalized_gaussian(n, d, seed=21)
    queries, _ = synth.sample_queries(base, nq, seed=22, perturb=0.05)
    s64 = queries.astype(np.float64) @ base.astype(np.float64).T
    gt = np.argsort(-s64, axis=1, kind="stable")[:, :k]
    vecbin.write_vecbin(paths["base.vecbin"], base)
    vecbin.write_vecbin(paths["q.vecbin"], queries)
    gtbin.write_gtbin(paths["gt.gtbin"], gt, dim=d, N=n)
    flat_reset()
    recall = run_tool(bench_tool.main, [paths["base.vecbin"], paths["q.vecbin"], str(k),
                                        "--batch-q", "16", "--gt", paths["gt.gtbin"]],
                      keep=("N=", "recall@", "RESULT"))
    launches = flat_counts("tools.bench (f32 store)", f32=True)
    if recall < 1.0:
        # near-ties may swap ids between f32 and float64: judge by regret
        idx = FlatIndex(VectorStore.from_vecbin(paths["base.vecbin"], device=dev))
        _, ids = idx.search(queries, k)
        got = np.sort(np.take_along_axis(s64, ids.astype(np.int64), axis=1), axis=1)
        ref = np.sort(np.take_along_axis(s64, gt, axis=1), axis=1)
        r = float(np.max(ref - got))
        say(f"  recall {recall:.4f} < 1: regret {r:.3e}")
        check(r <= REGRET_TOL, f"tools.bench: regret {r}")
    return launches   # its files stay for phase 15


def library_scores_ms(torch, dtype, qi8, q, store, iters):
    """One PyTorch call that computes the scan's scores alone on the same
    inputs (never on the port's path): ``torch.matmul`` for bf16 and, with
    TF32 off, f32 stores; ``torch._int_mm`` for int8 x int8. None for the
    int8 store with f32 queries, which no single call computes."""
    from nvdb_tpu_torch.index.flat import quantize_queries_i8
    from nvdb_tpu_torch.kernels import ops

    v = store.vectors
    if dtype == "f32":
        ops.no_tf32()
        out = torch.empty((q.shape[0], v.shape[0]), dtype=torch.float32, device=v.device)
        fn = lambda: torch.matmul(q, v.T, out=out)
    elif dtype == "bf16":
        q16 = q.to(torch.bfloat16)
        out = torch.empty((q.shape[0], v.shape[0]), dtype=torch.bfloat16, device=v.device)
        fn = lambda: torch.matmul(q16, v.T, out=out)
    elif qi8:
        qq, _ = quantize_queries_i8(q)
        fn = lambda: torch._int_mm(qq, v.T)
    else:
        return None
    ms = cuda_ms(torch, fn, iters)
    torch.cuda.empty_cache()
    return ms


def phase_times(torch, dev):
    """Kernel and plain version in turns per store type at 1M x 768; the f32
    rows also time the SIMT kernel in the same turns (plain, tensor core,
    SIMT, SIMT, tensor core, plain). Bounds: bytes over the HBM rate or
    operations over the peak of their type; the f32 tensor-core instance
    does six bf16 passes, the SIMT kernel one pass of f32 FMA."""
    from nvdb_tpu_torch import bench as headline
    from nvdb_tpu_torch.bench import synth_queries, synth_store, time_scan

    n, d, k, iters = 1_000_000, 768, 10, 10
    cases = [("f32", 512, False), ("f32", 8, False), ("bf16", 512, False), ("i8", 512, False),
             ("i8", 512, True), ("bf16", 8, False)]
    out = {}
    for dtype, b, qi8 in cases:
        store = synth_store(n, d, dtype, dev, seed=0)
        qall = synth_queries(4 * b, store, seed=1)
        qpool = [qall[i * b:(i + 1) * b] for i in range(4)]
        order = (("torch", "auto", "simt", "simt", "auto", "torch") if dtype == "f32"
                 else ("torch", "auto", "auto", "torch"))
        runs = {name: [] for name in order}
        for name in order:
            kw = {"f32_kernel": "simt"} if name == "simt" else {"backend": name}
            runs[name].append(time_scan(store, qpool, k, qi8=qi8, iters=iters, **kw))
        ms = {name: sum(r) / len(r) for name, r in runs.items()}
        name = f"{'i8xi8' if qi8 else dtype} B={b} k={k}"
        # bytes: the valid rows (and their scales), the queries, the result
        esize = store.vectors.element_size()
        nbytes = (n * store.d_padded * esize + (n * 4 if store.scales is not None else 0)
                  + b * store.d_padded * (1 if qi8 else 4) + (b * 4 if qi8 else 0) + b * k * 8)
        ops1 = 2.0 * b * n * store.d_padded
        lib = (library_scores_ms(torch, dtype, qi8, qpool[0], store, iters)
               if b == 512 or dtype in ("bf16", "f32") else None)
        rows = [("auto", ops1 * (6 if dtype == "f32" else 1), "int8" if qi8 else "bf16",
                 "six bf16 passes" if dtype == "f32" else None)]
        if dtype == "f32":
            rows.append(("simt", ops1, "f32", "f32 FMA outside the tensor cores"))
        for kern, ops_n, kind, what in rows:
            bnd, by = bound_ms(nbytes, ops_n, kind)
            t = ms[kern]
            row = f"{name}" + (" simt" if kern == "simt" else "")
            say(f"  {row}: kernel {t:.4f} ms ({runs[kern]}) {b / t * 1e3:.1f} QPS | plain "
                f"{ms['torch']:.4f} ms ({runs['torch']}) | bound {bnd:.4f} ms ({by}"
                f"{', ' + what if by == 'operations' and what else ''}: {nbytes / 1e9:.4f} GB, "
                f"{ops_n / 1e9:.1f} G{kind} ops) time / bound {t / bnd:.2f}"
                + (f" | library call of the scores alone {lib:.4f} ms" if lib is not None
                   else ""))
            out[row] = dict(ms=t, plain_ms=ms["torch"], bound_ms=bnd, bound_by=by,
                            library_ms=lib)
        del store, qall, qpool
        torch.cuda.empty_cache()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        headline.main([])
    say(f"  headline: {buf.getvalue().strip()}")
    return out


def cuda_ms(torch, fn, iters, warmup=1):
    """Milliseconds per call of ``fn`` over ``iters`` chained calls (CUDA
    events, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(torch, plain, kern, iters):
    """plain, kernel, kernel, plain; returns (kernel ms, plain ms, runs)."""
    runs = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        runs[name].append(cuda_ms(torch, plain if name == "plain" else kern, iters))
    return sum(runs["kernel"]) / 2, sum(runs["plain"]) / 2, runs


def graph_ms(torch, fn, launches=100, replays=20):
    """Milliseconds per call of ``fn`` with ``launches`` calls captured in
    one CUDA graph and the graph replayed ``replays`` times between two
    events: the device's time per launch, without the host time of the
    Python wrapper."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(torch, graph.replay, replays) / launches


def dispatched_ops(torch, fn):
    """Run ``fn`` and return (its result, [(operator name, [(shape, dtype) of
    each tensor it returned])]) for every torch operator it dispatched. A
    hand-written kernel launched through ctypes is no torch operator, so a
    wrapper that only allocates and launches shows ``aten.empty`` alone."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = out if isinstance(out, (tuple, list)) else (out,)
            seen.append((str(func), [(tuple(o.shape), o.dtype) for o in outs
                                     if isinstance(o, torch.Tensor)]))
            return out

    with Recorder():
        res = fn()
    return res, seen


def bf16_steps(torch, a, b):
    """|a - b| in bf16 steps (units in the last place), elementwise, for
    finite bf16 tensors: the sign-magnitude bits mapped to ordered integers."""
    def ordered(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


def table_inputs(torch, dev, b, nlist, m, dsub, seed):
    """Rotated queries near the centroids, centroids and codebooks of the
    width the ADC tables are built from (Dp = m * dsub)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dp = m * dsub
    cents = torch.randn((nlist, dp), generator=g, device=dev) / dp ** 0.5
    near = torch.randint(0, nlist, (b,), generator=g, device=dev)
    q_rot = cents[near] + 0.3 * torch.randn((b, dp), generator=g, device=dev) / dp ** 0.5
    codebooks = 0.3 * torch.randn((m, 256, dsub), generator=g, device=dev) / dp ** 0.5
    return q_rot.contiguous(), cents, codebooks


def adc_case(torch, dev, b, p, seed, nlist=128, m=96, lcap=640, dup=False, scarce=False,
             holes=False):
    """A random prefix-packed index (lists of varied fill, one empty), its
    tables and probes; ``dup``: lists 1 and 2 hold the same ids; ``scarce``:
    every list holds at most 12 rows; ``holes``: slots freed below lists'
    fills, and lists 5 and 6 holding some of their ids twice (list 5 with
    the same codes, as two copies of a row in one list have), 60 other rows
    of list 5 with the codes of 60 more (tied scores), every query probing
    list 5."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (nlist, m, lcap)).astype(np.uint8)
    slot_ids = np.full((nlist, lcap), -1, np.int32)
    perm = rng.permutation(nlist * lcap).astype(np.int32)
    for li in range(nlist):
        f = int(rng.integers(0, lcap + 1)) if li % 4 else lcap
        if scarce:
            f = int(rng.integers(0, 13))
        slot_ids[li, :f] = perm[li * lcap:li * lcap + f]
    slot_ids[3] = -1
    if dup:
        slot_ids[2] = slot_ids[1]
    if holes:
        slot_ids[5, 1::3] = -1
        slot_ids[7, :300:2] = -1
        slot_ids[5, :60] = slot_ids[5, 100:160]
        codes[5, :, :60] = codes[5, :, 100:160]
        codes[5, :, 160:220] = codes[5, :, 220:280]     # other ids: tied scores
        slot_ids[6, 1:61:2] = slot_ids[6, 200:230]
    probes = np.stack([rng.choice(nlist, p, replace=False) for _ in range(b)]).astype(np.int32)
    if dup:
        probes[:, :2] = [1, 2]
    if holes:
        probes[:, 0] = 5
    g = torch.Generator(device=dev).manual_seed(seed)
    lut = torch.rand((b, p, m, 256), generator=g, device=dev) * 4.0
    t = lambda x: torch.from_numpy(x).to(dev)
    return lut, t(probes), t(codes), t(slot_ids)


def check_adc(torch, tag, kv, ki, pv, pi):
    fin = ki >= 0
    check(bool((fin == (pi >= 0)).all()), f"{tag}: filler slots differ from plain")
    err = float((kv[fin] - pv[fin]).abs().max()) if bool(fin.any()) else 0.0
    agree = float((ki == pi).float().mean())
    check(bool(torch.isfinite(kv[ki >= 0]).all()), f"{tag}: non-finite values")
    check(bool(torch.isneginf(kv[ki < 0]).all()), f"{tag}: filler is not (-inf, -1)")
    check(bool((kv[:, 1:] <= kv[:, :-1]).all()), f"{tag}: values not sorted")
    for row in ki.cpu().numpy():
        live = row[row >= 0]
        check(len(set(live.tolist())) == len(live), f"{tag}: duplicate ids")
    check(err <= ADC_ATOL, f"{tag}: values differ from plain by {err}")
    check(agree >= ID_AGREE_MIN, f"{tag}: id agreement {agree} < {ID_AGREE_MIN}")
    return err, agree


def exact_adc_scores(torch, lut, probes, codes, slot_ids, ids):
    """[B, kk] f32 ADC scores of the rows ``ids`` (-1: -inf) over each query's
    probes, summed over m in order as the kernels and plain versions sum
    them, from an inverse of the slot table."""
    nlist, m, lcap = codes.shape
    b, p = probes.shape
    dev = codes.device
    live = slot_ids >= 0
    n_ids = int(slot_ids.max()) + 1
    where = torch.full((n_ids,), -1, dtype=torch.int64, device=dev)
    pos = torch.arange(nlist * lcap, device=dev).reshape(nlist, lcap)
    where[slot_ids[live].long()] = pos[live]
    pinv = torch.full((b, nlist), -1, dtype=torch.int64, device=dev)
    pinv.scatter_(1, probes.long(), torch.arange(p, device=dev).expand(b, p).contiguous())
    ok = ids >= 0
    at = torch.where(ok, where[torch.where(ok, ids, 0).long()], 0)
    li, lane = at // lcap, at % lcap
    pp = torch.gather(pinv, 1, li)
    code = codes[li[..., None], torch.arange(m, device=dev), lane[..., None]]   # [B, kk, M]
    tab = lut.to(torch.bfloat16).to(torch.float32)
    acc = torch.zeros(ids.shape, dtype=torch.float32, device=dev)
    bi = torch.arange(b, device=dev)[:, None]
    for j in range(m):
        acc += tab[bi, pp.clamp(min=0), j, code[..., j].long()]
    return torch.where(ok, -acc, float("-inf"))


def truncate_bf16(torch, x):
    """f32 values with the low 16 bits of their pattern cleared (+0 for 0)."""
    return ((x + 0.0).view(torch.int32) & -65536).view(torch.float32)


def check_keys(torch, tag, lut, probes, codes, slot_ids, kk, fills, dma):
    """The key and gather kernels on one case: each bit for bit its plain
    version (values and ids), gather bit for bit key; against the dma
    kernel's (vals, ids) on the same tables, every key-mode id's exact ADC
    score truncates to the value beside it, and every dma candidate whose
    truncated score beats the key result's last value is in it (the rest
    tie there). Returns (shared ids, dma ids) of the rows."""
    from nvdb_tpu_torch.kernels import adc_scan

    pv, pi = adc_scan.adc_topk_keys_reference(lut, probes, codes, slot_ids, kk, fills=fills)
    got = []
    for gathered in (False, True):
        kv, ki = adc_scan.adc_topk_keys_cuda(lut, probes, codes, slot_ids, kk, fills=fills,
                                             gathered=gathered)
        torch.cuda.synchronize()
        name = "gather" if gathered else "key"
        check(torch.equal(kv, pv) and torch.equal(ki, pi),
              f"{tag}: the {name} kernel differs from its plain version")
        got.append((kv, ki))
    check(torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1]),
          f"{tag}: gather differs from key")
    kv, ki = got[0]
    fin = ki >= 0
    exact = exact_adc_scores(torch, lut, probes, codes, slot_ids, ki)
    check(torch.equal(truncate_bf16(torch, exact)[fin], kv[fin]),
          f"{tag}: a key-mode value is not its id's truncated ADC score")
    check(bool(torch.isneginf(kv[~fin]).all()), f"{tag}: key filler is not (-inf, -1)")
    check(bool((fin == (dma[1] >= 0)).all()), f"{tag}: key and dma fill differently")
    last = torch.where(fin, kv, float("inf")).amin(dim=1, keepdim=True)
    must = (dma[1] >= 0) & (truncate_bf16(torch, dma[0]) > last)
    shared = dma_ids = 0
    for krow, drow, mrow in zip(ki.cpu().numpy(), dma[1].cpu().numpy(), must.cpu().numpy()):
        kset = set(krow[krow >= 0].tolist())
        check(set(drow[mrow].tolist()) <= kset, f"{tag}: a dma candidate above the key "
                                                f"result's last value is missing")
        dset = set(drow[drow >= 0].tolist())
        shared += len(kset & dset)
        dma_ids += len(dset)
    return shared, dma_ids


def check_tables(torch, tag, got, want, live):
    """The table gate: over the live probes' entries, at least
    TABLE_EQUAL_MIN equal bit for bit and none further than one bf16 step."""
    check(tuple(got.shape) == tuple(want.shape) and got.dtype == torch.bfloat16,
          f"{tag}: table shape or dtype")
    check(bool(torch.isfinite(got.float()).all()), f"{tag}: non-finite table entries")
    steps = bf16_steps(torch, got[live], want[live])
    equal = float((steps == 0).float().mean()) if steps.numel() else 1.0
    worst = int(steps.max()) if steps.numel() else 0
    check(equal >= TABLE_EQUAL_MIN, f"{tag}: only {equal} of table entries bit-equal")
    check(worst <= 1, f"{tag}: a table entry is {worst} bf16 steps off")
    check(bool((got[~live] == 0).all()), f"{tag}: a dead probe's table is not zero")
    return equal, worst


def check_fused_dma(torch, tag, q_rot, probes, cents, codebooks, codes, slot_ids, kk, fills,
                    lut, nq_max=None):
    """The fused dma scan bit for bit (values and ids) the staged route (the
    dma kernel on the table kernel's tables ``lut``) and the dma scan's plain
    version on ``lut`` (out-of-range probes sent to the dead list 3), each id
    once a row. Returns its largest |value - plain value|."""
    from nvdb_tpu_torch.kernels import adc_scan

    fv, fi = adc_scan.adc_fused_topk_cuda(q_rot, probes, cents, codebooks, codes, slot_ids, kk,
                                          fills=fills, nq_max=nq_max)
    torch.cuda.synchronize()
    sv, si = adc_scan.adc_topk_cuda(lut, probes, codes, slot_ids, kk, fills=fills)
    check(torch.equal(fv, sv) and torch.equal(fi, si),
          f"{tag}: the fused dma scan differs from the staged route")
    ok = (probes >= 0) & (probes < codes.shape[0])
    pv, pi = adc_scan.adc_topk_reference(lut, torch.where(ok, probes, 3), codes, slot_ids, kk)
    check(torch.equal(fi, pi), f"{tag}: the fused dma scan's ids differ from the plain scan's")
    fin = fi >= 0
    err = float((fv[fin] - pv[fin]).abs().max()) if bool(fin.any()) else 0.0
    check(err == 0.0, f"{tag}: the fused dma scan's values differ from the plain scan's by {err}")
    for row in fi.cpu().numpy():
        live = row[row >= 0]
        check(len(set(live.tolist())) == len(live), f"{tag}: the fused dma scan repeats an id")
    return err


def check_fused(torch, tag, q_rot, probes, cents, codebooks, codes, slot_ids, kk, fills, lut,
                nq_max=None):
    """The fused key scan bit for bit (values and ids) the key mode's plain
    scan and the key kernel on the table kernel's tables ``lut``."""
    from nvdb_tpu_torch.kernels import adc_scan

    fv, fi = adc_scan.adc_fused_keys_cuda(q_rot, probes, cents, codebooks, codes, slot_ids, kk,
                                          fills=fills, nq_max=nq_max)
    torch.cuda.synchronize()
    pv, pi = adc_scan.adc_topk_keys_reference(lut, probes, codes, slot_ids, kk, fills=fills)
    check(torch.equal(fv, pv) and torch.equal(fi, pi),
          f"{tag}: the fused key scan differs from the key mode's plain scan")
    kv, ki = adc_scan.adc_topk_keys_cuda(lut, probes, codes, slot_ids, kk, fills=fills)
    check(torch.equal(fv, kv) and torch.equal(fi, ki),
          f"{tag}: the fused key scan differs from the key kernel")
    return float((fi >= 0).float().mean())


# (B, P, nlist, M, dsub, Lcap, kk, kind) of phase 6's fused edge cases; kind:
# "hot" every query probes one list, "bad" probes out of range, "scarce" at
# most 12 rows a list
FUSED_CASES = ((256, 64, 512, 96, 8, 640, 100, "hot bad"), (64, 16, 128, 32, 4, 640, 1024, ""),
               (8, 7, 64, 48, 16, 640, 100, "bad"), (8, 7, 64, 32, 6, 640, 100, ""),
               (8, 4, 40, 12, 3, 256, 10, "hot"), (4, 8, 40, 340, 8, 128, 100, ""),
               (1, 64, 128, 96, 8, 640, 1024, "scarce"), (16, 8, 40, 16, 8, 2048, 100, "bad"),
               (1, 1, 16, 96, 8, 640, 10, ""))


def fused_edge_case(torch, dev, b, p, nlist, m, dsub, lcap, kind, seed):
    """A random prefix-packed index (list 3 dead) and the geometry of its
    tables for ``FUSED_CASES``."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (nlist, m, lcap)).astype(np.uint8)
    slot_ids = np.full((nlist, lcap), -1, np.int32)
    perm = rng.permutation(nlist * lcap).astype(np.int32)
    for li in range(nlist):
        scarce = "scarce" in kind
        f = int(rng.integers(0, 13 if scarce else lcap + 1)) if li % 4 or scarce else lcap
        slot_ids[li, :f] = perm[li * lcap:li * lcap + f]
    slot_ids[3] = -1
    probes = np.stack([rng.choice(nlist, p, replace=False) for _ in range(b)]).astype(np.int32)
    if "hot" in kind:
        for r in range(b):
            probes[r] = [5] + [x for x in probes[r] if x != 5][:p - 1]
    if "bad" in kind:
        probes[0, 0], probes[-1, -1] = -1, nlist + 2
    q_rot, cents, codebooks = table_inputs(torch, dev, b, nlist, m, dsub, seed)
    t = lambda x: torch.from_numpy(x).to(dev)
    return q_rot, t(probes), cents, codebooks, t(codes), t(slot_ids)


def phase_adc_vs_plain(torch, dev):
    from nvdb_tpu_torch.kernels import adc_scan

    out = {"scan_err": 0.0, "table_err": 0.0, "table_equal": 1.0, "fused_cases": 0,
           "fused_dma_cases": 0, "fused_dma_err": 0.0}
    cases = [(b, p, kk, "") for b in (1, 8, 64, 256) for p in (1, 7, 64)
             for kk in (10, 100, 256, 1024)] + [(8, 7, 100, "dup"), (64, 64, 1024, "dup"),
                                                (8, 64, 1024, "scarce")] + [
        (b, 64, kk, "holes") for b in (1, 8, 256) for kk in (10, 100, 1024)]
    shared = dma_ids = 0
    for b, p, kk, kind in cases:
        dup = kind in ("dup", "holes")     # not prefix-packed with unique ids: dma only
        lut32, probes, codes, slot_ids = adc_case(torch, dev, b, p, seed=b * 131 + p,
                                                  dup=kind == "dup", scarce=kind == "scarce",
                                                  holes=kind == "holes")
        tag = f"B={b} P={p} kk={kk}{' ' + kind if kind else ''}"
        # the table kernel on this index's probes (list 3 is dead), then the
        # scan on the kernel's own tables
        q_rot, cents, codebooks = table_inputs(torch, dev, b, codes.shape[0], codes.shape[1], 8,
                                               seed=b * 17 + p)
        fills = adc_scan.list_fills(slot_ids)
        lut = adc_scan.adc_tables_cuda(q_rot, probes, cents, codebooks, fills)
        torch.cuda.synchronize(dev)
        want = adc_scan.adc_tables_reference(q_rot, probes, cents, codebooks, fills)
        live = adc_scan.live_probes(probes, fills)
        equal, worst = check_tables(torch, tag, lut, want, live)
        out["table_equal"] = min(out["table_equal"], equal)
        out["table_err"] = max(out["table_err"],
                               float((lut.float() - want.float())[live].abs().max()))
        del want
        msg = f"  {tag}: tables bit-equal {equal:.6f}, worst {worst} step(s)"
        for name, table in (("kernel's tables", lut), ("f32 table", lut32)):
            kv, ki = adc_scan.adc_topk_cuda(table, probes, codes, slot_ids, kk, fills=fills)
            torch.cuda.synchronize(dev)
            pv, pi = adc_scan.adc_topk_reference(table, probes, codes, slot_ids, kk)
            err, agree = check_adc(torch, f"{tag} ({name})", kv, ki, pv, pi)
            out["scan_err"] = max(out["scan_err"], err)
            msg += f" | scan on {name}: err={err:.1e} id_agree={agree:.3f}"
            if not dup:
                # the key and gather kernels on the same tables
                sh, dn = check_keys(torch, f"{tag} ({name})", table, probes, codes, slot_ids,
                                    kk, fills, (kv, ki))
                shared += sh
                dma_ids += dn
                msg += f" key=gather=plain overlap(dma)={sh / max(1, dn):.3f}"
        err = check_fused_dma(torch, tag, q_rot, probes, cents, codebooks, codes, slot_ids, kk,
                              fills, lut)
        out["fused_dma_err"] = max(out["fused_dma_err"], err)
        out["fused_dma_cases"] += 1
        msg += " | fused dma = staged = plain on the kernel's tables"
        if not dup:
            check_fused(torch, tag, q_rot, probes, cents, codebooks, codes, slot_ids, kk, fills,
                        lut)
            out["fused_cases"] += 1
            msg += " | fused (key and gather sites) = key on the kernel's tables"
        msg += f" filled={float((ki >= 0).float().mean()):.3f}"
        say(msg)
        del lut, lut32, probes, codes, slot_ids
    out["key_overlap"] = shared / max(1, dma_ids)
    say(f"  key / gather vs dma: id overlap {out['key_overlap']:.4f} over all cases "
        f"(gate {KEY_OVERLAP_MIN})")
    # the fused key scan's edge shapes, at the plan's chunk and at 1 and 32
    for i, (b, p, nlist, m, dsub, lcap, kk, kind) in enumerate(FUSED_CASES):
        args = fused_edge_case(torch, dev, b, p, nlist, m, dsub, lcap, kind, seed=1000 + i)
        fills = adc_scan.list_fills(args[5])
        lut = adc_scan.adc_tables_cuda(*args[:4], fills)
        for nq in (None, 1, 32):
            filled = check_fused(torch, f"fused B={b} P={p} M={m} dsub={dsub} Lcap={lcap} "
                                 f"kk={kk} {kind} nq<={nq}", *args, kk, fills, lut, nq_max=nq)
            out["fused_cases"] += 1
        for nq in (None, 1, 4):
            check_fused_dma(torch, f"fused dma B={b} P={p} M={m} dsub={dsub} Lcap={lcap} "
                            f"kk={kk} {kind} nq<={nq}", *args, kk, fills, lut, nq_max=nq)
            out["fused_dma_cases"] += 1
        say(f"  fused B={b} P={p} M={m} dsub={dsub} Lcap={lcap} kk={kk} {kind or '-'}: bit for "
            f"bit the key kernel and its plain version at chunks of <= 8 / 1 / 32 queries, "
            f"the fused dma scan the staged route at <= 8 / 1 / 4, filled={filled:.3f}")
        del args, lut
    say(f"  fused key scan: {out['fused_cases']} calls bit for bit the key kernel on the table "
        f"kernel's tables; fused dma scan: {out['fused_dma_cases']} calls bit for bit the "
        f"staged route and its plain version (largest |value - plain| "
        f"{out['fused_dma_err']:.1e})")
    check(out["key_overlap"] >= KEY_OVERLAP_MIN,
          f"key-mode ids overlap the dma kernel's at {out['key_overlap']} < {KEY_OVERLAP_MIN}")
    torch.cuda.empty_cache()
    return out


def rerank_regret(s64, cand, ids, k):
    """float64 regret of the kernel's ids over each row's distinct
    candidates (s64 [B, R] over cand [B, R], -inf where cand < 0)."""
    worst = 0.0
    for b in range(cand.shape[0]):
        best = {}
        for c, v in zip(cand[b].tolist(), s64[b].tolist()):
            if c >= 0:
                best[c] = v
        ref = sorted(best.values(), reverse=True)[:k]
        got = sorted((best[i] for i in ids[b].tolist() if i >= 0), reverse=True)
        check(len(got) == len(ref), "rerank: too few ids")
        worst = max(worst, max((r - g for r, g in zip(ref, got)), default=0.0))
    return worst


def phase_rerank_vs_plain(torch, dev):
    from nvdb_tpu_torch.formats import synth, vecbin
    from nvdb_tpu_torch.kernels import rerank

    n, dp = 65536, 768
    base = synth.normalized_gaussian(n, dp, seed=31)
    q_all = torch.from_numpy(synth.normalized_gaussian(256, dp, seed=32)).to(dev)
    rng = np.random.default_rng(33)
    max_err = 0.0
    for dtype in ("f32", "bf16", "i8"):
        sc = None
        if dtype == "f32":
            store, eff = torch.from_numpy(base).to(dev), torch.from_numpy(base)
        elif dtype == "bf16":
            bits = vecbin.to_bf16(base)
            store = vecbin.bf16_bits_to_torch(bits).to(dev)
            eff = torch.from_numpy(vecbin.bf16_to_f32(bits))
        else:
            codes, scn = vecbin.quantize_i8(base)
            store, sc = torch.from_numpy(codes).to(dev), torch.from_numpy(scn).to(dev)
            eff = torch.from_numpy(codes).double() * torch.from_numpy(scn).double()[:, None]
        eff = eff.double().to(dev)
        n2 = rerank.store_norms2(store)
        for metric in ("l2", "dot"):
            for b in (1, 8, 256):
                for r in (10, 100, 256):
                    cand = np.stack([rng.choice(n, r, replace=False) for _ in range(b)])
                    cand = cand.astype(np.int32)
                    cand[0, r // 2:] = -1                 # padding ids
                    if b > 1:
                        cand[1, 1] = cand[1, 0]           # an id that repeats
                        cand[1, r - 1] = cand[1, 0]
                    cand_t = torch.from_numpy(cand).to(dev)
                    rows = eff[cand_t.clamp(min=0).long()]                # [b, r, dp]
                    s64 = torch.einsum("bd,brd->br", q_all[:b].double(), rows)
                    if metric == "l2":
                        s64 = 2.0 * s64 - (rows * rows).sum(-1)
                    s64 = torch.where(cand_t >= 0, s64, float("-inf")).cpu().numpy()
                    qb = q_all[:b]
                    for k in (1, 10, 100):
                        if k > r:
                            continue
                        tag = f"{dtype} {metric} B={b} R={r} k={k}"
                        before = rerank.LAUNCHES
                        (kv, ki), ops_seen = dispatched_ops(
                            torch, lambda: rerank.rerank_topk_cuda(
                                qb, cand_t, store, sc, k, norms2=n2, metric=metric))
                        torch.cuda.synchronize(dev)
                        check(rerank.LAUNCHES == before + 1, f"{tag}: not one launch")
                        other = [name for name, _ in ops_seen if "empty" not in name]
                        check(not other, f"{tag}: the wrapper ran {other} beside its launch")
                        pv, pi = rerank.rerank_topk_reference(q_all[:b], cand_t, store, sc,
                                                              k, norms2=n2, metric=metric)
                        fin = ki >= 0
                        err = float((kv[fin] - pv[fin]).abs().max()) if bool(fin.any()) else 0.0
                        check(bool((fin == (pi >= 0)).all()), f"{tag}: filler differs")
                        check(bool(torch.allclose(kv[fin], pv[fin], atol=VALUE_ATOL,
                                                  rtol=VALUE_RTOL)),
                              f"{tag}: values differ from plain by {err}")
                        rg = rerank_regret(s64, cand, ki.cpu().numpy(), k)
                        check(rg <= REGRET_TOL, f"{tag}: regret {rg} > {REGRET_TOL}")
                        max_err = max(max_err, err)
                        if k == 10 or b == 256:
                            say(f"  {tag}: regret={rg:.3e} max_abs_err={err:.3e}")
        del store, eff, n2
    max_err = max(max_err, rerank_residual_cases(torch, dev, base, q_all, rng))
    torch.cuda.empty_cache()
    return max_err


def rerank_residual_cases(torch, dev, base, q_all, rng, nlist=64):
    """A residual-int8 store (row = cent + s * codes): q.cent is gathered in
    torch and folded inside the kernel; held against the plain version and
    a float64 oracle over the dequantized rows, both metrics."""
    from nvdb_tpu_torch.formats import vecbin
    from nvdb_tpu_torch.kernels import rerank

    n, dp = base.shape
    cents = base[rng.choice(n, nlist, replace=False)]
    list_of = rng.integers(0, nlist, n).astype(np.int32)
    rows = 0.7 * cents[list_of] + 0.3 * base
    codes, scn = vecbin.quantize_i8(rows - cents[list_of])
    deq = cents[list_of].astype(np.float64) + codes.astype(np.float64) * scn[:, None]
    store, sc = torch.from_numpy(codes).to(dev), torch.from_numpy(scn).to(dev)
    res_cents, res_ids = torch.from_numpy(cents).to(dev), torch.from_numpy(list_of).to(dev)
    n2 = torch.from_numpy((deq * deq).sum(1).astype(np.float32)).to(dev)
    eff = torch.from_numpy(deq).to(dev)
    worst = 0.0
    for metric in ("l2", "dot"):
        for b, r, k in ((8, 100, 10), (256, 100, 10), (8, 256, 100)):
            cand = np.stack([rng.choice(n, r, replace=False) for _ in range(b)]).astype(np.int32)
            cand[0, r // 2:] = -1
            cand[1, 1] = cand[1, 0]
            cand_t = torch.from_numpy(cand).to(dev)
            rows64 = eff[cand_t.clamp(min=0).long()]
            s64 = torch.einsum("bd,brd->br", q_all[:b].double(), rows64)
            if metric == "l2":
                s64 = 2.0 * s64 - (rows64 * rows64).sum(-1)
            s64 = torch.where(cand_t >= 0, s64, float("-inf")).cpu().numpy()
            kw = dict(norms2=n2 if metric == "l2" else None, metric=metric,
                      res_cents=res_cents, res_ids=res_ids)
            before = rerank.LAUNCHES
            kv, ki = rerank.rerank_topk_cuda(q_all[:b], cand_t, store, sc, k, **kw)
            torch.cuda.synchronize(dev)
            pv, pi = rerank.rerank_topk_reference(q_all[:b], cand_t, store, sc, k, **kw)
            tag = f"residual i8 {metric} B={b} R={r} k={k}"
            check(rerank.LAUNCHES == before + 1, f"{tag}: not one launch")
            fin = ki >= 0
            err = float((kv[fin] - pv[fin]).abs().max())
            check(bool((fin == (pi >= 0)).all()), f"{tag}: filler differs")
            check(bool(torch.allclose(kv[fin], pv[fin], atol=VALUE_ATOL, rtol=VALUE_RTOL)),
                  f"{tag}: values differ from plain by {err}")
            rg = rerank_regret(s64, cand, ki.cpu().numpy(), k)
            check(rg <= REGRET_TOL, f"{tag}: regret {rg} > {REGRET_TOL}")
            worst = max(worst, err)
            say(f"  {tag}: regret={rg:.3e} max_abs_err={err:.3e}")
    return worst


def phase_ivf_main_path(torch, dev, work, n=1_000_000, nlist=4096):
    """Phase 8. Its corpus, queries, ground truth, index and residual codes
    stay in ``work`` for phases 14 and 15; the plain int8 store goes at its end."""
    d, nq, k = 768, 1024, 10
    paths = work_paths(work, "ivf", ("base.vecbin", "q.vecbin", "gt.gtbin", "index.npz",
                                     "res.vecbin", "i8.vecbin"))
    try:
        return _ivf_main_path(torch, dev, n, nlist, d, nq, k, paths) + (paths,)
    finally:
        remove_files({"i8.vecbin": paths["i8.vecbin"]})


def adc_reset():
    """Every ADC launch counter (tables, the staged dma, key, gather and
    fused scans) to 0."""
    from nvdb_tpu_torch.kernels import adc_scan

    adc_scan.LAUNCHES = adc_scan.TABLE_LAUNCHES = adc_scan.KEY_LAUNCHES = 0
    adc_scan.GATHER_LAUNCHES = adc_scan.FUSED_LAUNCHES = adc_scan.FUSED_DMA_LAUNCHES = 0
    adc_scan.QTERM_LAUNCHES = 0


def adc_counts():
    """The ADC launch counters by the kernels' record names."""
    from nvdb_tpu_torch.kernels import adc_scan

    return {"adc_tables": adc_scan.TABLE_LAUNCHES, "adc_topk": adc_scan.LAUNCHES,
            "adc_topk_key": adc_scan.KEY_LAUNCHES, "adc_topk_gather": adc_scan.GATHER_LAUNCHES,
            "adc_fused_key": adc_scan.FUSED_LAUNCHES,
            "adc_fused_dma": adc_scan.FUSED_DMA_LAUNCHES,
            "adc_query_terms": adc_scan.QTERM_LAUNCHES}


def ivf_eval_counted(torch, main, argv, first=True):
    """One ``ivf_eval`` run with every IVF-PQ launch counter set to 0 just
    before it; returns (its first RESULT record, or all of them unless
    ``first``, and the counts just after). In a run of ``--ids-mode
    gather`` the fused key scan serves the gather site, so its launches
    count as ``adc_fused_gather`` (the gather site's row of the record)."""
    from nvdb_tpu_torch.kernels import rerank

    adc_reset()
    rerank.LAUNCHES = 0
    res = run_tool(main, argv, keep=("kind=", "RESULT"))
    counts = dict(adc_counts(), rerank_topk=rerank.LAUNCHES, adc_fused_gather=0)
    if "--ids-mode" in argv and argv[argv.index("--ids-mode") + 1] == "gather":
        counts["adc_fused_gather"], counts["adc_fused_key"] = counts["adc_fused_key"], 0
    return res[0] if first else res, counts


def _ivf_main_path(torch, dev, n, nlist, d, nq, k, paths):
    from nvdb_tpu_torch.formats import gtbin, vecbin
    from nvdb_tpu_torch.index.flat import FlatIndex
    from nvdb_tpu_torch.store import VectorStore
    from nvdb_tpu_torch.tools import ivf_build, ivf_eval, make_query, quantize_i8, synth

    # the corpus and queries as a user makes them: tools.synth, tools.make_query
    t0 = time.perf_counter()
    run_tool(synth.main, [paths["base.vecbin"], "--count", str(n), "--dim", str(d),
                          "--clusters", "16384", "--spread", "0.25", "--seed", "41"],
             keep=("wrote",))
    t1 = time.perf_counter()
    run_tool(make_query.main, [paths["base.vecbin"], paths["q.vecbin"], "--q", str(nq),
                               "--seed", "42", "--perturb", "0.05"], keep=("wrote",))
    queries = vecbin.VecbinFile(paths["q.vecbin"]).rows_f32()
    say(f"  tools.synth ({n} x {d} clustered f32) {t1 - t0:.1f} s, tools.make_query "
        f"({nq} queries) {time.perf_counter() - t1:.1f} s")

    t0 = time.perf_counter()
    store = VectorStore.from_vecbin(paths["base.vecbin"], device=dev)
    flat_reset()
    gt = FlatIndex(store).search(queries, k)[1]
    gtbin.write_gtbin(paths["gt.gtbin"], gt, dim=d, N=n)
    say(f"  ground truth by the flat kernel (f32 store): {time.perf_counter() - t0:.1f} s")
    gt_launches = flat_counts("ground truth", f32=True)

    idx = run_tool(ivf_build.main, [paths["base.vecbin"], paths["index.npz"], "--kind",
                                    "ivfpq", "--nlist", str(nlist), "--pq-m", "96", "--opq",
                                    "--device", dev.type], keep=("built",))
    check(idx.lcap > 0 and idx.m == 96 and idx.nlist == nlist, "build: shape")

    eval_args = [paths["index.npz"], paths["base.vecbin"], paths["q.vecbin"], "--gt",
                 paths["gt.gtbin"], "--chained", "--nprobe", "64", "--refine-k", "100",
                 "--k", str(k), "--batch-q", "256", "--device", dev.type]
    # (name, extra flags, the launch counters the run must raise); each run's
    # counters are set to 0 just before it and read just after
    runs = [("auto", [], ("adc_fused_key", "adc_query_terms", "rerank_topk")),
            ("tables", ["--key-scan", "tables"], ("adc_tables", "adc_query_terms", "adc_topk_key")),
            ("dma", ["--ids-mode", "dma"], ("adc_fused_dma", "adc_query_terms", "rerank_topk")),
            ("dma_tables", ["--ids-mode", "dma", "--key-scan", "tables"],
             ("adc_tables", "adc_query_terms", "adc_topk")),
            ("gather", ["--ids-mode", "gather"],
             ("adc_fused_gather", "adc_query_terms", "rerank_topk")),
            ("gather_tables", ["--ids-mode", "gather", "--key-scan", "tables"],
             ("adc_tables", "adc_query_terms", "adc_topk_gather")),
            ("torch", ["--ivf-backend", "torch"], ())]
    out = {"launches": {"flat_topk": gt_launches}}
    for name, extra, counted in runs:
        res, launches = ivf_eval_counted(torch, ivf_eval.main, eval_args + extra)
        for c in counted:
            check(launches[c] > 0, f"ivf_eval {name}: the IVF-PQ main path did not "
                                   f"launch {c}")
            out["launches"][c] = out["launches"].get(c, 0) + launches[c]
        say(f"  ivf_eval {' '.join(extra) or '(auto: key candidates, fused)'}: recall@10="
            f"{res['recall']:.4f} QPS={res['qps']:.1f} launches {launches}")
        out[name] = res
        if name in ("auto", "gather", "dma"):
            fused = ("adc_fused_dma",) if name == "dma" else ("adc_fused_key", "adc_fused_gather")
            others = {c: launches[c] for c in ("adc_tables", "adc_topk", "adc_topk_key",
                                               "adc_topk_gather", "adc_fused_key",
                                               "adc_fused_gather", "adc_fused_dma")
                      if c not in fused}
            check(not any(others.values()), f"the {name} path ran another ADC kernel beside "
                                             f"the fused scan: {launches}")
            check(launches["adc_query_terms"] == sum(launches[c] for c in fused),
                  f"the {name} path: not one query-term pass a fused call: {launches}")
        if name.endswith("tables"):
            check(launches["adc_query_terms"] == launches["adc_tables"],
                  f"the {name} path: not one query-term pass a table launch: {launches}")
    check(out["tables"]["recall"] == out["auto"]["recall"],
          f"two-kernel key recall {out['tables']['recall']} != fused {out['auto']['recall']}")
    check(out["dma_tables"]["recall"] == out["dma"]["recall"],
          f"staged dma recall {out['dma_tables']['recall']} != fused {out['dma']['recall']}")
    for a, b in (("auto", "torch"), ("auto", "dma")):
        gap = abs(out[a]["recall"] - out[b]["recall"])
        check(gap <= RECALL_GAP, f"recall@10 {a} {out[a]['recall']} vs {b} "
                                 f"{out[b]['recall']}: gap {gap} > {RECALL_GAP}")
    for name in ("gather", "gather_tables"):
        check(out[name]["recall"] == out["auto"]["recall"],
              f"{name} recall {out[name]['recall']} != key {out['auto']['recall']}")
    check(out["auto"]["recall"] >= 0.5, f"recall@10 {out['auto']['recall']} < 0.5")

    # the residual-int8 refine of the JAX package's flagship: residual codes
    # of the same base against this index, then the refine on both paths
    t0 = time.perf_counter()
    run_tool(quantize_i8.main, [paths["base.vecbin"], paths["res.vecbin"], "--residual",
                                paths["index.npz"]], keep=("wrote",))
    say(f"  quantize_i8 --residual: {time.perf_counter() - t0:.1f} s")
    res_args = [paths["index.npz"], paths["res.vecbin"]] + eval_args[2:] + ["--residual-refine"]
    for name, extra, counted in (("res_auto", [], ("adc_fused_key", "rerank_topk")),
                                 ("res_torch", ["--ivf-backend", "torch"], ())):
        res, launches = ivf_eval_counted(torch, ivf_eval.main, res_args + extra)
        for c in counted:
            check(launches[c] > 0, f"ivf_eval --residual-refine did not launch {c}")
            out["launches"][c] = out["launches"].get(c, 0) + launches[c]
        say(f"  ivf_eval --residual-refine {' '.join(extra)}: recall@10={res['recall']:.4f} "
            f"QPS={res['qps']:.1f} launches {launches}")
        out[name] = res
    gap = abs(out["res_auto"]["recall"] - out["res_torch"]["recall"])
    check(gap <= RECALL_GAP, f"residual refine: kernel recall {out['res_auto']['recall']} "
                             f"vs plain {out['res_torch']['recall']}: gap {gap}")
    # the same bytes a row without the centroid: a plain int8 refine store
    run_tool(quantize_i8.main, [paths["base.vecbin"], paths["i8.vecbin"]], keep=("wrote",))
    res, _ = ivf_eval_counted(torch, ivf_eval.main,
                              [paths["index.npz"], paths["i8.vecbin"]] + eval_args[2:])
    out["i8"] = res
    say(f"  refine recall@10 by store: f32 {out['auto']['recall']:.4f}, residual int8 "
        f"{out['res_auto']['recall']:.4f}, plain int8 {res['recall']:.4f} (QPS {res['qps']:.1f})")
    say(f"  launches on the IVF-PQ main paths: {out['launches']}")
    return idx, store, queries, out


def key_scan_times(torch, lut, probes, idx, kk, fills, rows, dma):
    """The key kernel, the gather kernel's two parts (the slab copy, then
    the scan over the slab) and the whole gather wrapper at the flagship
    shape, each against its plain version in turns, beside their bounds;
    the key result checked against the dma kernel's on the same tables.
    ``rows``: the distinct probed lists' live slots."""
    from nvdb_tpu_torch.kernels import adc_scan

    out = {}
    args = (lut, probes, idx.codes, idx.slot_ids, kk)
    b, p = probes.shape
    slots = int(fills[probes.long()].sum())
    # bytes: each distinct probed list's live codes once, the bf16 tables, the
    # probes, the result (no slot ids: the winners' ids are read in pass 2, kk
    # per query); operations: every (query, probe) pair's lookups
    nbytes = rows * idx.m + lut.numel() * 2 + probes.numel() * 4 + b * kk * 12
    bnd, by = bound_ms(nbytes, float(slots) * idx.m, "f32")
    kern, plain, runs = in_turns(
        torch, lambda: adc_scan.adc_topk_keys_reference(*args, fills=fills),
        lambda: adc_scan.adc_topk_keys_cuda(*args, fills=fills), iters=5)
    say(f"  ADC key B={b} P={p} kk={kk}: kernel {kern:.4f} ms {runs['kernel']} | plain "
        f"{plain:.4f} ms {runs['plain']}")
    say(f"    bound {bnd:.4f} ms ({by}: {nbytes / 1e9:.4f} GB) time / bound {kern / bnd:.2f}")
    out["adc_topk_key"] = dict(ms=kern, plain_ms=plain, bound_ms=bnd, bound_by=by)
    sh, dn = check_keys(torch, "flagship key", lut, probes, idx.codes, idx.slot_ids, kk, fills,
                        dma)
    say(f"    key = gather = plain bit for bit; id overlap with the dma kernel {sh / dn:.4f}")

    slab_bytes = b * p * idx.m * idx.lcap
    copy_ms = cuda_ms(torch, lambda: adc_scan.gather_codes(idx.codes, probes), iters=5)
    # the copy reads each distinct probed list once and writes the slab
    list_bytes = int(torch.unique(probes).numel()) * idx.m * idx.lcap
    cbnd, _ = bound_ms(list_bytes + slab_bytes, 0.0, "f32")
    slab = adc_scan.gather_codes(idx.codes, probes)
    scan_ms = cuda_ms(torch, lambda: adc_scan.adc_topk_keys_cuda(
        lut, probes, idx.codes, idx.slot_ids, kk, fills=fills, gathered=True, slab=slab),
        iters=5)
    kern, plain, runs = in_turns(
        torch, lambda: adc_scan.adc_topk_keys_reference(
            lut, probes, adc_scan.gather_codes(idx.codes, probes), idx.slot_ids, kk,
            fills=fills, gathered=True),
        lambda: adc_scan.adc_topk_keys_cuda(*args, fills=fills, gathered=True), iters=5)
    say(f"  ADC gather B={b} P={p} kk={kk}: wrapper {kern:.4f} ms {runs['kernel']} = "
        f"index_select of the {slab_bytes / 1e9:.4f} GB slab from {list_bytes / 1e9:.4f} GB "
        f"of distinct lists {copy_ms:.4f} ms (bound {cbnd:.4f} ms) + scan of the "
        f"slab {scan_ms:.4f} ms | plain {plain:.4f} ms {runs['plain']}")
    say(f"    bound {bnd:.4f} ms ({by}, the key scan's: the slab is the mode's own "
        f"intermediate) time / bound {kern / bnd:.2f}")
    out["adc_topk_gather"] = dict(ms=kern, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                  index_select_ms=copy_ms, scan_ms=scan_ms)
    del slab
    return out


# measurement builds of adc_topk.cu for phase 9's split of a fused call
FUSED_ABLATIONS = (("tables", ("NVDB_ADC_ABLATE=3",)), ("lookups", ("NVDB_ADC_ABLATE=4",)),
                   ("selection", ("NVDB_ADC_ABLATE=5",)))


def graph_turns(torch, plain, kern, launches=10):
    """plain, kernel, kernel, plain, each as ``launches`` calls in one CUDA
    graph (device ms a call); returns (kernel ms, plain ms, runs)."""
    runs = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        runs[name].append(graph_ms(torch, plain if name == "plain" else kern,
                                   launches=launches, replays=5))
    return sum(runs["kernel"]) / 2, sum(runs["plain"]) / 2, runs


def peak_gb(torch, dev, fn):
    """GB of device memory one call of ``fn`` holds at its peak above what
    was allocated before it."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    fn()
    torch.cuda.synchronize(dev)
    return (torch.cuda.max_memory_allocated(dev) - base) / 1e9


def capturing(idx, fn):
    """``fn`` with ``idx``'s CUDA graphs dropped first, so the served call it
    makes captures its chain: the call's eager warm-up and its capture
    dispatch every operator and allocate every buffer of the chain, which a
    replay does not (``nvdb_tpu_torch/index/graphs.py``)."""
    def call():
        idx._graphs.clear()
        return fn()
    return call


def capture_gb(torch, dev, idx, fn):
    """(peak GB above what was allocated before, GB reserved in the graphs'
    memory pool) of one served call of ``fn`` that captures its chain
    (``capturing``): the peak holds the warm-up's and the capture's
    buffers; the pool, the caching allocator's segments of ``idx``'s graph
    pool, holds the chain's buffers for the replays."""
    peak = peak_gb(torch, dev, capturing(idx, fn))
    pool = tuple(idx._graphs._pool)
    held = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == pool)
    check(held > 0, f"no segment of the graphs' pool {pool} in the allocator's snapshot")
    return peak, held / 1e9


def fused_times(torch, dev, idx, q_rot, probes, kk, fills):
    """The fused key scan at B = 256, 8 and 1: at the key site against the
    two kernels it replaces (the table kernel, then the key scan), and at
    the gather site against the slab route it replaces (the table kernel,
    then the gather wrapper: the ``index_select`` of the slab and the scan
    over it) with each route's peak device memory over one call; in turns,
    eagerly and as device time (calls in a CUDA graph), bit for bit. Its
    bound, codebook L2 bytes and lookups, its plain version, the chunk
    sweep, the call by pass and a call replayed from a CUDA graph. The
    query-term pass the fused scans open with, alone at each batch, bit for
    bit its plain version, beside its bound."""
    from nvdb_tpu_torch.kernels import _build, adc_scan, ivf_scan

    dsub = idx.codebooks.shape[2]
    dp = idx.centroids.shape[1]
    index = dev.index or 0
    out, gather, qterms = {}, {}, {}
    for b in (256, 8, 1):
        qb, pb_ = q_rot[:b].contiguous(), probes[:b].contiguous()
        # the query-term pass alone: bytes, the queries and codebooks read and
        # the terms written; operations, each term's dot (2 dsub FLOP) and its
        # combination
        qt = lambda: adc_scan.adc_query_terms_cuda(qb, idx.codebooks)
        check(torch.equal(qt(), adc_scan.adc_query_terms_reference(qb, idx.codebooks)),
              f"query terms B={b}: differ from the plain version")
        qt_ms = graph_ms(torch, qt, launches=20, replays=5)
        terms = b * idx.m * 256
        qbnd, qby = bound_ms(terms * 4 + b * dp * 4 + idx.codebooks.numel() * 4,
                             float(terms) * (2 * dsub + 2), "f32")
        say(f"  query-term pass B={b} M={idx.m} dsub={dsub}: device {qt_ms:.4f} ms (20 calls "
            f"in a CUDA graph) | bound {qbnd:.4f} ms ({qby}: {terms * 4 / 1e6:.2f} MB written) "
            f"time / bound {qt_ms / qbnd:.2f}; bit for bit its plain version")
        qterms[b] = dict(ms=qt_ms, bound_ms=qbnd, bound_by=qby)
        args = (qb, pb_, idx.centroids, idx.codebooks, idx.codes, idx.slot_ids, kk)
        fused = lambda: adc_scan.adc_fused_keys_cuda(*args, fills=fills)
        two = lambda: adc_scan.adc_topk_keys_cuda(
            adc_scan.adc_tables_cuda(qb, pb_, idx.centroids, idx.codebooks, fills), pb_,
            idx.codes, idx.slot_ids, kk, fills=fills)
        slab = lambda: adc_scan.adc_topk_keys_cuda(
            adc_scan.adc_tables_cuda(qb, pb_, idx.centroids, idx.codebooks, fills), pb_,
            idx.codes, idx.slot_ids, kk, fills=fills, gathered=True)
        kern, two_ms, runs = in_turns(torch, two, fused, iters=10)
        gk, gt, gruns = graph_turns(torch, two, fused)
        fv, fi = fused()
        tv, ti = two()
        check(torch.equal(fv, tv) and torch.equal(fi, ti),
              f"fused B={b}: differs from the two-kernel key path on the flagship index")
        tv, ti = slab()
        check(torch.equal(fv, tv) and torch.equal(fi, ti),
              f"fused B={b}: differs from the gather site's slab route on the flagship index")
        del fv, fi, tv, ti
        # bytes: each distinct probed list's live codes once, the queries, the
        # distinct probed centroids, the codebooks, the probes, the result;
        # operations: every live pair's table entries (2 dsub + 4 FLOP each)
        # and every lookup's add, at the f32 rate
        pb = ivf_scan.probe_bytes(pb_, fills, idx.m, idx.nlist)
        lookups = pb["as_probed"]
        nbytes = (pb["rows"] * idx.m + b * dp * 4 + pb["lists"] * dp * 4
                  + idx.codebooks.numel() * 4 + pb_.numel() * 4 + b * kk * 8)
        flops = float(pb["pairs"]) * idx.m * 256 * (2 * dsub + 4) + lookups
        bnd, by = bound_ms(nbytes, flops, "f32")
        nq_max = adc_scan.FUSED_NQ_MAX if b >= adc_scan.FUSED_CHUNK_MIN_BATCH else 1
        nq = adc_scan.fused_plan(idx.m, nq_max, index)
        items = ivf_scan.group_pairs_reference(pb_, fills, nq)[1]
        tiles = -(-idx.lcap // adc_scan.FUSED_TILE)
        cb_bytes = int(items.shape[0]) * tiles * idx.codebooks.numel() * 4
        say(f"  fused key scan B={b} P={probes.shape[1]} kk={kk} (chunks of {nq}, "
            f"{items.shape[0]} items on {pb['lists']} lists): {kern:.4f} ms {runs['kernel']} | "
            f"tables + key scan {two_ms:.4f} ms {runs['plain']} | device time (10 calls in a "
            f"CUDA graph) fused {gk:.4f} {gruns['kernel']}, two kernels {gt:.4f} "
            f"{gruns['plain']}; bit for bit equal")
        # the work the scan does now: each entry's query share once a query,
        # its list share once an item and subspace, then one FMA and one add a
        # pair and entry
        done = (float(b) * idx.m * 256 * (2 * dsub + 2) + float(items.shape[0]) * tiles
                * idx.m * 256 * 2 * dsub + float(pb["pairs"]) * idx.m * 256 * 3 + lookups)
        say(f"    bound {bnd:.4f} ms ({by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e9:.4f} GB) "
            f"time / bound {kern / bnd:.2f} (device {gk / bnd:.2f}); {lookups / 1e9:.3f} G "
            f"lookups into shared memory; codebook bytes from L2 {cb_bytes / 1e9:.3f} GB; "
            f"the operations the scan performs {done / 1e9:.3f} GFLOP (bound "
            f"{bound_ms(0, done, 'f32')[0]:.4f} ms), its query terms from L2 "
            f"{float(pb['pairs']) * idx.m * 1024 / 1e9:.3f} GB")
        out[b] = dict(ms=kern, two_ms=two_ms, device_ms=gk, two_device_ms=gt, bound_ms=bnd,
                      bound_by=by, lookups=lookups, codebook_bytes=cb_bytes, nq=nq,
                      items=int(items.shape[0]))
        # the gather site: the same call in turns with the slab route
        kern, slab_ms, runs = in_turns(torch, slab, fused, iters=10)
        gk, gs, gruns = graph_turns(torch, slab, fused)
        peak, slab_peak = peak_gb(torch, dev, fused), peak_gb(torch, dev, slab)
        say(f"  gather site B={b}: fused (lists read in place) {kern:.4f} ms {runs['kernel']} | "
            f"slab route (tables + index_select + scan of the slab) {slab_ms:.4f} ms "
            f"{runs['plain']} | device time fused {gk:.4f} {gruns['kernel']}, slab route "
            f"{gs:.4f} {gruns['plain']}; bit for bit equal")
        say(f"    bound {bnd:.4f} ms ({by}) time / bound {kern / bnd:.2f} (device "
            f"{gk / bnd:.2f}); peak device memory of one call: fused {peak:.4f} GB, slab "
            f"route {slab_peak:.4f} GB")
        gather[b] = dict(ms=kern, slab_ms=slab_ms, device_ms=gk, slab_device_ms=gs,
                         bound_ms=bnd, bound_by=by, peak_gb=peak, slab_peak_gb=slab_peak)
    qb, pb_ = q_rot, probes
    args = (qb, pb_, idx.centroids, idx.codebooks, idx.codes, idx.slot_ids, kk)
    plain = cuda_ms(torch, lambda: adc_scan.adc_fused_keys_reference(*args, fills=fills),
                    iters=2)
    say(f"  fused key scan B=256: plain version (adc_tables_reference, then "
        f"adc_topk_keys_reference; the key and gather sites') {plain:.4f} ms")
    sweep = {nq: graph_ms(torch, lambda nq=nq: adc_scan.adc_fused_keys_cuda(
        *args, fills=fills, nq_max=nq), launches=10, replays=5) for nq in (1, 4, 8, 16, 32)}
    say("  fused key scan B=256, device ms by the widest chunk the plan may take: " + "; ".join(
        f"{nq} {ms:.4f}" for nq, ms in sweep.items())
        + f" (default {adc_scan.FUSED_NQ_MAX})")
    # the call by pass: measurement builds that stop after building the
    # tables, after the lookups and before the merge (wrong by design)
    split = {}
    port_lib = adc_scan._fused_lib
    try:
        for part, defines in FUSED_ABLATIONS:
            lib = adc_scan.bind_fused(_build.load("adc_topk", defines))
            adc_scan._fused_lib = lambda lib=lib: lib
            split[part] = graph_ms(torch, lambda: adc_scan.adc_fused_keys_cuda(
                *args, fills=fills), launches=10, replays=5)
    finally:
        adc_scan._fused_lib = port_lib
    whole = graph_ms(torch, lambda: adc_scan.adc_fused_keys_cuda(*args, fills=fills),
                     launches=10, replays=5)
    say(f"  fused key scan B=256 by part (device ms): the query terms, pass 0, staging and "
        f"tables {split['tables']:.4f}, lookups {split['lookups'] - split['tables']:.4f}, "
        f"selection {split['selection'] - split['lookups']:.4f}, merge "
        f"{whole - split['selection']:.4f}; the whole call {whole:.4f}")
    graph_replay_check(torch, lambda: adc_scan.adc_fused_keys_cuda(*args, fills=fills))
    say("  one fused call (B=256) captured in a CUDA graph and replayed: equal to an eager "
        "call bit for bit")
    res = dict(out[256], plain_ms=plain, sweep=sweep, by_part=dict(split, whole=whole),
               by_batch=out)
    qt_plain = cuda_ms(torch, lambda: adc_scan.adc_query_terms_reference(q_rot, idx.codebooks),
                       iters=2)
    return {"adc_fused_key": res,
            "adc_fused_gather": dict(gather[256], plain_ms=plain, by_batch=gather),
            "adc_query_terms": dict(qterms[256], plain_ms=qt_plain, by_batch=qterms)}


def fused_dma_times(torch, dev, idx, q_rot, probes, fills):
    """The fused dma scan (the dma mode's route) at kk = 100 and 10 and B =
    256, 8 and 1 against the staged route it replaces (the table kernel,
    then the staged dma scan), in turns, eagerly and as device time (calls
    in a CUDA graph), bit for bit, with each route's peak device memory over
    one call; its bound, its plain version and the repeated-id check's cost
    at B = 256, and one call replayed from a CUDA graph. The index has
    replicas 1, so the route runs with ``dedup=False``, as ``search_device``
    does there."""
    from nvdb_tpu_torch.kernels import _build, adc_scan, ivf_scan

    dsub = idx.codebooks.shape[2]
    dp = idx.centroids.shape[1]
    out = {}
    for kk in (100, 10):
        for b in (256, 8, 1):
            qb, pb_ = q_rot[:b].contiguous(), probes[:b].contiguous()
            args = (qb, pb_, idx.centroids, idx.codebooks, idx.codes, idx.slot_ids, kk)
            fused = lambda: adc_scan.adc_fused_topk_cuda(*args, fills=fills, dedup=False)
            staged = lambda: adc_scan.adc_topk_cuda(
                adc_scan.adc_tables_cuda(qb, pb_, idx.centroids, idx.codebooks, fills), pb_,
                idx.codes, idx.slot_ids, kk, fills=fills)
            kern, st_ms, runs = in_turns(torch, staged, fused, iters=10)
            gk, gs, gruns = graph_turns(torch, staged, fused)
            fv, fi = fused()
            sv, si = staged()
            check(torch.equal(fv, sv) and torch.equal(fi, si),
                  f"fused dma B={b} kk={kk}: differs from the staged route on the flagship index")
            del fv, fi, sv, si
            peak, st_peak = peak_gb(torch, dev, fused), peak_gb(torch, dev, staged)
            if b == 256:
                check(peak <= 0.05, f"fused dma B=256 kk={kk}: peak memory {peak} GB > 0.05")
            # bytes: each distinct probed list's live codes and slot ids once,
            # the queries, the distinct probed centroids, the codebooks, the
            # probes, the result; operations: the fused key scan's (every live
            # pair's table entries, 2 dsub + 4 FLOP each, and every lookup's add)
            pb = ivf_scan.probe_bytes(pb_, fills, idx.m, idx.nlist)
            lookups = pb["as_probed"]
            nbytes = (pb["rows"] * (idx.m + 4) + b * dp * 4 + pb["lists"] * dp * 4
                      + idx.codebooks.numel() * 4 + pb_.numel() * 4 + b * kk * 8)
            flops = float(pb["pairs"]) * idx.m * 256 * (2 * dsub + 4) + lookups
            bnd, by = bound_ms(nbytes, flops, "f32")
            say(f"  fused dma B={b} P={probes.shape[1]} kk={kk}: {kern:.4f} ms {runs['kernel']} | "
                f"staged route (tables + dma scan) {st_ms:.4f} ms {runs['plain']} | device time "
                f"(10 calls in a CUDA graph) fused {gk:.4f} {gruns['kernel']}, staged {gs:.4f} "
                f"{gruns['plain']}; bit for bit equal")
            say(f"    bound {bnd:.4f} ms ({by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e9:.4f} GB) "
                f"time / bound {kern / bnd:.2f} (device {gk / bnd:.2f}); peak device memory of "
                f"one call: fused {peak:.4f} GB, staged {st_peak:.4f} GB")
            out[(kk, b)] = dict(ms=kern, staged_ms=st_ms, device_ms=gk, staged_device_ms=gs,
                                bound_ms=bnd, bound_by=by, peak_gb=peak, staged_peak_gb=st_peak)
    args = (q_rot, probes, idx.centroids, idx.codebooks, idx.codes, idx.slot_ids, 100)
    plain = cuda_ms(torch, lambda: adc_scan.adc_fused_topk_reference(
        *args, fills=fills, dedup=False), iters=1)
    leads = adc_scan.tile_leads(idx.slot_ids)
    dedup_ms = graph_ms(torch, lambda: adc_scan.adc_fused_topk_cuda(
        *args, fills=fills, leads=leads), launches=10, replays=5)
    say(f"  fused dma B=256 kk=100: plain version (adc_fused_topk_reference) {plain:.4f} ms; "
        f"device ms with the repeated-id check (leads of this index, none repeated) "
        f"{dedup_ms:.4f} against {out[(100, 256)]['device_ms']:.4f} without")
    # the call by pass, as the fused key scan's: measurement builds that stop
    # after the tables, after the lookups and before the merge
    split = {}
    port_lib = adc_scan._fused_lib
    try:
        for part, defines in FUSED_ABLATIONS:
            lib = adc_scan.bind_fused(_build.load("adc_topk", defines))
            adc_scan._fused_lib = lambda lib=lib: lib
            split[part] = graph_ms(torch, lambda: adc_scan.adc_fused_topk_cuda(
                *args, fills=fills, dedup=False), launches=10, replays=5)
    finally:
        adc_scan._fused_lib = port_lib
    whole = graph_ms(torch, lambda: adc_scan.adc_fused_topk_cuda(*args, fills=fills,
                                                                 dedup=False),
                     launches=10, replays=5)
    say(f"  fused dma B=256 kk=100 by part (device ms): the query terms, pass 0, staging and "
        f"tables {split['tables']:.4f}, lookups {split['lookups'] - split['tables']:.4f}, "
        f"selection {split['selection'] - split['lookups']:.4f}, merge "
        f"{whole - split['selection']:.4f}; the whole call {whole:.4f}")
    graph_replay_check(torch, lambda: adc_scan.adc_fused_topk_cuda(*args, fills=fills,
                                                                   dedup=False))
    say("  one fused dma call (B=256) captured in a CUDA graph and replayed: equal to an eager "
        "call bit for bit")
    return {"adc_fused_dma": dict(out[(100, 256)], plain_ms=plain, dedup_device_ms=dedup_ms,
                                  by_part=dict(split, whole=whole),
                                  by_batch={f"kk={kk} B={b}": t for (kk, b), t in out.items()})}


def phase_ivf_times(torch, dev, idx, store, queries):
    from nvdb_tpu_torch.index.ivf_flat import _coarse_probes
    from nvdb_tpu_torch.kernels import adc_scan, ivf_scan, ops, rerank

    out = {}
    b, nprobe, kk = 256, min(64, idx.nlist), 100
    q = torch.zeros((b, idx.centroids.shape[1]), device=dev)
    q[:, :idx.d] = torch.from_numpy(queries[:b]).to(dev)
    fills, terms = idx.fills(), idx.coarse_terms()
    dsub = idx.codebooks.shape[2]

    def rotate_and_rank():
        ops.no_tf32()
        q_rot = q @ idx.rotation
        return q_rot, _coarse_probes(q_rot, idx.centroids, idx.slot_ids, nprobe, terms=terms)

    q_rot, probes = rotate_and_rank()
    probes = probes.to(torch.int32)
    coarse_ms = cuda_ms(torch, rotate_and_rank, iters=10)
    # bytes: queries in and out, the rotation, the centroids, the probes;
    # operations: the two f32 products
    dp = q.shape[1]
    nbytes = 2 * q.numel() * 4 + dp * dp * 4 + idx.centroids.numel() * 4 + probes.numel() * 8
    bnd, by = bound_ms(nbytes, 2.0 * b * dp * (dp + idx.nlist), "f32")
    say(f"  rotation + coarse ranking B={b} (plain torch on both paths, nlist {idx.nlist}): "
        f"{coarse_ms:.4f} ms | bound {bnd:.4f} ms ({by}) time / bound {coarse_ms / bnd:.2f}")
    out["rotation + coarse ranking"] = dict(ms=coarse_ms, bound_ms=bnd, bound_by=by)

    targs = (q_rot, probes, idx.centroids, idx.codebooks, fills)
    kern, plain, runs = in_turns(torch, lambda: adc_scan.adc_tables_reference(*targs),
                                 lambda: adc_scan.adc_tables_cuda(*targs), iters=5)
    lut = adc_scan.adc_tables_cuda(*targs)
    live = adc_scan.live_probes(probes, fills)
    equal, worst = check_tables(torch, "flagship tables", lut,
                                adc_scan.adc_tables_reference(*targs), live)
    # bytes: the tables written; the queries, probes, codebooks and the
    # distinct probed centroids read
    nbytes = (lut.numel() * 2 + q_rot.numel() * 4 + probes.numel() * 4
              + idx.codebooks.numel() * 4
              + int(torch.unique(probes).numel()) * idx.centroids.shape[1] * 4)
    flops = 2.0 * int(live.sum()) * idx.m * 256 * dsub
    bnd, by = bound_ms(nbytes, flops, "f32")
    say(f"  tables B={b} P={nprobe} M={idx.m} dsub={dsub}: kernel {kern:.4f} ms {runs['kernel']} "
        f"| plain (pq.adc_lut + bf16 cast) {plain:.4f} ms {runs['plain']} | bit-equal "
        f"{equal:.6f}, worst {worst} bf16 step(s)")
    say(f"    bound {bnd:.4f} ms ({by}: {nbytes / 1e9:.4f} GB, {flops / 1e9:.2f} GFLOP) "
        f"time / bound {kern / bnd:.2f}")
    out["adc_tables"] = dict(ms=kern, plain_ms=plain, bound_ms=bnd, bound_by=by)

    args = (lut, probes, idx.codes, idx.slot_ids, kk)
    kern, plain, runs = in_turns(
        torch, lambda: adc_scan.adc_topk_reference(*args),
        lambda: adc_scan.adc_topk_cuda(*args, fills=fills), iters=5)
    live_share = float((idx.slot_ids[probes.long()] >= 0).float().mean())
    say(f"  ADC B={b} P={nprobe} M={idx.m} Lcap={idx.lcap} kk={kk} (live share of "
        f"probed slots {live_share:.3f}): kernel {kern:.4f} ms {runs['kernel']} | plain "
        f"{plain:.4f} ms {runs['plain']}")
    # bytes: each distinct probed list's live codes and ids once, the bf16
    # tables (an input, read once), the probes, the result; operations: a
    # lookup and an add for every live slot of every (query, probe) pair
    pb = ivf_scan.probe_bytes(probes, fills, idx.m, idx.nlist)
    slots = pb["as_probed"] // idx.m
    nbytes = pb["rows"] * (idx.m + 4) + lut.numel() * 2 + probes.numel() * 4 + b * kk * 8
    bnd, by = bound_ms(nbytes, float(slots) * idx.m, "f32")
    say(f"    bound {bnd:.4f} ms ({by}: {nbytes / 1e9:.4f} GB: {pb['rows']} live slots of "
        f"{pb['lists']} distinct lists; as probed {slots} slots, "
        f"{pb['as_probed'] / 1e9:.4f} GB of codes) time / bound {kern / bnd:.2f}")
    out["adc_topk"] = dict(ms=kern, plain_ms=plain, bound_ms=bnd, bound_by=by)
    kv, cand = adc_scan.adc_topk_cuda(*args, fills=fills)
    pv, pi = adc_scan.adc_topk_reference(*args)
    err, _ = check_adc(torch, "flagship scan", kv, cand, pv, pi)
    say(f"    scan on the kernel's tables vs plain on the same tables: max_abs_err={err:.3e}")
    out.update(key_scan_times(torch, lut, probes, idx, kk, fills, pb["rows"], (kv, cand)))
    cand = cand.contiguous()
    del lut, kv, pv, pi
    out.update(fused_times(torch, dev, idx, q_rot, probes, kk, fills))
    out.update(fused_dma_times(torch, dev, idx, q_rot, probes, fills))

    # the whole batch, its operators recorded: on the key path (the fused
    # key scan) nothing the size of the tables
    table_elems = b * nprobe * idx.m * 256
    search = lambda: idx.search_device(q, 10, nprobe, refine_k=kk, refine_store=store)
    search()          # the store computes and caches its norms on the first refine
    # each check below is made on a call that captures (``capturing``): a
    # replay dispatches no operator and allocates nothing of the chain
    _, ops_seen = dispatched_ops(torch, capturing(idx, search))
    big = [(name, shape, dt) for name, outs in ops_seen for shape, dt in outs
           if int(np.prod(shape)) >= table_elems]
    say(f"  search_device's warm-up and capture dispatch {len(ops_seen)} torch operators; "
        f"table-sized results: {big}")
    check(big == [], f"the key path made table-sized tensors: {big}")
    peak, pool = capture_gb(torch, dev, idx, search)
    say(f"    peak device memory of one batch (its warm-up and capture): {peak:.4f} GB, the "
        f"graph's pool {pool:.4f} GB reserved (the bf16 tables the key path no longer makes: "
        f"{table_elems * 2 / 1e9:.4f} GB)")
    check(max(peak, pool) < table_elems * 2 / 1e10,
          "the key path allocated or reserved a tenth of the bf16 tables")
    out["whole search_device"] = dict(peak_gb=peak, pool_gb=pool)
    whole_ms, whole_plain, runs = in_turns(
        torch, lambda: idx.search_device(q, 10, nprobe, refine_k=kk, refine_store=store,
                                         backend="torch"), search, iters=5)
    # the batch's bound: its stages', one after the other; the refine reads
    # each candidate's f32 row, id and norm
    dp = store.vectors.shape[1]
    refine_bnd, _ = bound_ms(int((cand >= 0).sum()) * (dp * 4 + 8) + b * dp * 4 + b * 10 * 8,
                             2.0 * cand.numel() * dp, "f32")
    whole_bnd = refine_bnd + sum(out[name]["bound_ms"] for name in (
        "rotation + coarse ranking", "adc_fused_key"))
    say(f"  whole search_device B={b}: kernels {whole_ms:.4f} ms {runs['kernel']} | plain "
        f"versions {whole_plain:.4f} ms {runs['plain']} | bound {whole_bnd:.4f} ms (the sum of "
        f"its stages' bounds) time / bound {whole_ms / whole_bnd:.2f}")
    out["whole search_device"].update(ms=whole_ms, plain_ms=whole_plain, bound_ms=whole_bnd)
    fused_ms, two_ms, runs = in_turns(
        torch, lambda: idx.search_device(q, 10, nprobe, refine_k=kk, refine_store=store,
                                         key_scan="tables"), search, iters=5)
    say(f"  whole search_device B={b}: fused key scan (auto) {fused_ms:.4f} ms {runs['kernel']} "
        f"| table kernel + key scan {two_ms:.4f} ms {runs['plain']}")
    dma = lambda: idx.search_device(q, 10, nprobe, refine_k=kk, refine_store=store,
                                    ids_mode="dma")
    key_ms, dma_ms, runs = in_turns(torch, dma, search, iters=5)
    say(f"  whole search_device B={b}: key candidates (auto) {key_ms:.4f} ms {runs['kernel']} | "
        f"dma candidates (the fused dma scan) {dma_ms:.4f} ms {runs['plain']}")
    # the dma batch and an ADC-only batch (the dma mode): the fused dma scan,
    # no table kernel, nothing the size of the tables
    dma_tables = lambda: idx.search_device(q, 10, nprobe, refine_k=kk, refine_store=store,
                                           ids_mode="dma", key_scan="tables")
    adc_reset()
    # both batches capture: each launches the fused dma scan twice, in its
    # eager warm-up and in the replay that serves it
    (dv, di), ops_seen = dispatched_ops(torch, capturing(idx, dma))
    capturing(idx, lambda: idx.search_device(q, 10, nprobe))()
    torch.cuda.synchronize()
    launched = adc_counts()
    check(launched["adc_fused_dma"] == 4 and launched["adc_tables"] == 0
          and launched["adc_topk"] == 0, f"the dma and ADC-only batches' launches: {launched}")
    big = [(name, shape, dt) for name, outs in ops_seen for shape, dt in outs
           if int(np.prod(shape)) >= table_elems]
    check(big == [], f"the dma path made table-sized tensors: {big}")
    sv, si = dma_tables()
    check(torch.equal(dv, sv) and torch.equal(di, si), "dma batch: differs from the staged route")
    (peak, pool), st_peak = capture_gb(torch, dev, idx, dma), peak_gb(torch, dev, dma_tables)
    check(max(peak, pool) < table_elems * 2 / 1e10,
          "the dma path allocated or reserved a tenth of the bf16 tables")
    d_ms, st_ms, runs = in_turns(torch, dma_tables, dma, iters=5)
    say(f"  whole search_device B={b} ids_mode=dma: fused dma scan {d_ms:.4f} ms {runs['kernel']}, "
        f"peak {peak:.4f} GB, pool {pool:.4f} GB | staged route (key_scan=tables) "
        f"{st_ms:.4f} ms {runs['plain']}, "
        f"peak {st_peak:.4f} GB; results bit for bit the staged route's; the ADC-only batch "
        f"(refine 0) on the fused dma scan too, no table kernel launched")
    out["whole search_device dma"] = dict(ms=d_ms, staged_ms=st_ms, peak_gb=peak, pool_gb=pool,
                                          staged_peak_gb=st_peak)
    # the gather batch: the fused key scan, with no code slab and no tables
    gather = lambda: idx.search_device(q, 10, nprobe, refine_k=kk, refine_store=store,
                                       ids_mode="gather")
    gather_slab = lambda: idx.search_device(q, 10, nprobe, refine_k=kk, refine_store=store,
                                            ids_mode="gather", key_scan="tables")
    (gv, gi), ops_seen = dispatched_ops(torch, capturing(idx, gather))
    big = [(name, shape, dt) for name, outs in ops_seen for shape, dt in outs
           if int(np.prod(shape)) >= table_elems]
    check(big == [], f"the gather path made table- or slab-sized tensors: {big}")
    sv, si = gather_slab()
    kv, ki = search()
    check(torch.equal(gv, sv) and torch.equal(gi, si) and torch.equal(gv, kv)
          and torch.equal(gi, ki), "gather batch: differs from the slab route or the key batch")
    (peak, pool), slab_peak = (capture_gb(torch, dev, idx, gather),
                               peak_gb(torch, dev, gather_slab))
    check(max(peak, pool) < table_elems * 2 / 1e10,
          "the gather path allocated or reserved a tenth of the bf16 tables")
    g_ms, slab_ms, runs = in_turns(torch, gather_slab, gather, iters=5)
    say(f"  whole search_device B={b} ids_mode=gather: fused key scan (lists read in place) "
        f"{g_ms:.4f} ms {runs['kernel']}, peak {peak:.4f} GB, pool {pool:.4f} GB | slab route "
        f"(key_scan=tables) "
        f"{slab_ms:.4f} ms {runs['plain']}, peak {slab_peak:.4f} GB; results bit for bit the "
        f"slab route's and the key batch's")
    out["whole search_device gather"] = dict(ms=g_ms, slab_ms=slab_ms, peak_gb=peak,
                                             pool_gb=pool, slab_peak_gb=slab_peak)

    st16 = store.vectors.to(torch.bfloat16)
    n2 = rerank.store_norms2(st16)
    for bb in (256, 8):
        qb, cb = q[:bb].contiguous(), cand[:bb].contiguous()
        wrapper = lambda: rerank.rerank_topk_cuda(qb, cb, st16, None, 10, norms2=n2)
        kern, plain, runs = in_turns(
            torch, lambda: rerank.rerank_topk_reference(qb, cb, st16, None, 10, norms2=n2),
            wrapper, iters=20)
        # the wrapper is one launch, so a graph of 100 calls times the kernel alone
        alone = [graph_ms(torch, wrapper) for _ in range(2)]
        say(f"  rerank bf16 1M x 768 B={bb} R={kk} k=10 l2: wrapper {kern:.4f} ms "
            f"{runs['kernel']} | kernel alone, 100 launches in a CUDA graph "
            f"{sum(alone) / 2:.5f} ms {alone} | plain {plain:.4f} ms {runs['plain']}")
        # bytes: each candidate's row, id and norm, the queries, the result
        n_cand = int((cb >= 0).sum())
        dp = st16.shape[1]
        nbytes = n_cand * (dp * 2 + 8) + bb * dp * 4 + bb * 10 * 8
        bnd, by = bound_ms(nbytes, 2.0 * n_cand * dp, "f32")
        say(f"    bound {bnd:.4f} ms ({by}: {nbytes / 1e6:.3f} MB) kernel / bound "
            f"{sum(alone) / 2 / bnd:.2f}, wrapper / bound {kern / bnd:.2f}")
        out[f"rerank_topk B={bb}"] = dict(ms=sum(alone) / 2, wrapper_ms=kern, plain_ms=plain,
                                          bound_ms=bnd, bound_by=by)
    del st16, n2
    torch.cuda.empty_cache()
    return out


PROBE_LISTS = 80      # lists of phase 10's random packed indexes


def probe_index(torch, dev, dtype, lcap, seed, nlist=PROBE_LISTS, dp=768):
    """A random packed IVF index on the card: unit-norm rows (padding slots
    too, so a missed mask shows), lists full, partly filled or filled below
    k; list 0 dead (every slot -1), list 1 three live slots, list 2 a hole
    every 7th slot."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randn((nlist, lcap, dp), generator=g, device=dev)
    rows /= rows.norm(dim=-1, keepdim=True)
    rng = np.random.default_rng(seed)
    slot_ids = np.full((nlist, lcap), -1, np.int32)
    perm = rng.permutation(nlist * lcap).astype(np.int32)
    for li in range(nlist):
        f = lcap if li % 4 == 3 else int(rng.integers(0, lcap + 1))
        slot_ids[li, :f] = perm[li * lcap:li * lcap + f]
    slot_ids[0] = -1
    slot_ids[1, 3:] = -1
    slot_ids[2, ::7] = -1
    scales = None
    if dtype == "f32":
        packed = rows
    elif dtype == "bf16":
        packed = rows.to(torch.bfloat16)
    else:
        scales = (rows.abs().amax(dim=-1) / 127.0).contiguous()
        packed = torch.round(rows / scales[..., None]).clamp(-127, 127).to(torch.int8)
    return packed.contiguous(), torch.from_numpy(slot_ids).to(dev), scales


def probe_table(rng, b, p, nlist=PROBE_LISTS):
    """[b, p] int64 distinct probes per query, as the coarse ranking gives;
    with p >= 2 every query probes the dead list 0 and the short list 1."""
    fixed = [0, 1] if p >= 2 else []
    return np.stack([np.r_[fixed, rng.choice(np.arange(2, nlist), p - len(fixed),
                                             replace=False)] for _ in range(b)]).astype(np.int64)


def probe_regret(torch, q, probes, packed, slot_ids, scales, ids, k):
    """Worst float64 score regret of ``ids`` against the exact top-k over
    each query's live probed slots, with the inputs as the kernel's path
    sees them (the bf16-rounded query where it rounds, dequantized int8)."""
    nlist, lcap, dp = packed.shape
    b, p = probes.shape
    q64 = q.double() if packed.dtype == torch.float32 else q.to(torch.bfloat16).double()
    worst = 0.0
    c = max(1, (512 << 20) // (p * lcap * dp * 8))
    for s in range(0, b, c):
        pr = probes[s:s + c].long()
        ok = (pr >= 0) & (pr < nlist)   # a probe outside [0, nlist) is an empty list
        pr = torch.where(ok, pr, 0)
        slabs = packed[pr].double()
        if scales is not None:
            slabs *= scales[pr].double()[..., None]
        s64 = torch.einsum("cd,cpld->cpl", q64[s:s + c], slabs).reshape(pr.shape[0], -1)
        sids = torch.where(ok[..., None], slot_ids[pr], -1).reshape(pr.shape[0], -1)
        s64 = torch.where(sids >= 0, s64, float("-inf"))
        ref = torch.topk(s64, k, dim=1).values
        got_ids = ids[s:s + c].long()
        match = sids[:, None, :].long() == got_ids[:, :, None]
        got = torch.where(match & (got_ids[:, :, None] >= 0), s64[:, None, :],
                          float("-inf")).amax(-1)
        got = torch.sort(got, dim=1, descending=True).values
        fin = torch.isfinite(ref)
        check(bool((fin == torch.isfinite(got)).all()), "probe: id count differs from oracle")
        if bool(fin.any()):
            worst = max(worst, float((ref[fin] - got[fin]).max()))
    return worst


PROBE_SHAPES = [(1, 1, 1), (1, 32, 128), (8, 7, 10), (8, 64, 50), (64, 32, 50), (64, 7, 128),
                (256, 64, 10), (256, 1, 128)]     # (B, P, k)


def probe_special_cases(rng, b=256, p=8):
    """(name, probes, k) of the cases a list-major grouping must get right:
    every query on one full list (list 3: B / 8 chunks of it at the default
    plan); each query probing one list twice (both copies score, as in the
    plain version); every query on the list with holes (list 2) and on
    out-of-range ids."""
    one = np.full((b, 1), 3, np.int64)
    twice = probe_table(rng, b, p)
    twice[:, 3] = twice[:, 2]   # columns 0 and 1 are the dead list and the short one
    holes = probe_table(rng, b, p)
    holes[:, 0], holes[:, 2], holes[:, 3] = 2, -1, PROBE_LISTS + 5
    return [("every query on list 3", one, 10), ("one list probed twice", twice, 50),
            ("holes and out-of-range probes", holes, 128)]


def check_probe(torch, tag, q, probes, packed, slot_ids, scales, k, kv, ki, pv, pi):
    """The kernel's (kv, ki) against the plain version's (pv, pi) and the
    float64 oracle, and no id twice in a row where no list is probed twice;
    returns (|kernel - plain| at most, regret, id agreement)."""
    fin = ki >= 0
    check(tuple(ki.shape) == (q.shape[0], k), f"{tag}: shape")
    check(bool((fin == (pi >= 0)).all()), f"{tag}: filler slots differ from plain")
    check(bool(torch.isfinite(kv[fin]).all()), f"{tag}: non-finite values")
    check(bool(torch.isneginf(kv[~fin]).all()), f"{tag}: filler is not (-inf, -1)")
    check(bool((kv[:, 1:] <= kv[:, :-1]).all()), f"{tag}: values not sorted")
    for row, pr in zip(ki.cpu().numpy(), probes.cpu().numpy()):
        live = row[row >= 0]
        if len(set(pr.tolist())) == len(pr):
            check(len(set(live.tolist())) == len(live), f"{tag}: duplicate ids")
    err = float((kv[fin] - pv[fin]).abs().max()) if bool(fin.any()) else 0.0
    check(bool(torch.allclose(kv[fin], pv[fin], atol=VALUE_ATOL, rtol=VALUE_RTOL)),
          f"{tag}: values differ from plain by {err}")
    agree = float((ki == pi).float().mean())
    check(agree >= ID_AGREE_MIN, f"{tag}: id agreement {agree} < {ID_AGREE_MIN}")
    r = probe_regret(torch, q, probes, packed, slot_ids, scales, ki, k)
    check(r <= REGRET_TOL, f"{tag}: regret {r} > {REGRET_TOL}")
    return err, r, agree


def check_grouping(torch, tag, probes, fills):
    """The CUDA grouping pass against ``group_pairs_reference``: the same
    items (in any order) and, within each list, the same pairs."""
    from nvdb_tpu_torch.kernels import ivf_scan

    order, items = ivf_scan.group_pairs_cuda(probes, fills, 32)
    want_order, want_items = ivf_scan.group_pairs_reference(probes, fills, 32)
    key = lambda t: t[torch.argsort(t[:, 0].long() * (1 << 32) + t[:, 1].long())].cpu()
    items, want_items = key(items), key(want_items)
    check(torch.equal(items, want_items), f"{tag}: grouping items differ from the plain pass")
    order, want_order = order.cpu(), want_order.cpu()
    for lst in torch.unique(items[:, 0]).tolist():
        mine = items[items[:, 0] == lst]
        s0, n = int(mine[0, 1]), int(mine[:, 2].sum())
        check(sorted(order[s0:s0 + n].tolist()) == want_order[s0:s0 + n].tolist(),
              f"{tag}: list {lst}'s pairs differ from the plain pass")
    return int(items.shape[0])


def phase_probe_vs_plain(torch, dev, dp=768, lcaps=(384, 992), shapes=PROBE_SHAPES):
    """Both layouts of the probe kernel (list-major, the default, and the
    query-major A/B) against the plain version and the float64 oracle at
    every shape and at the special cases; the grouping pass against its
    plain version."""
    from nvdb_tpu_torch.kernels import ivf_scan

    rng = np.random.default_rng(51)
    g = torch.Generator(device=dev).manual_seed(52)
    qall = torch.randn((max(b for b, _, _ in shapes), dp), generator=g, device=dev)
    qall /= qall.norm(dim=1, keepdim=True)
    max_err = {"list": 0.0, "query": 0.0}
    for dtype in ("f32", "bf16", "i8"):
        for lcap in lcaps:
            packed, slot_ids, scales = probe_index(torch, dev, dtype, lcap,
                                                   seed=lcap + len(dtype), dp=dp)
            fills = ivf_scan.list_fills(slot_ids)
            cases = [(f"B={b} P={p}", probe_table(rng, b, p), k) for b, p, k in shapes]
            cases += probe_special_cases(rng)
            for name, probes_np, k in cases:
                probes = torch.from_numpy(probes_np).to(dev)
                q = qall[:probes.shape[0]].contiguous()
                pv, pi = ivf_scan.ivf_probe_topk_reference(q, probes, packed, slot_ids,
                                                           scales, k)
                line = []
                for layout in ivf_scan.LAYOUTS:
                    kv, ki = ivf_scan.ivf_probe_topk_cuda(q, probes, packed, slot_ids, scales, k,
                                                          fills=fills, layout=layout)
                    torch.cuda.synchronize(dev)
                    tag = f"{dtype} Lcap={lcap} {name} k={k} {layout}-major"
                    err, r, agree = check_probe(torch, tag, q, probes, packed, slot_ids, scales,
                                                k, kv, ki, pv, pi)
                    max_err[layout] = max(max_err[layout], err)
                    line.append(f"{layout}: regret={r:.3e} max_abs_err={err:.3e} "
                                f"id_agree={agree:.4f}")
                n_items = check_grouping(torch, f"{dtype} Lcap={lcap} {name}",
                                         probes.to(torch.int32), fills)
                say(f"  {dtype} Lcap={lcap} {name} k={k} ({n_items} items): " + " | ".join(line))
            del packed, slot_ids, scales
    torch.cuda.empty_cache()
    return max_err


def phase_partition_main_path(torch, dev, work, n=1_000_000, d=768, nq=1000, flat_nlist=4096):
    from nvdb_tpu_torch.formats import gtbin, synth, vecbin
    from nvdb_tpu_torch.index.flat import FlatIndex
    from nvdb_tpu_torch.index.partition import auto_nlist
    from nvdb_tpu_torch.kernels import ivf_scan, rerank
    from nvdb_tpu_torch.store import VectorStore
    from nvdb_tpu_torch.tools import ivf_build, ivf_eval, pr_build, pr_eval, pr_search
    from nvdb_tpu_torch.utils import round_up

    k = 10
    paths = work_paths(work, "hard", ("base.vecbin", "q.vecbin", "q8.vecbin", "gt.gtbin",
                                      "pr.npz", "flat.npz"))
    t0 = time.perf_counter()
    base = synth.hard_chunked(n, d, intrinsic=48, seed=1)
    queries, qrows = synth.sample_queries(base, nq, seed=777)   # tools.make_query's seed
    vecbin.write_vecbin(paths["base.vecbin"], base)
    vecbin.write_vecbin(paths["q.vecbin"], queries)
    vecbin.write_vecbin(paths["q8.vecbin"], queries[:8])
    say(f"  hard corpus {n} x {d} (tools.synth --hard 48 --seed 1) + {nq} queries written "
        f"in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    store = VectorStore.from_vecbin(paths["base.vecbin"], device=dev)
    flat_reset()
    gt = FlatIndex(store).search(queries, k)[1]
    gtbin.write_gtbin(paths["gt.gtbin"], gt, dim=d, N=n)
    del store
    torch.cuda.empty_cache()
    say(f"  ground truth by the flat kernel (f32 store): {time.perf_counter() - t0:.1f} s")
    out = {"launches": {"flat_topk": flat_counts("ground truth", f32=True)}}

    pr_args = [paths["base.vecbin"], paths["q.vecbin"], "--gt", paths["gt.gtbin"],
               "--chained", "--nprobe", "16", "32", "--rerank-k", "50", "--k", str(k),
               "--batch-q", "64", "--wave", "4", "--device", dev.type]
    for backend in ("auto", "torch"):
        if backend == "auto":
            ivf_scan.reset_launches()
            rerank.LAUNCHES = 0
        t0 = time.perf_counter()
        res = run_tool(pr_eval.main, pr_args + ["--backend", backend],
                       keep=("partitions=", "RESULT"))
        if backend == "auto":
            out["launches"]["pr"] = {"ivf_probe_topk": probe_launches("pr_eval"),
                                     "rerank_topk": rerank.LAUNCHES}
        out[f"pr_{backend}"] = {r["nprobe"]: r for r in res}
        say(f"  pr_eval --backend {backend} ({time.perf_counter() - t0:.1f} s): " + "; ".join(
            f"nprobe {r['nprobe']} recall@10={r['recall']:.4f} QPS={r['qps']:.1f} "
            f"wave p99 {r.get('wave_p99_ms', float('nan')):.4f} ms" for r in res))
    say(f"  launches in the auto run: {out['launches']['pr']}")
    for name, count in out["launches"]["pr"].items():
        check(count > 0, f"the partition main path did not launch {name}")
    for np_ in (16, 32):
        ra, rt = out["pr_auto"][np_]["recall"], out["pr_torch"][np_]["recall"]
        check(abs(ra - rt) <= RECALL_GAP,
              f"nprobe {np_}: kernel recall {ra} vs plain {rt}: gap > {RECALL_GAP}")
    r32 = out["pr_auto"][32]["recall"]
    say(f"  recall@10 at nprobe 32: {r32:.4f} with the kernels, "
        f"{out['pr_torch'][32]['recall']:.4f} plain; the JAX package's build of the same "
        f"configuration: .9947 (BENCHMARKS.md:819)")
    check(r32 >= PR_RECALL_MIN, f"partition recall@10 {r32} < {PR_RECALL_MIN}")

    pidx = run_tool(pr_build.main, [paths["base.vecbin"], paths["pr.npz"],
                                    "--device", dev.type], keep=("built",))
    check(pidx.ivf.nlist == auto_nlist(n),
          f"pr_build: nlist {pidx.ivf.nlist}, not the sqrt-auto {auto_nlist(n)}")
    vals, ids = run_tool(pr_search.main, [paths["pr.npz"], paths["q8.vecbin"], "--k", str(k),
                                          "--nprobe", "32", "--base", paths["base.vecbin"],
                                          "--rerank-k", "50", "--device", dev.type],
                         keep=("query 0:",))
    check(np.isfinite(vals).all() and ((ids >= 0) & (ids < n)).all(), "pr_search: output")
    self_hits = int(np.sum(ids[:, 0] == qrows[:8]))
    say(f"  pr_search: {self_hits} of 8 queries (base rows) find their own row first")
    check(self_hits >= 6, f"pr_search: only {self_hits} of 8 queries find their own row")

    t0 = time.perf_counter()
    fidx = run_tool(ivf_build.main, [paths["base.vecbin"], paths["flat.npz"], "--kind",
                                     "ivfflat", "--nlist", str(flat_nlist), "--dtype",
                                     "bf16", "--device", dev.type], keep=("built",))
    out["flat_build_s"] = time.perf_counter() - t0
    lcap = round_up(int(np.ceil(n / flat_nlist * 1.5)), 32)
    check(fidx.nlist == flat_nlist and fidx.lcap == lcap, f"ivf_build: lcap {fidx.lcap}")
    ev_args = [paths["flat.npz"], paths["base.vecbin"], paths["q.vecbin"], "--gt",
               paths["gt.gtbin"], "--chained", "--nprobe", "64", "--refine-k", "0", "--k",
               str(k), "--batch-q", "256", "--device", dev.type]
    for backend in ("auto", "torch"):
        if backend == "auto":
            ivf_scan.reset_launches()
        res = run_tool(ivf_eval.main, ev_args + ["--ivf-backend", backend])[0]
        if backend == "auto":
            out["launches"]["ivfflat"] = {"ivf_probe_topk": probe_launches("ivf_eval ivfflat")}
        out[f"flat_{backend}"] = res
        say(f"  ivf_eval ivfflat --ivf-backend {backend}: recall@10={res['recall']:.4f} "
            f"QPS={res['qps']:.1f}")
    say(f"  launches in the auto run: {out['launches']['ivfflat']}")
    check(out["launches"]["ivfflat"]["ivf_probe_topk"] > 0,
          "the IVF-Flat main path did not launch ivf_probe_topk")
    ra, rt = out["flat_auto"]["recall"], out["flat_torch"]["recall"]
    check(abs(ra - rt) <= RECALL_GAP, f"ivfflat: kernel recall {ra} vs plain {rt}")
    return pidx, fidx, base, queries, out


PROBE_TIMES = (("partition", 64, 32, 50), ("ivfflat", 256, 64, 10),
               ("partition B=8", 8, 32, 50), ("ivfflat B=8", 8, 64, 10),
               ("partition B=1", 1, 32, 50), ("ivfflat B=1", 1, 64, 10))   # (case, B, P, k)


def graph_replay_check(torch, fn):
    """Capture ``fn`` (one call of a list-major kernel: the probe kernel or
    the fused key scan) in a CUDA graph, replay it, and hold the replay's
    result to an eager call's, bit for bit: a host sync or a count read back
    in the wrapper would fail the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gv, gi = fn()
    graph.replay()
    ev, ei = fn()
    torch.cuda.synchronize()
    check(torch.equal(gv, ev) and torch.equal(gi, ei),
          "a call replayed from a CUDA graph differs from an eager call")


def phase_probe_times(torch, dev, pidx, fidx, base, queries):
    """The list-major probe kernel against the query-major A/B and the plain
    version, in turns, on the partition and IVF-Flat indexes at their
    batches and at B = 8 and 1; each beside its bound by distinct bytes and
    the bytes as probed; the device time of each layout alone (a CUDA graph
    of 20 calls); one call captured in a CUDA graph and replayed; the
    partition and IVF-Flat batches by stage."""
    from nvdb_tpu_torch.index.ivf_flat import _coarse_probes
    from nvdb_tpu_torch.index.partition import PartitionRerankIndex
    from nvdb_tpu_torch.kernels import _build, dispatch, ivf_scan
    from nvdb_tpu_torch.store import VectorStore

    out = {}
    ivf_scan.reset_launches()
    for name, b, nprobe, k in PROBE_TIMES:
        ivf = pidx.ivf if name.startswith("partition") else fidx
        q = torch.zeros((b, ivf.centroids.shape[1]), device=dev)
        q[:, :ivf.d] = torch.from_numpy(queries[:b]).to(dev)
        probes = _coarse_probes(q, ivf.centroids, ivf.slot_ids, nprobe).to(torch.int32)
        fills = ivf.fills()
        args = (q, probes, ivf.packed, ivf.slot_ids, ivf.slot_scales, k)
        lst = lambda: ivf_scan.ivf_probe_topk_cuda(*args, fills=fills)
        qry = lambda: ivf_scan.ivf_probe_topk_cuda(*args, fills=fills, layout="query")
        kern, plain, runs = in_turns(
            torch, lambda: ivf_scan.ivf_probe_topk_reference(*args), lst, iters=10)
        lm, qm, ab = in_turns(torch, qry, lst, iters=10)
        g_list, g_query = graph_ms(torch, lst, launches=20), graph_ms(torch, qry, launches=20)
        dp = ivf.packed.shape[2]
        row_bytes = dp * ivf.packed.element_size() + (4 if ivf.slot_scales is not None else 0)
        pb = ivf_scan.probe_bytes(probes, fills, row_bytes, ivf.nlist, dp, k)
        # operations: a multiply-add for each dim of each live row of each pair
        ops = 2.0 * dp * pb["as_probed"] / row_bytes
        kind = "f32" if ivf.packed.dtype == torch.float32 else "bf16"
        bnd, by = bound_ms(pb["distinct"], ops, kind)
        per_list = pb["pairs"] / max(1, pb["lists"])
        say(f"  probe {name} B={b} P={nprobe} Lcap={ivf.lcap} k={k}: list-major {kern:.4f} ms "
            f"{runs['kernel']} | plain {plain:.4f} ms {runs['plain']}")
        say(f"    in turns: list-major {lm:.4f} ms {ab['kernel']} | query-major {qm:.4f} ms "
            f"{ab['plain']} | device time, 20 calls in a CUDA graph: list-major {g_list:.4f} "
            f"ms, query-major {g_query:.4f} ms")
        say(f"    bytes: distinct {pb['distinct'] / 1e9:.4f} GB ({pb['lists']} distinct lists, "
            f"{per_list:.2f} queries a probed list), as probed {pb['as_probed'] / 1e9:.4f} GB; "
            f"bound {bnd:.4f} ms ({by}) time / bound: list-major {lm / bnd:.2f} "
            f"(device {g_list / bnd:.2f}), query-major {qm / bnd:.2f} (device "
            f"{g_query / bnd:.2f})")
        out[name] = dict(ms=lm, plain_ms=plain, query_ms=qm, graph_ms=g_list,
                         query_graph_ms=g_query, bytes=pb["distinct"],
                         as_probed=pb["as_probed"], lists=pb["lists"], bound_ms=bnd,
                         bound_by=by)
    out["query launches"] = ivf_scan.LAUNCHES_BY_LAYOUT["query"]
    # the list-major plan's knobs: queries a chunk and CTAs a SM (device time)
    defaults = (ivf_scan._LIST_NQ_MAX, ivf_scan._LIST_PLAN_CTAS)
    for name, b, nprobe, k in PROBE_TIMES[:2]:
        ivf = pidx.ivf if name.startswith("partition") else fidx
        q = torch.zeros((b, ivf.centroids.shape[1]), device=dev)
        q[:, :ivf.d] = torch.from_numpy(queries[:b]).to(dev)
        probes = _coarse_probes(q, ivf.centroids, ivf.slot_ids, nprobe).to(torch.int32)
        fills = ivf.fills()
        sweep = []
        for nq_max, ctas in ((8, 3), (8, 2), (16, 3), (16, 2), (32, 2), (32, 3)):
            ivf_scan._LIST_NQ_MAX, ivf_scan._LIST_PLAN_CTAS = nq_max, ctas
            plan = ivf_scan._list_plan(ivf_scan._MODES[ivf.packed.dtype], ivf.packed.shape[2],
                                       k, dev.index or 0, nq_max, ctas,
                                       ivf_scan._LIST_MAX_STAGES)
            ms = graph_ms(torch, lambda: ivf_scan.ivf_probe_topk_cuda(
                q, probes, ivf.packed, ivf.slot_ids, ivf.slot_scales, k, fills=fills),
                launches=20)
            sweep.append(f"{nq_max}/{ctas} (plan {plan[0]} queries, {plan[1]} stages) {ms:.4f}")
        ivf_scan._LIST_NQ_MAX, ivf_scan._LIST_PLAN_CTAS = defaults
        say(f"  list-major {name}, device ms by queries a chunk at most / CTAs a SM: "
            + "; ".join(sweep) + f" (default {defaults[0]}/{defaults[1]})")
        # the call by passes: measurement builds that stop after pass 0 and
        # after pass 1 (their results are wrong by design), device ms
        split = {}
        port_lib = ivf_scan._lib
        try:
            for part, defines in PROBE_ABLATIONS:
                lib = ivf_scan.bind(_build.load("ivf_probe_topk", defines))
                ivf_scan._lib = lambda lib=lib: lib
                split[part] = graph_ms(torch, lambda: ivf_scan.ivf_probe_topk_cuda(
                    q, probes, ivf.packed, ivf.slot_ids, ivf.slot_scales, k, fills=fills),
                    launches=20)
        finally:
            ivf_scan._lib = port_lib
        whole = graph_ms(torch, lambda: ivf_scan.ivf_probe_topk_cuda(
            q, probes, ivf.packed, ivf.slot_ids, ivf.slot_scales, k, fills=fills),
            launches=20)
        say(f"  list-major {name}, device ms by pass: pass 0 (grouping) {split['pass 0']:.4f}, "
            f"pass 1 (scoring) {split['passes 0 + 1'] - split['pass 0']:.4f}, pass 2 (merge) "
            f"{whole - split['passes 0 + 1']:.4f}; the whole call {whole:.4f}")
        out[name]["by_pass"] = dict(split, whole=whole)
    ivf = pidx.ivf
    q = torch.zeros((64, ivf.centroids.shape[1]), device=dev)
    q[:, :ivf.d] = torch.from_numpy(queries[:64]).to(dev)
    probes = _coarse_probes(q, ivf.centroids, ivf.slot_ids, 32)
    fills = ivf.fills()
    graph_replay_check(torch, lambda: ivf_scan.ivf_probe_topk_cuda(
        q, probes, ivf.packed, ivf.slot_ids, None, 50, fills=fills))
    say("  one partition probe call (B=64, k 50) captured in a CUDA graph and replayed: "
        "equal to an eager call bit for bit")

    # the partition batch by stage (B = 64, nprobe 32, rerank 50 over f32)
    store = VectorStore.from_numpy(base, "f32", device=dev)
    pr = PartitionRerankIndex(ivf=ivf, refine_store=store)
    cid = ivf_scan.ivf_probe_topk_cuda(q, probes, ivf.packed, ivf.slot_ids, None, 50,
                                       fills=fills)[1]
    fq = torch.zeros((256, fidx.centroids.shape[1]), device=dev)
    fq[:, :fidx.d] = torch.from_numpy(queries[:256]).to(dev)
    fprobes = _coarse_probes(fq, fidx.centroids, fidx.slot_ids, 64)
    ffills = fidx.fills()
    stages = {
        "partition B=64 coarse probes (plain torch)": lambda: _coarse_probes(
            q, ivf.centroids, ivf.slot_ids, 32),
        "partition B=64 probe kernel (k 50)": lambda: ivf_scan.ivf_probe_topk_cuda(
            q, probes, ivf.packed, ivf.slot_ids, None, 50, fills=fills),
        "partition B=64 rerank kernel (R 50, f32)": lambda: dispatch.exact_refine(
            q, cid, store.vectors, None, 10, metric="dot"),
        "partition B=64 whole search_device": lambda: pr.search_device(q, 10, 32, rerank_k=50),
        "ivfflat B=256 coarse probes (plain torch)": lambda: _coarse_probes(
            fq, fidx.centroids, fidx.slot_ids, 64),
        "ivfflat B=256 probe kernel (k 10)": lambda: ivf_scan.ivf_probe_topk_cuda(
            fq, fprobes, fidx.packed, fidx.slot_ids, None, 10, fills=ffills),
        "ivfflat B=256 whole search_device": lambda: fidx.search_device(fq, 10, 64),
    }
    for stage, fn in stages.items():
        ms = cuda_ms(torch, fn, iters=20)
        say(f"  stage {stage}: {ms:.4f} ms")
        out[f"stage {stage}"] = ms
    del store, pr
    torch.cuda.empty_cache()
    return out


def wall(label, fn, *args, **kw):
    """Run ``fn``, print its wall time under ``label``; returns (result, s)."""
    t0 = time.perf_counter()
    res = fn(*args, **kw)
    dt = time.perf_counter() - t0
    say(f"  {label}: {dt:.1f} s")
    return res, dt


def add_launches(total, counts):
    for name, c in counts.items():
        total[name] = total.get(name, 0) + c
    return total


def ids_near_equal(tag, base_path, queries, got, want):
    """``got`` equals ``want`` except at float64 near-ties: in each row
    where they differ, the float64 scores of the two sorted id lists agree
    to ``REGRET_TOL``. Returns the number of rows that differ."""
    from nvdb_tpu_torch.formats import vecbin

    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    check(got.shape == want.shape, f"{tag}: shape {got.shape} != {want.shape}")
    rows = np.nonzero((got != want).any(axis=1))[0]
    f = vecbin.VecbinFile(base_path)
    worst = 0.0
    for r in rows:
        q = queries[r].astype(np.float64)
        sg, sw = (np.sort(np.asarray(f.vectors[np.sort(ids)], np.float64) @ q)
                  for ids in (got[r], want[r]))
        worst = max(worst, float(np.max(np.abs(sg - sw))))
    say(f"  {tag}: {len(rows)} of {len(got)} rows differ, largest float64 score gap "
        f"{worst:.3e}")
    check(worst <= REGRET_TOL, f"{tag}: ids differ beyond near-ties ({worst})")
    return len(rows)


def build_side_ivfpq(torch, dev, work, p8, spilled8):
    """14a: the IVF-PQ repacks of phase 8's index at the published settings
    and ivf_eval on them, with the kernels and with their plain versions."""
    from nvdb_tpu_torch.formats import vecbin
    from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
    from nvdb_tpu_torch.kernels import kmeans, ops
    from nvdb_tpu_torch.tools import ivf_build, ivf_eval

    paths = work_paths(work, "b14", ("rep1.npz", "rep2.npz"))
    out = {"launches": {}}
    repack = [p8["base.vecbin"], None, "--kind", "ivfpq", "--repack-from", p8["index.npz"],
              "--device", dev.type]
    rep1, out["repack R=1 s"] = wall(
        "ivf_build --repack-from (ivfpq, pad 4.0, S 8)", run_tool, ivf_build.main,
        [repack[0], paths["rep1.npz"], *repack[2:]], keep=("built",))
    rep2, out["repack R=2 s"] = wall(
        "ivf_build --repack-from --replicas 2 --pad-factor 2.0", run_tool, ivf_build.main,
        [repack[0], paths["rep2.npz"], *repack[2:], "--replicas", "2", "--pad-factor", "2.0"],
        keep=("built",))
    say(f"  spilled: phase 8 {spilled8}, repacked {rep1.n_spilled} (lcap {rep1.lcap}), "
        f"replicated {rep2.n_spilled} (lcap {rep2.lcap})")
    check(rep1.n_spilled < spilled8, f"repack spilled {rep1.n_spilled} >= phase 8's {spilled8}")
    # where the spill comes from: the rows over each list's capacity, by the
    # first-choice list sizes of the (shared) quantizer
    ops.no_tf32()
    rows = torch.from_numpy(vecbin.VecbinFile(p8["base.vecbin"]).rows_f32()).to(dev)
    rows = torch.nn.functional.pad(rows, (0, rep1.centroids.shape[1] - rows.shape[1]))
    if rep1.rotation is not None:
        rows = rows @ rep1.rotation
    sizes = torch.sort(torch.bincount(kmeans.assign(rows, rep1.centroids).long(),
                                      minlength=rep1.centroids.shape[0]), descending=True)[0]
    del rows
    over = {c: int(torch.clamp(sizes - c, min=0).sum()) for c in (640, 1024)}
    say(f"  first-choice list sizes: largest {sizes[:4].tolist()}, the 16 largest hold "
        f"{int(sizes[:16].sum())} rows, {int((sizes == 0).sum())} empty; rows over "
        f"capacity: {over[640]} at lcap 640, {over[1024]} at lcap 1024")
    check(rep2.replicas == 2 and rep2.ids_mode() == "dma",
          f"replicated index: replicas {rep2.replicas}, mode {rep2.ids_mode()}")
    queries = vecbin.VecbinFile(p8["q.vecbin"]).rows_f32()
    # the dma route on the repacked indexes: the fused dma scan and no table
    # kernel, for the replicated index's ADC candidates, an ADC-only search of
    # the repacked one and the refine candidates of a copy of it with holes
    holed_ids = rep1.slot_ids.clone()
    holed_ids[:, 1::7] = -1
    holed = IVFPQIndex(rotation=rep1.rotation, centroids=rep1.centroids,
                       codebooks=rep1.codebooks, codes=rep1.codes, slot_ids=holed_ids, n=rep1.n,
                       d=rep1.d, m=rep1.m)
    check(holed.ids_mode() == "dma", f"holed index: mode {holed.ids_mode()}")
    leads = rep2.tile_leads()
    repeated = int((leads >= 0).sum())
    qpad = torch.zeros((queries.shape[0], rep1.centroids.shape[1]), device=dev)
    qpad[:, :queries.shape[1]] = torch.from_numpy(queries).to(dev)
    for name, run in (
            ("replicated", lambda: rep2.search(queries, 100, 64)[1]),
            ("repacked, ADC-only", lambda: rep1.search(queries, 100, 64)[1]),
            ("repacked with holes, refine candidates", lambda: torch.cat(
                [holed.search_device(x, 100, 64, for_refine=True)[1] for x in qpad.split(256)]
            ).cpu().numpy())):
        adc_reset()
        cand = run()
        launched = adc_counts()
        add_launches(out["launches"], {"adc_fused_dma": launched["adc_fused_dma"]})
        dups = sum(len(set(row[row >= 0].tolist())) != int((row >= 0).sum()) for row in cand)
        say(f"  {name} ADC candidates (k 100, nprobe 64, {len(cand)} queries): launches "
            f"{launched}, {dups} queries with a repeated id")
        check(launched["adc_fused_dma"] > 0 and launched["adc_tables"] == 0
              and launched["adc_topk"] == 0, f"{name} search: the dma route's launches {launched}")
        check(dups == 0, f"{name} search: {dups} queries repeat an id")
    say(f"  replicated index: {repeated} slots hold an id their 768-lane tile holds again "
        f"(adc_scan.tile_leads)")
    del rep1, rep2, holed, qpad
    torch.cuda.empty_cache()

    ev = [p8["base.vecbin"], p8["q.vecbin"], "--gt", p8["gt.gtbin"], "--chained", "--nprobe",
          "16", "32", "64", "--refine-k", "50", "--k", "10", "--batch-q", "256",
          "--device", dev.type]
    runs = [("phase 8 index", p8["index.npz"], [], ("adc_fused_key", "rerank_topk")),
            ("repacked", paths["rep1.npz"], [], ("adc_fused_key", "rerank_topk")),
            ("repacked", paths["rep1.npz"], ["--ivf-backend", "torch"], ()),
            ("replicated", paths["rep2.npz"], [], ("adc_fused_dma", "rerank_topk")),
            ("replicated", paths["rep2.npz"], ["--ivf-backend", "torch"], ())]
    for name, index, extra, counted in runs:
        res, launches = ivf_eval_counted(torch, ivf_eval.main, [index, *ev, *extra],
                                         first=False)
        for c in counted:
            check(launches[c] > 0, f"ivf_eval {name}: did not launch {c}")
        check(launches["adc_tables"] == 0, f"ivf_eval {name}: launched the table kernel")
        add_launches(out["launches"], {c: launches[c] for c in counted})
        out[(name, "torch" if extra else "cuda")] = {r["nprobe"]: r for r in res}
    for name in ("repacked", "replicated"):
        for np_ in (16, 32, 64):
            rk, rt = (out[(name, b)][np_]["recall"] for b in ("cuda", "torch"))
            check(abs(rk - rt) <= RECALL_GAP,
                  f"{name} nprobe {np_}: kernel recall {rk} vs plain {rt}")
    for np_ in (16, 32, 64):
        say(f"  nprobe {np_} refine 50, recall@10 / QPS: " + " | ".join(
            f"{name}{' plain' if b == 'torch' else ''} {out[(name, b)][np_]['recall']:.4f} / "
            f"{out[(name, b)][np_]['qps']:.1f}"
            for name, _, extra, _ in runs for b in ["torch" if extra else "cuda"]))
    remove_files(paths)
    return out


def build_side_ivfflat(torch, dev, work, part, nlist=4096):
    """14b: IVF-Flat on phase 11's hard corpus, with the corpus refinement
    and repacked from phase 11's index, through ivf_eval."""
    from nvdb_tpu_torch.formats import vecbin
    from nvdb_tpu_torch.kernels import ivf_scan, kmeans
    from nvdb_tpu_torch.tools import ivf_build, ivf_eval

    hard = work_paths(work, "hard", ("base.vecbin", "q.vecbin", "gt.gtbin", "flat.npz"))
    paths = work_paths(work, "b14", ("refined.npz", "flat_rep.npz"))
    out = {"launches": {"ivf_probe_topk": 0}}
    ref, out["refine build s"] = wall(
        "ivf_build --kind ivfflat --nlist 4096 --dtype bf16 --corpus-refine 2", run_tool,
        ivf_build.main, [hard["base.vecbin"], paths["refined.npz"], "--kind", "ivfflat",
                         "--nlist", str(nlist), "--dtype", "bf16", "--corpus-refine", "2",
                         "--device", dev.type], keep=("built",))
    say(f"  build seconds: {out['refine build s']:.1f} with 2 corpus passes against "
        f"{part['flat_build_s']:.1f} unrefined (phase 11)")
    plain_cents = torch.from_numpy(np.load(hard["flat.npz"])["centroids"]).to(dev)
    rows = torch.from_numpy(vecbin.VecbinFile(hard["base.vecbin"]).rows_f32()).to(dev)
    rows = torch.nn.functional.pad(rows, (0, plain_cents.shape[1] - rows.shape[1]))
    dead = [nlist - int(torch.unique(kmeans.assign(rows, c)).numel())
            for c in (plain_cents, ref.centroids)]
    del rows, plain_cents, ref
    torch.cuda.empty_cache()
    out["dead"] = dead
    say(f"  corpus-dead lists: {dead[0]} unrefined (phase 11), {dead[1]} refined")
    check(dead[1] <= dead[0], f"the refined quantizer has more dead lists: {dead}")
    rep, out["repack s"] = wall(
        "ivf_build --kind ivfflat --repack-from (pad 2.0, S 8)", run_tool, ivf_build.main,
        [hard["base.vecbin"], paths["flat_rep.npz"], "--kind", "ivfflat", "--repack-from",
         hard["flat.npz"], "--pad-factor", "2.0", "--spill-candidates", "8",
         "--device", dev.type], keep=("built",))
    say(f"  spilled: repacked {rep.n_spilled} (lcap {rep.lcap})")
    del rep
    torch.cuda.empty_cache()
    ev = [hard["base.vecbin"], hard["q.vecbin"], "--gt", hard["gt.gtbin"], "--chained",
          "--nprobe", "64", "--refine-k", "0", "--k", "10", "--batch-q", "256",
          "--device", dev.type]
    for name, index, backend in (("refined", paths["refined.npz"], "auto"),
                                 ("repacked", paths["flat_rep.npz"], "auto"),
                                 ("repacked", paths["flat_rep.npz"], "torch")):
        ivf_scan.reset_launches()
        res = run_tool(ivf_eval.main, [index, *ev, "--ivf-backend", backend])[0]
        if backend == "auto":
            n = probe_launches(f"ivf_eval {name}")
            check(n > 0, f"ivf_eval {name}: did not launch ivf_probe_topk")
            out["launches"]["ivf_probe_topk"] += n
        out[(name, backend)] = res
    rk, rt = out[("repacked", "auto")]["recall"], out[("repacked", "torch")]["recall"]
    check(abs(rk - rt) <= RECALL_GAP, f"repacked ivfflat: kernel recall {rk} vs plain {rt}")
    say("  nprobe 64, recall@10 / QPS: " + " | ".join(
        f"{name} {r['recall']:.4f} / {r['qps']:.1f}" for name, r in (
            ("phase 11 index", part["flat_auto"]), ("refined", out[("refined", "auto")]),
            ("repacked", out[("repacked", "auto")]),
            ("repacked plain", out[("repacked", "torch")]))))
    remove_files(paths)
    return out


def simt_truth(torch, dev, base_path, queries, k):
    """The top-k of every query over a vecbin's f32 store by the SIMT kernel
    (``f32_kernel="simt"``), in one launch: (ids, vals) as numpy arrays."""
    from nvdb_tpu_torch.kernels import flat_scan
    from nvdb_tpu_torch.store import VectorStore

    store = VectorStore.from_vecbin(base_path, device=dev)
    q = torch.from_numpy(store.pad_queries(queries)).to(dev)
    vals, ids = flat_scan.flat_topk_cuda(q, store.vectors, None, store.n, k, f32_kernel="simt")
    out = ids.cpu().numpy(), vals.cpu().numpy()
    del store, q
    torch.cuda.empty_cache()
    return out


def tools_on_card(torch, dev, work, p8):
    """14c: gt_build on its three paths, slice, search, ab_compare,
    convert_bf16, dump and sanity on phase 8's files (made by tools.synth
    and tools.make_query)."""
    from nvdb_tpu_torch.formats import gtbin, vecbin
    from nvdb_tpu_torch.kernels import flat_scan
    from nvdb_tpu_torch.tools import (ab_compare, convert_bf16, dump, gt_build, make_query,
                                      sanity, search, slice as slice_tool)

    paths = work_paths(work, "b14", ("gt.gtbin", "gt_chunk.gtbin", "s.vecbin", "s_q.vecbin",
                                     "s_gt.gtbin", "s_gt_host.gtbin", "s_bf16.vecbin"))
    base, qpath, dv = p8["base.vecbin"], p8["q.vecbin"], ["--device", dev.type]
    queries = vecbin.VecbinFile(qpath).rows_f32()
    out = {}
    flat_reset()
    ids, out["gt_build s"] = wall("gt_build (device, the flat kernel)", run_tool,
                                  gt_build.main, [base, qpath, paths["gt.gtbin"], *dv],
                                  keep=("wrote",))
    ids_near_equal("gt_build against phase 8's ground truth", base, queries, ids,
                   gtbin.read_gtbin(p8["gt.gtbin"])[1])
    chunked, out["gt_build --row-chunk s"] = wall(
        "gt_build --row-chunk 262144", run_tool, gt_build.main,
        [base, qpath, paths["gt_chunk.gtbin"], "--row-chunk", "262144", *dv], keep=("wrote",))
    ids_near_equal("gt_build --row-chunk against the device path", base, queries, chunked, ids)
    wall("slice --n 65536", run_tool, slice_tool.main,
         [base, paths["s.vecbin"], "--n", "65536"], keep=("wrote",))
    # 256 queries of the slice: the host oracle scans at a few GFLOP/s
    sq = paths["s_q.vecbin"]
    wall("make_query --q 256 on the slice", run_tool, make_query.main,
         [paths["s.vecbin"], sq, "--q", "256", "--seed", "43", "--perturb", "0.05"],
         keep=("wrote",))
    s_queries = vecbin.VecbinFile(sq).rows_f32()
    s_ids, out["slice gt_build s"] = wall("gt_build on the slice", run_tool, gt_build.main,
                                          [paths["s.vecbin"], sq, paths["s_gt.gtbin"], *dv],
                                          keep=("wrote",))
    host, out["slice gt_build --host s"] = wall(
        "gt_build --host on the slice (native host scan)", run_tool, gt_build.main,
        [paths["s.vecbin"], sq, paths["s_gt_host.gtbin"], "--host"], keep=("wrote",))
    ids_near_equal("gt_build --host against the device path on the slice", paths["s.vecbin"],
                   s_queries, host, s_ids)
    (_, found), _ = wall("search --q 4", run_tool, search.main,
                         [paths["s.vecbin"], sq, "--q", "4", *dv], keep=("query 0",))
    ids_near_equal("search --q 4 against gt_build", paths["s.vecbin"], s_queries, found,
                   s_ids[:4])
    out["ab"], _ = wall("ab_compare --a cuda --b torch --pairs 30", run_tool, ab_compare.main,
                        [paths["s.vecbin"], sq, "--a", "cuda", "--b", "torch", "--pairs",
                         "30", *dv], keep=("mean(A-B)", "verdict", "RESULT"))
    counts = flat_counts("gt_build, search and ab_compare", f32=True)
    # the A/B: the same ground truth by the SIMT kernel of f32 FMA
    (simt_ids, _), _ = wall("the SIMT kernel's ground truth of the same files", simt_truth,
                            torch, dev, base, queries, ids.shape[1])
    ids_near_equal("gt_build (tensor cores) against the SIMT kernel's ground truth", base,
                   queries, ids, simt_ids)
    counts["f32_simt"] = flat_scan.LAUNCHES_BY_KERNEL["f32_simt"]
    out["launches"] = {f"flat_topk.{key}": c for key, c in counts.items()}
    wall("convert_bf16 -> dump -> sanity", lambda: (
        run_tool(convert_bf16.main, [paths["s.vecbin"], paths["s_bf16.vecbin"]],
                 keep=("wrote",)),
        run_tool(dump.main, [paths["s_bf16.vecbin"], "--rows", "1"], keep=("count=", "row0")),
        run_tool(sanity.main, [paths["s_bf16.vecbin"]], keep=("OK",))))
    remove_files(paths)
    return out


def phase_build_side(torch, dev, work, p8, spilled8, part):
    out = {"launches": {}}
    for sub, fn, args in (("a", build_side_ivfpq, (p8, spilled8)),
                          ("b", build_side_ivfflat, (part,)),
                          ("c", tools_on_card, (p8,))):
        say(f"  [14{sub}]")
        out[sub], _ = wall(f"14{sub} in all", fn, torch, dev, work, *args)
        add_launches(out["launches"], out[sub]["launches"])
    say(f"  launches in phase 14: {out['launches']}")
    return out


def phase_hbm_and_sanity(torch, dev):
    from nvdb_tpu_torch.kernels import add1, hbm_stream
    from nvdb_tpu_torch.tools import gpu_sanity, hbm_probe

    out = {"stream_err": 0.0}
    # the stream kernels on odd sizes first: the maximum is exact
    g = torch.Generator(device=dev).manual_seed(61)
    for rows in (8, 70001):
        x = torch.randn((rows, 128), generator=g, device=dev).to(torch.bfloat16)
        want = hbm_stream.stream_max_reference(x)
        for fn in (hbm_stream.stream_max_cuda, hbm_stream.ring_max_cuda):
            got = fn(x)
            torch.cuda.synchronize(dev)
            err = float((got - want).abs())
            say(f"  {fn.__name__} rows={rows}: max {float(got)} vs torch.amax {float(want)}")
            check(err == 0.0, f"{fn.__name__} rows={rows}: {float(got)} != "
                              f"torch.amax {float(want)}")
            out["stream_err"] = max(out["stream_err"], err)
    hbm_stream.LAUNCHES = {"stream": 0, "ring": 0}
    res = {r["probe"]: r for r in run_tool(hbm_probe.main, ["--iters", "20"])}
    out["stream_launches"] = dict(hbm_stream.LAUNCHES)
    say(f"  launches in hbm_probe: {out['stream_launches']}")
    for name, count in out["stream_launches"].items():
        check(count > 0, f"hbm_probe did not launch the {name} kernel")
    out["hbm"] = res
    out["ceiling_gbps"] = max(r["gbps"] for r in res.values())

    add1.LAUNCHES = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            gpu_sanity.main([])
            code = 0
        except SystemExit as e:
            code = e.code
    for line in buf.getvalue().splitlines():
        say(f"  {line}")
    out["add1_launches"] = add1.LAUNCHES
    check(code == 0, f"gpu_sanity exited {code}")
    check(add1.LAUNCHES > 0, "gpu_sanity did not launch the add1 kernel")
    x = torch.linspace(-3.0, 3.0, 8 * 128, device=dev).reshape(8, 128)
    out["add1_err"] = float((add1.add1_cuda(x) - add1.add1_reference(x)).abs().max())
    check(out["add1_err"] == 0.0, f"add1 differs from x + 1 by {out['add1_err']}")
    # 100 launches captured in one CUDA graph: the device's time per launch,
    # not the Python wrapper's (ctypes call, torch.empty, checks)
    runs = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = add1.add1_reference if name == "plain" else add1.add1_cuda
        runs[name].append(graph_ms(torch, lambda: fn(x)))
    kern, plain = sum(runs["kernel"]) / 2, sum(runs["plain"]) / 2
    bnd, by = bound_ms(2 * x.numel() * 4, x.numel(), "f32")
    say(f"  add1 [8, 128] ({add1.launch_blocks(x.numel())} CTA of {add1.THREADS} threads, "
        f"16-byte loads), 100 launches in a CUDA graph: kernel {kern:.5f} ms {runs['kernel']} "
        f"| x + 1 {plain:.5f} ms {runs['plain']} | bound {bnd:.2e} ms ({by})")
    out["add1"] = dict(ms=kern, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=plain)
    stream = out["hbm"]["stream"]
    bnd, by = bound_ms(stream["ms"] * stream["gbps"] * 1e6, 0.0, "f32")
    out["hbm_stream"] = dict(ms=stream["ms"], plain_ms=out["hbm"]["torch_amax"]["ms"],
                             bound_ms=bnd, bound_by=by,
                             library_ms=out["hbm"]["torch_amax"]["ms"])
    say(f"  stream kernel {stream['ms']:.4f} ms | torch.amax {out['hbm_stream']['plain_ms']:.4f} "
        f"ms | bound {bnd:.4f} ms ({by}) time / bound {stream['ms'] / bnd:.2f}")
    return out


DIST_KERNELS = ("adc_fused_dma", "adc_fused_key", "rerank_topk", "ivf_probe_topk")


def dist_counted(total, fn, *args, **kw):
    """Run ``fn`` with every kernel's launch count set to 0 just before it;
    add the counts read just after to ``total`` (flat instances as
    ``flat_topk.<instance>``). Returns what ``fn`` returns."""
    import torch

    from nvdb_tpu_torch.kernels import flat_scan, ivf_scan, rerank

    flat_reset()
    adc_reset()
    rerank.LAUNCHES = 0
    ivf_scan.reset_launches()
    res = fn(*args, **kw)
    torch.cuda.synchronize()
    add_launches(total, {f"flat_topk.{i}": c for i, c in flat_scan.LAUNCHES_BY_KERNEL.items()})
    add_launches(total, dict(adc_counts(), rerank_topk=rerank.LAUNCHES,
                             ivf_probe_topk=probe_launches("dist")))
    return res


def dist_flat(torch, dev, out, n=1_000_000):
    """15a: phase 4's 1M x 768 store (bf16, then int8 of the same rows) as
    four views of cuda:0, and a bf16 store padded for three shards (the
    last one short of valid rows): values bit-equal to FlatIndex's, ids
    equal wherever the values are not tied; the two in turns."""
    from nvdb_tpu_torch.bench import synth_queries, synth_store
    from nvdb_tpu_torch.dist import mesh as meshmod
    from nvdb_tpu_torch.dist.sharded import ShardedFlatIndex, merge_partials
    from nvdb_tpu_torch.index.flat import FlatIndex
    from nvdb_tpu_torch.kernels import dispatch
    from nvdb_tpu_torch.store import ShardedVectorStore

    d, b, k = 768, 512, 10
    for dtype, S in (("bf16", 4), ("i8", 4), ("bf16", 3)):
        store = synth_store(n, d, dtype, dev, seed=0, row_block=4096 * S)
        q = synth_queries(b, store, seed=1)
        mesh = meshmod.row_mesh(S, devices=[dev] * S)
        sh = ShardedVectorStore.from_store(store, mesh)
        rps = sh.rows_per_shard
        check(all(v.data_ptr() == store.vectors[s * rps:].data_ptr()
                  for s, v in enumerate(sh.vectors)), "a shard of cuda:0 is not a view")
        single, sharded = FlatIndex(store), ShardedFlatIndex(sh)
        fv, fi = single.search_device(q, k)
        sv, si = dist_counted(out["launches"], sharded.search_device, q, k)
        untied = torch.ones_like(sv, dtype=torch.bool)
        untied[:, 1:] &= sv[:, 1:] != sv[:, :-1]
        untied[:, :-1] &= sv[:, :-1] != sv[:, 1:]
        tag = f"{dtype} S={S}"
        check(torch.equal(sv, fv), f"sharded flat {tag}: values differ from FlatIndex's")
        check(bool((si[untied] == fi[untied]).all()), f"sharded flat {tag}: ids differ")
        kern, plain, runs = in_turns(torch, lambda: single.search_device(q, k),
                                     lambda: sharded.search_device(q, k), 10)
        say(f"  flat {tag} B={b} k={k} (valid rows by shard {[x.n for x in sh.shards]}): "
            f"values bit-equal to FlatIndex, ids equal at {int(untied.sum())} untied "
            f"positions; sharded {kern:.4f} ms {runs['kernel']} | single {plain:.4f} ms "
            f"{runs['plain']} | ratio {kern / plain:.3f}")
        out["ms"][f"flat {tag}"] = (kern, plain)
        if S == 4:
            # by parts: one shard's scan alone, the merge of the partials alone
            scales = sh.scales or [None] * S
            parts = [dispatch.flat_topk(q, v, sc, x.n, k)
                     for v, sc, x in zip(sh.vectors, scales, sh.shards)]
            one = cuda_ms(torch, lambda: dispatch.flat_topk(q, sh.vectors[0], scales[0],
                                                            sh.shards[0].n, k), 10)
            merge = cuda_ms(torch, lambda: merge_partials([p[0] for p in parts],
                                                          [p[1] for p in parts], k, mesh), 10)
            say(f"    by parts: one shard's scan {one:.4f} ms, the merge of {S} x {b} x {k} "
                f"partials {merge:.4f} ms")
            out["ms"][f"flat {tag} parts"] = (one, merge)
        del store, sh, single, sharded, q
        torch.cuda.empty_cache()


def dist_lloyd(torch, dev, base_path, out):
    """15b: one sharded Lloyd step over phase 8's 1M x 768 f32 corpus on
    four shards of cuda:0 (padding rows present) against ``_lloyd_step``
    on the valid rows alone."""
    from nvdb_tpu_torch.dist import mesh as meshmod
    from nvdb_tpu_torch.dist.sharded import sharded_lloyd_step
    from nvdb_tpu_torch.kernels import kmeans
    from nvdb_tpu_torch.store import ShardedVectorStore, VectorStore

    mesh = meshmod.row_mesh(4, devices=[dev] * 4)
    store = VectorStore.from_vecbin(base_path, n_shards=4, device=dev)
    sh = ShardedVectorStore.from_store(store, mesh)
    cents = store.vectors[:1024].clone()
    new, obj = sharded_lloyd_step(mesh, sh.vectors, cents, sh.n)
    sums, counts, obj1 = kmeans._lloyd_step(store.vectors[:store.n][None], cents[None])
    want = torch.where(counts[0][:, None] > 0.5, sums[0] / torch.clamp(counts[0], min=1.0)[:, None],
                       cents)
    err = float((new - want).abs().max())
    rel = abs(float(obj) - float(obj1[0]) / store.n) / (float(obj1[0]) / store.n)
    say(f"  Lloyd step, {sh.n} x {sh.d} f32, K {cents.shape[0]}, 4 shards "
        f"({sh.n_padded - sh.n} padding rows): "
        f"|centroids - single| {err:.3e}, objective {float(obj):.6f} (rel err {rel:.2e})")
    check(err <= 1e-4, f"sharded Lloyd step: centroids differ by {err}")
    check(rel <= 1e-4, f"sharded Lloyd step: objective differs by {rel} relative")
    del sh, store
    torch.cuda.empty_cache()


def dist_ivfpq(torch, dev, work, p8, ivf8, out):
    """15c: ``ivf_eval --force-sharded --shards 1`` on phase 8's index (the
    single-device recall exactly), then ``ShardedIVFPQIndex`` over four
    shards of cuda:0 with the f32 and the residual-int8 refine store
    row-sharded: the kernels against their plain versions, key against dma
    candidates on the same shards, and the batch beside the single-device one."""
    from nvdb_tpu_torch.dist import mesh as meshmod
    from nvdb_tpu_torch.dist.sharded_ivf import ShardedIVFPQIndex, sharded_refine
    from nvdb_tpu_torch.eval.recall import recall_at_k
    from nvdb_tpu_torch.formats import gtbin, vecbin
    from nvdb_tpu_torch.index.ivf_pq import IVFPQIndex
    from nvdb_tpu_torch.store import ShardedVectorStore, VectorStore
    from nvdb_tpu_torch.tools import ivf_eval
    from nvdb_tpu_torch.tools.quantize_i8 import residual_params

    k, nprobe, refine_k, b = 10, 64, 100, 256
    argv = [p8["index.npz"], p8["base.vecbin"], p8["q.vecbin"], "--gt", p8["gt.gtbin"],
            "--chained", "--nprobe", str(nprobe), "--refine-k", str(refine_k), "--k", str(k),
            "--batch-q", str(b), "--device", dev.type, "--force-sharded", "--shards", "1"]
    res = dist_counted(out["launches"], run_tool, ivf_eval.main, argv, keep=("kind=", "RESULT"))[0]
    say(f"  ivf_eval --force-sharded --shards 1: recall@10={res['recall']:.4f} (single-device "
        f"{ivf8['auto']['recall']:.4f}) QPS={res['qps']:.1f}")
    check(res["kind"] == "ivfpq-sharded1", f"ivf_eval kind {res['kind']}")
    check(res["recall"] == ivf8["auto"]["recall"],
          f"force-sharded S=1 recall {res['recall']} != single-device {ivf8['auto']['recall']}")

    idx = IVFPQIndex.load(p8["index.npz"], device=dev)
    mesh = meshmod.row_mesh(4, devices=[dev] * 4)
    sh = ShardedIVFPQIndex.from_index(idx, mesh)
    check(sh.ids_mode() == "key", f"sharded ids_mode {sh.ids_mode()}")
    queries = vecbin.VecbinFile(p8["q.vecbin"]).rows_f32()
    gt = np.asarray(gtbin.read_gtbin(p8["gt.gtbin"])[1])
    dp = idx.centroids.shape[1]
    qpad = torch.zeros((queries.shape[0], dp), device=dev)
    qpad[:, :queries.shape[1]] = torch.from_numpy(queries).to(dev)
    blocks = list(qpad.split(b))
    f32 = ShardedVectorStore.from_vecbin(p8["base.vecbin"], mesh)
    r_cents, _, r_list_of = residual_params(p8["index.npz"])
    res_store = ShardedVectorStore.from_vecbin(p8["res.vecbin"], mesh).attach_residual(
        r_cents, r_list_of)

    def run(store, backend="auto", counted=True):
        fn = lambda: np.concatenate([sh.search_device(x, k, nprobe, refine_k=refine_k,
                                                      refine_store=store, backend=backend)[1]
                                     .cpu().numpy() for x in blocks])
        return recall_at_k(dist_counted(out["launches"], fn) if counted else fn(), gt, k)

    rec = {}
    for name, store in (("f32", f32), ("res_i8", res_store)):
        rec[name] = run(store)
        rec[f"{name} plain"] = run(store, "torch", counted=False)
        gap = abs(rec[name] - rec[f"{name} plain"])
        say(f"  S=4 IVF-PQ, {name} refine store row-sharded: recall@10 {rec[name]:.4f} with the "
            f"kernels, {rec[f'{name} plain']:.4f} on their plain versions")
        check(gap <= RECALL_GAP, f"S=4 {name}: kernel recall vs plain: gap {gap}")

    # key against dma candidates on the same shards, each refined by sharded_refine
    def refined(for_refine):
        def fn():
            ids = []
            for x in blocks:
                _, cand = sh.search_device(x, refine_k, nprobe, for_refine=for_refine)
                ids.append(sharded_refine(mesh, x, cand, f32.vectors, None, k,
                                          norms2=f32.norms2())[1].cpu().numpy())
            return recall_at_k(np.concatenate(ids), gt, k)
        return dist_counted(out["launches"], fn)
    rec["key"], rec["dma"] = refined(True), refined(False)
    say(f"  S=4 candidates refined on the shards: key {rec['key']:.4f}, dma {rec['dma']:.4f}")
    check(abs(rec["key"] - rec["dma"]) <= RECALL_GAP, "S=4 key vs dma recall gap")
    say(f"  recall@10 at total nprobe {nprobe}: S=4 {rec['f32']:.4f} (per-shard probe sets) "
        f"against single-device {ivf8['auto']['recall']:.4f}; residual-int8 S=4 "
        f"{rec['res_i8']:.4f} against {ivf8['res_auto']['recall']:.4f} (no gate)")
    out["recall"] = rec

    store1 = VectorStore.from_vecbin(p8["base.vecbin"], device=dev)
    x = blocks[0]
    kern, plain, runs = in_turns(
        torch, lambda: idx.search_device(x, k, nprobe, refine_k=refine_k, refine_store=store1),
        lambda: sh.search_device(x, k, nprobe, refine_k=refine_k, refine_store=f32), 10)
    say(f"  IVF-PQ batch B={b} nprobe {nprobe} refine {refine_k}: S=4 {kern:.4f} ms "
        f"{runs['kernel']} | single {plain:.4f} ms {runs['plain']} | ratio {kern / plain:.3f}")
    out["ms"]["ivfpq B=256"] = (kern, plain)
    kern, plain, runs = in_turns(
        torch, lambda: idx.search_device(x, refine_k, nprobe, for_refine=True),
        lambda: sh.search_device(x, refine_k, nprobe, for_refine=True), 10)
    say(f"    by parts: the candidates alone (coarse, fused key scan) S=4 {kern:.4f} "
        f"ms | single {plain:.4f} ms")
    out["ms"]["ivfpq B=256 candidates"] = (kern, plain)
    del idx, sh, f32, res_store, store1, blocks, qpad
    torch.cuda.empty_cache()


def dist_partition(torch, dev, work, out):
    """15d: phase 11's partition index over four shards of cuda:0 (nprobe
    32, rerank 50) against its plain sharded path; IVF-Flat full probing on
    a small index of the hard corpus against the flat kernel."""
    from nvdb_tpu_torch.dist import mesh as meshmod
    from nvdb_tpu_torch.dist.sharded_ivf import ShardedIVFFlatIndex, ShardedPartitionIndex
    from nvdb_tpu_torch.eval.recall import recall_at_k
    from nvdb_tpu_torch.formats import gtbin, vecbin
    from nvdb_tpu_torch.index.flat import FlatIndex
    from nvdb_tpu_torch.index.ivf_flat import IVFFlatIndex
    from nvdb_tpu_torch.index.partition import PartitionRerankIndex
    from nvdb_tpu_torch.store import VectorStore

    p11 = work_paths(work, "hard", ("base.vecbin", "q.vecbin", "gt.gtbin", "pr.npz"))
    base = vecbin.VecbinFile(p11["base.vecbin"]).rows_f32()
    queries = vecbin.VecbinFile(p11["q.vecbin"]).rows_f32()
    gt = np.asarray(gtbin.read_gtbin(p11["gt.gtbin"])[1])
    pr = PartitionRerankIndex.load(p11["pr.npz"], refine_rows=base, device=dev)
    mesh = meshmod.row_mesh(4, devices=[dev] * 4)
    sh = ShardedPartitionIndex.from_index(pr, mesh)
    k, nprobe, rerank_k, b = 10, 32, 50, 64
    _, ids = dist_counted(out["launches"], sh.search, queries, k, nprobe, rerank_k=rerank_k,
                          q_chunk=b)
    _, pids = sh.search(queries, k, nprobe, rerank_k=rerank_k, q_chunk=b, backend="torch")
    _, sids = pr.search(queries, k, nprobe, rerank_k=rerank_k)
    r, rp, r1 = (recall_at_k(x, gt, k) for x in (ids, pids, sids))
    say(f"  S=4 partition nprobe {nprobe} rerank {rerank_k}: recall@10 {r:.4f} with the "
        f"kernels, {rp:.4f} plain; single-device {r1:.4f} (no gate)")
    check(abs(r - rp) <= RECALL_GAP, f"S=4 partition: kernel recall {r} vs plain {rp}")
    out["recall"]["partition"] = (r, rp, r1)
    q = torch.zeros((b, pr.ivf.centroids.shape[1]), device=dev)
    q[:, :pr.ivf.d] = torch.from_numpy(queries[:b]).to(dev)
    kern, plain, runs = in_turns(
        torch, lambda: pr.search_device(q, k, nprobe, rerank_k=rerank_k),
        lambda: sh.search_device(q, k, nprobe, rerank_k=rerank_k), 10)
    say(f"  partition batch B={b}: S=4 {kern:.4f} ms {runs['kernel']} | single {plain:.4f} ms "
        f"{runs['plain']} | ratio {kern / plain:.3f}")
    out["ms"]["partition B=64"] = (kern, plain)
    del pr, sh
    torch.cuda.empty_cache()

    # a small IVF-Flat index probed in full equals the exact scan
    rows = base[:65536]
    ivf = IVFFlatIndex.build(rows, nlist=64, dtype="f32", device=dev)
    six = ShardedIVFFlatIndex.from_index(ivf, mesh)
    v, i = dist_counted(out["launches"], six.search, queries[:64], k, six.nlist)
    fv, fi = FlatIndex(VectorStore.from_numpy(rows, "f32", device=dev)).search(queries[:64], k)
    err = float(np.abs(v - fv).max())
    say(f"  IVF-Flat {rows.shape[0]} x {rows.shape[1]} f32 nlist 64, S=4, full probing: "
        f"|values - flat kernel| "
        f"{err:.3e}, ids equal at {float(np.mean(i == fi)):.4f} of positions")
    check(err <= VALUE_ATOL + VALUE_RTOL, f"IVF-Flat full probing vs flat: {err}")
    ids_near_equal("IVF-Flat full probing vs flat kernel", p11["base.vecbin"], queries[:64],
                   i, fi)
    del ivf, six, base
    torch.cuda.empty_cache()


def dist_multiprocess(torch, dev, work, out):
    """15e: two ranks on localhost over gloo (one card: NCCL refuses two
    ranks on one device), each with two shards on cuda:0 and its half of
    phase 4's bench vecbin (``load_sharded``): both ranks' ids equal, and
    equal to the one-process sharded search over the same four shards."""
    from nvdb_tpu_torch.dist import _worker
    from nvdb_tpu_torch.dist import mesh as meshmod
    from nvdb_tpu_torch.dist.sharded import ShardedFlatIndex
    from nvdb_tpu_torch.formats import vecbin
    from nvdb_tpu_torch.store import ShardedVectorStore

    p4 = work_paths(work, "bench", ("base.vecbin", "q.vecbin"))
    qpath = os.path.join(work, "dist_q.npy")
    queries = vecbin.VecbinFile(p4["q.vecbin"]).rows_f32()
    np.save(qpath, queries)
    k = 10
    t0 = time.perf_counter()
    runs = _worker.run_ranks([p4["base.vecbin"], qpath, str(k), work, "--device", str(dev),
                              "--shards-per-rank", "2", "--row-block", "4096"],
                             nproc=2, timeout=240)
    for rank, (rc, text) in enumerate(runs):
        for line in text.strip().splitlines():
            say(f"    rank {rank}: {line}")
        check(rc == 0 and f"OK rank={rank}" in text, f"rank {rank} exited {rc}")
        check("backend=gloo" in text and "global_devices=4" in text,
              f"rank {rank}: not a two-process gloo mesh of four shards")
    ids = [np.load(os.path.join(work, f"ids_{r}.npy")) for r in range(2)]
    mesh = meshmod.row_mesh(4, devices=[dev] * 4)
    _, one = ShardedFlatIndex(ShardedVectorStore.from_vecbin(p4["base.vecbin"], mesh,
                                                             row_block=4096)).search(queries, k)
    check(np.array_equal(ids[0], ids[1]), "the two ranks' ids differ")
    check(np.array_equal(ids[0], one), "the ranks' ids differ from the one-process search")
    say(f"  two ranks ({time.perf_counter() - t0:.1f} s): ids equal to each other and to the "
        f"one-process sharded search over the same four shards")


def phase_dist(torch, dev, work, p8, ivf8):
    from nvdb_tpu_torch.dist.dryrun import dryrun_multichip

    out = {"launches": {}, "ms": {}}
    for sub, fn, args in (("a flat", dist_flat, ()),
                          ("b Lloyd", dist_lloyd, (p8["base.vecbin"],)),
                          ("c IVF-PQ", dist_ivfpq, (work, p8, ivf8)),
                          ("d partition and IVF-Flat", dist_partition, (work,)),
                          ("e two processes", dist_multiprocess, (work,))):
        say(f"  [15{sub}]")
        wall(f"15{sub.split()[0]} in all", fn, torch, dev, *args, out)
    say("  [15f dry run]")
    wall("15f in all", dist_counted, out["launches"], dryrun_multichip, 4, devices=[dev] * 4)
    for path, (sharded, single) in out["ms"].items():
        say(f"  device ms, {path}: sharded {sharded:.4f} against single-device {single:.4f}")
    out["launches"] = {key: c for key, c in out["launches"].items() if c}
    say(f"  launches on the dist paths: {out['launches']}")
    for name in ("flat_topk.bf16", "flat_topk.int8") + DIST_KERNELS:
        check(out["launches"].get(name, 0) > 0, f"the dist paths did not launch {name}")
    return out


# phase 16: each tool's runs, and the kernels each must launch there
TOOL_KERNELS = {"kernel_ab": ("flat_topk.bf16", "flat_topk.f32_tensor_core",
                              "flat_topk.f32_simt"),
                "refine_ab": ("rerank_topk",),
                "adc_ab": ("adc_topk", "adc_topk_key", "adc_topk_gather"),
                "coverage_probe": (),
                "adc_rank_probe": ("adc_tables",),
                "multiproc_bench": ("adc_fused_key", "rerank_topk")}
ADC_AB_SHAPES = (("flagship", ["--b", "256", "--p", "64", "--m", "96", "--lcap", "640",
                               "--k", "100"]),
                 ("JAX defaults", []))


def tools_counted(out, tool, main, argv, keep=("RESULT",)):
    """One tool run with every count set to 0 just before it; its counts
    join ``out[tool]``. Returns what the tool's ``main`` returns."""
    counts = out.setdefault(tool, {})
    return dist_counted(counts, run_tool, main, argv, keep=keep)


def phase_tools_ab(torch, dev, p8, ivf8):
    """Phase 16: the A/B tools and the recall probes at the flagship shapes,
    each run's launches counted from 0 (``TOOL_KERNELS``); a failed check in
    a tool exits the run."""
    from nvdb_tpu_torch.tools import (adc_ab, adc_rank_probe, coverage_probe, kernel_ab,
                                      multiproc_bench, refine_ab)

    launches = {}
    for dtype, arms in (("bf16", "kernel,library"), ("f32", "kernel,simt,library")):
        wall(f"16a kernel_ab {dtype}", tools_counted, launches, "kernel_ab", kernel_ab.main,
             ["--dtype", dtype, "--batches", "512,8", "--ks", "10", "--arms", arms,
              "--pairs", "5", "--iters", "10", "--check"])
    torch.cuda.empty_cache()
    wall("16b refine_ab bf16", tools_counted, launches, "refine_ab", refine_ab.main,
         ["--batches", "8,64,256", "--rs", "50,100", "--pairs", "5", "--chain", "20",
          "--check"])
    torch.cuda.empty_cache()
    for shape, flags in ADC_AB_SHAPES:
        for mode in ("gen4", "gen5", "gen6"):
            wall(f"16c adc_ab {mode} ({shape})", tools_counted, launches, "adc_ab",
                 adc_ab.main, ["--mode", mode, "--pairs", "5", "--chain", "10"] + flags)
        torch.cuda.empty_cache()
    files = [p8["index.npz"], p8["q.vecbin"], p8["gt.gtbin"]]
    cov, _ = wall("16d coverage_probe", tools_counted, launches, "coverage_probe",
                  coverage_probe.main, files + ["--nprobe", "16", "32", "64", "128", "256"],
                  keep=("N=", "nprobe=", "gt-list"))
    cov4, _ = wall("16d coverage_probe --shards 4", tools_counted, launches, "coverage_probe",
                   coverage_probe.main, files + ["--nprobe", "64", "--shards", "4"],
                   keep=("nprobe=",))
    rank = {}
    for mode in ("f32", "bf16lut", "bf16score"):
        rank[mode], _ = wall(f"16e adc_rank_probe {mode}", tools_counted, launches,
                             "adc_rank_probe", adc_rank_probe.main,
                             files + ["--nprobe", "64", "--rk", "10", "32", "64", "100", "128",
                                      "256", "1024", "--score-mode", mode],
                             keep=("FINAL",))
        torch.cuda.empty_cache()
    for mode in ("bf16lut", "bf16score"):
        gap = max(abs(rank[mode][r] - rank["f32"][r]) for r in rank["f32"])
        say(f"  adc_rank_probe {mode} against f32: largest gap {gap:.4f}")
    measured = ivf8["auto"]["recall"]
    c64, r100 = cov["coverage"][64], rank["f32"][100]
    say(f"  IVF-PQ recall@10 split at nprobe 64, refine 100: placed {cov['placed']:.6f}, "
        f"coverage@64 {c64:.4f}, ADC top-100 recall {r100:.4f} (f32; bf16lut "
        f"{rank['bf16lut'][100]:.4f}, bf16score {rank['bf16score'][100]:.4f}), P(ADC rank <= 100 "
        f"| covered) {r100 / c64:.4f}; ivf_eval measured {measured:.4f}; coverage@64 of the "
        f"S = 4 probe set (16 a shard) {cov4['coverage'][64]:.4f}")
    check(r100 <= c64 + 1e-9, f"ADC top-100 recall {r100} above the coverage {c64}")
    recs, _ = wall("16f multiproc_bench", tools_counted, launches, "multiproc_bench",
                   multiproc_bench.main, [])
    a, b = recs
    check(a["recall"] == b["recall"], f"multiproc_bench: rank 0's recall {b['recall']} != "
                                      f"one process's {a['recall']}")
    say(f"  multiproc_bench: ms/query 1proc {a['total_avg_ms']} 2proc {b['total_avg_ms']}, "
        f"recall {a['recall']} both")
    for tool, names in TOOL_KERNELS.items():
        for name in names:
            check(launches[tool].get(name, 0) > 0, f"{tool} did not launch {name}")
    total = {}
    for counts in launches.values():
        add_launches(total, counts)
    total = {name: c for name, c in total.items() if c}
    say(f"  launches in phase 16: {total}")
    return {"launches": total}


@contextlib.contextmanager
def phase(title):
    say(title)
    t0 = time.perf_counter()
    yield
    say(f"  ({time.perf_counter() - t0:.1f} s)")


# measurement builds of the probe source (phase 12's split of a call)
PROBE_ABLATIONS = (("pass 0", ("NVDB_PROBE_ABLATE=1",)), ("passes 0 + 1", ("NVDB_PROBE_ABLATE=2",)))


def build_all(torch):
    """Build every kernel library and the measurement builds of the probe
    and ADC sources, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from nvdb_tpu_torch.kernels import _build

    jobs = [(name, ()) for name in KERNELS] + [
        ("ivf_probe_topk", defines) for _, defines in PROBE_ABLATIONS] + [
        ("adc_topk", defines) for _, defines in FUSED_ABLATIONS]
    with ThreadPoolExecutor(len(jobs)) as ex:
        infos = list(ex.map(lambda job: _build.build(*job), jobs))
    return {(name if not defines else f"{name} {' '.join(defines)}"): info
            for (name, defines), info in zip(jobs, infos)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py runs on a GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi_line()
    say(f"[1 device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"nvidia-smi: {smi} | torch {torch.__version__} CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    infos = build_all(torch)
    say(f"[2 build] {len(infos)} libraries in {time.perf_counter() - t0:.2f} s wall")
    for name, info in infos.items():
        say(f"  {name}: {info['seconds']:.2f} s (cached={info['cached']})")
        for line in info["log"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                say(f"    {line.strip()}")

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        with phase("[3 kernel vs plain] 65,536 x 768, n_valid 65,000 "
                   f"(regret <= {REGRET_TOL}, |kernel - plain| <= {VALUE_ATOL} + {VALUE_RTOL} "
                   f"rel, id agreement >= {ID_AGREE_MIN})"):
            max_err = phase_kernel_vs_plain(torch, dev)

        with phase("[4 main path] 1M x 768 bf16 store, FlatIndex.search, then tools.bench"):
            launches = phase_main_path(torch, dev)
            add_launches(launches, phase_tools_bench(torch, dev, work))

        with phase("[5 times] 1M x 768, CUDA events over chained scans, "
                   "plain/kernel/kernel/plain"):
            times = phase_times(torch, dev)

        with phase("[6 ADC kernels vs plain] M = 96, dsub = 8, Lcap = 640 (tables: >= "
                   f"{TABLE_EQUAL_MIN} bit-equal, the rest one bf16 step; scan: |kernel - plain| "
                   f"<= {ADC_ATOL}, id agreement >= {ID_AGREE_MIN}, no duplicate ids; key and "
                   f"gather: bit for bit their plain version and each other, id overlap with "
                   f"dma >= {KEY_OVERLAP_MIN}; the fused scans bit for bit the two-kernel "
                   f"routes)"):
            adc = phase_adc_vs_plain(torch, dev)
            say(f"  tables: least bit-equal share {adc['table_equal']:.6f}, largest "
                f"|kernel - plain| {adc['table_err']:.3e}; scan: largest |kernel - plain| "
                f"{adc['scan_err']:.3e}")

        with phase("[7 rerank kernel vs plain] 65,536 x 768 "
                   f"(regret <= {REGRET_TOL}, |kernel - plain| <= {VALUE_ATOL} + "
                   f"{VALUE_RTOL} rel)"):
            rerank_err = phase_rerank_vs_plain(torch, dev)

        with phase("[8 IVF-PQ main path] 1M x 768, nlist 4096, m 96, OPQ; nprobe 64, "
                   "refine 100: auto (key), the key A/B, dma, the dma A/B, gather, the gather "
                   "A/B, torch; "
                   "then the residual-int8 refine on both paths"):
            idx, store, queries, ivf, ivf_paths = phase_ivf_main_path(torch, dev, work)
            spilled8 = idx.n_spilled

        with phase("[9 IVF-PQ times] each stage alone, CUDA events over chained calls, "
                   "plain/kernel/kernel/plain; the rerank kernel alone in a CUDA graph"):
            ivf_times = phase_ivf_times(torch, dev, idx, store, queries)
            del idx, store, queries
            torch.cuda.empty_cache()

        with phase("[10 IVF probe kernel vs plain] Dp 768, Lcap 384 / 992 "
                   f"(regret <= {REGRET_TOL}, |kernel - plain| <= {VALUE_ATOL} + {VALUE_RTOL} "
                   f"rel, id agreement >= {ID_AGREE_MIN}, no duplicate ids)"):
            probe_err = phase_probe_vs_plain(torch, dev)

        with phase("[11 partition main path] 1M x 768 hard corpus, nlist 2048 (sqrt-auto), "
                   "bf16 pad 2.0 S 8, f32 rerank 50; then IVF-Flat nlist 4096 bf16"):
            pidx, fidx, base, queries, part = phase_partition_main_path(torch, dev, work)

        with phase("[12 probe times] CUDA events over chained calls, "
                   "plain/kernel/kernel/plain"):
            probe_times = phase_probe_times(torch, dev, pidx, fidx, base, queries)
            del pidx, fidx, base, queries
            torch.cuda.empty_cache()

        with phase("[13 hbm_probe and gpu_sanity] 1M x 768 bf16 (1.54 GB), 20 launches "
                   "per probe"):
            hbm = phase_hbm_and_sanity(torch, dev)
            ceiling = hbm["ceiling_gbps"]
            say(f"  HBM ceiling (best probe): {ceiling:.1f} GB/s")
            for name in ("partition", "ivfflat"):
                t = probe_times[name]
                gbps = t["bytes"] / t["ms"] / 1e6
                say(f"  probe {name} (list-major): {gbps:.1f} GB/s of distinct bytes = "
                    f"{gbps / ceiling:.3f} of the ceiling")

        with phase("[14 build side and data tools] IVF-PQ repacked (pad 4.0, S 8) and "
                   "replicated (R 2, pad 2.0) from phase 8's index, nprobe 16/32/64 refine "
                   "50; IVF-Flat with 2 corpus passes and repacked (pad 2.0, S 8) from phase "
                   "11's; gt_build (device, chunked, host), slice, search, ab_compare, "
                   "convert_bf16, dump, sanity"):
            b14 = phase_build_side(torch, dev, work, ivf_paths, spilled8, part)

        with phase("[15 dist] shards of cuda:0 (views): flat over phase 4's 1M x 768 bf16 "
                   "and int8 stores at S = 4 and bf16 at S = 3, B = 512; a Lloyd step at "
                   "S = 4; IVF-PQ on phase 8's index, ivf_eval --force-sharded --shards 1 and "
                   "S = 4 with row-sharded f32 and residual-int8 refine stores; partition on "
                   "phase 11's index at S = 4; IVF-Flat full probing; two ranks over gloo; "
                   "the dry run"):
            d15 = phase_dist(torch, dev, work, ivf_paths, ivf)

        with phase("[16 A/B tools and recall probes] kernel_ab bf16 and f32 1M x 768 B = 512 "
                   "and 8; refine_ab bf16 1M x 768 B 8/64/256 R 50/100; adc_ab gen4/gen5/gen6 "
                   "at the flagship shape and the JAX defaults; coverage_probe and "
                   "adc_rank_probe on phase 8's index; multiproc_bench, two gloo ranks"):
            t16 = phase_tools_ab(torch, dev, ivf_paths, ivf)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    say(smi)
    pl = part["launches"]
    bl = b14["launches"]
    dl = d15["launches"]
    tl = t16["launches"]
    # the flat kernel's launches by instance over phases 4, 8, 11, 14 and 15
    flat = add_launches(add_launches(dict(launches), ivf["launches"]["flat_topk"]),
                        pl["flat_topk"])
    for later in (bl, dl, tl):
        add_launches(flat, {key.split(".", 1)[1]: c for key, c in later.items()
                            if key.startswith("flat_topk.")})
    say(f"flat kernel launches by instance, phases 4, 8, 11, 14, 15 and 16: {flat}")
    # the dist paths' and the tools' launches of the other kernels
    dist = {name: dl.get(name, 0) + tl.get(name, 0)
            for name in DIST_KERNELS + ("adc_tables", "adc_query_terms", "adc_topk",
                                        "adc_topk_key", "adc_topk_gather")}
    rows = [
        ("flat_topk", "flat_topk", "nvdb_tpu/kernels/flat_scan.py:417",
         flat.get("bf16", 0) + flat.get("int8", 0) + flat.get("int8_int8", 0),
         max_err["flat_topk"], times["bf16 B=512 k=10"]),
        ("flat_topk_f32", "flat_topk", "nvdb_tpu/kernels/flat_scan.py:417",
         flat.get("f32_tensor_core", 0), max_err["f32_tensor_core"], times["f32 B=512 k=10"]),
        # the A/B, on no default path: its launches are phase 14's SIMT ground truth
        ("flat_topk_f32_simt", "flat_topk", "nvdb_tpu/kernels/flat_scan.py:417",
         flat.get("f32_simt", 0), max_err["f32_simt"], times["f32 B=512 k=10 simt"]),
        # the tables and the staged dma scan: the A/Bs (phase 8's --key-scan
        # tables runs, phase 16's tools), on no default path since this slice
        ("adc_tables", "adc_tables", "nvdb_tpu/kernels/pq.py:89",
         ivf["launches"]["adc_tables"] + bl.get("adc_tables", 0) + dist["adc_tables"],
         adc["table_err"],
         ivf_times["adc_tables"]),
        ("adc_topk", "adc_topk", "nvdb_tpu/kernels/adc_scan.py:558",
         ivf["launches"]["adc_topk"] + bl.get("adc_topk", 0) + dist["adc_topk"],
         adc["scan_err"], ivf_times["adc_topk"]),
        # the dma site of the IVF-PQ path (ADC-only searches, replicated and
        # holed indexes, the sharded IVF-PQ): the fused dma scan, bit for bit
        # the staged route and its plain version in phases 6 and 9
        ("adc_fused_dma", "adc_topk", "nvdb_tpu/kernels/adc_scan.py:758",
         ivf["launches"]["adc_fused_dma"] + bl["adc_fused_dma"] + dist["adc_fused_dma"],
         adc["fused_dma_err"], ivf_times["adc_fused_dma"]),
        # bit for bit their plain version in phase 6, so their error is 0
        ("adc_topk_key", "adc_topk", "nvdb_tpu/kernels/adc_scan.py:691",
         ivf["launches"]["adc_topk_key"] + bl.get("adc_topk_key", 0) + dist["adc_topk_key"],
         0.0,
         ivf_times["adc_topk_key"]),
        # the gather site: the fused key scan reads each probed list in place;
        # bit for bit the key kernel, the slab kernel and their plain version in
        # phases 6 and 9, so its error is 0. Its launches are phase 8's gather run's
        ("adc_fused_gather", "adc_topk", "nvdb_tpu/kernels/adc_scan.py:718",
         ivf["launches"]["adc_fused_gather"], 0.0, ivf_times["adc_fused_gather"]),
        # the gather site's A/B: the kernel over the gathered code slab
        ("adc_topk_gather", "adc_topk", "nvdb_tpu/kernels/adc_scan.py:718",
         ivf["launches"]["adc_topk_gather"] + dist["adc_topk_gather"], 0.0,
         ivf_times["adc_topk_gather"]),
        # the key mode of the IVF-PQ path: the key kernel's TPU counterpart and
        # the tables (nvdb_tpu/kernels/pq.py:89) in one kernel; bit for bit
        # the key kernel on the table kernel's tables in phase 6, so its error is 0
        ("adc_fused_key", "adc_topk", "nvdb_tpu/kernels/adc_scan.py:691",
         ivf["launches"]["adc_fused_key"] + bl.get("adc_fused_key", 0) + dist["adc_fused_key"],
         0.0,
         ivf_times["adc_fused_key"]),
        # the query's share of every table entry, once a query: launched by
        # each fused key and dma call; bit for bit its plain version in phase 9
        ("adc_query_terms", "adc_topk", "nvdb_tpu/kernels/pq.py:89",
         ivf["launches"]["adc_query_terms"] + bl.get("adc_query_terms", 0)
         + dist["adc_query_terms"], 0.0, ivf_times["adc_query_terms"]),
        ("rerank_topk", "rerank_topk", "nvdb_tpu/kernels/rerank.py:187",
         ivf["launches"]["rerank_topk"] + pl["pr"]["rerank_topk"] + bl["rerank_topk"]
         + dist["rerank_topk"], rerank_err, ivf_times["rerank_topk B=256"]),
        ("ivf_probe_topk", "ivf_probe_topk", "nvdb_tpu/kernels/ivf_scan.py:111",
         pl["pr"]["ivf_probe_topk"] + pl["ivfflat"]["ivf_probe_topk"] + bl["ivf_probe_topk"]
         + dist["ivf_probe_topk"], probe_err["list"], probe_times["partition"]),
        # the query-major A/B, on no path: its launches are phase 12's, in turns
        # with the list-major kernel
        ("ivf_probe_topk_query", "ivf_probe_topk", "nvdb_tpu/kernels/ivf_scan.py:111",
         probe_times["query launches"], probe_err["query"],
         dict(probe_times["partition"], ms=probe_times["partition"]["query_ms"])),
        ("hbm_stream", "hbm_stream", "scripts/hbm_probe.py:62",
         sum(hbm["stream_launches"].values()), hbm["stream_err"], hbm["hbm_stream"]),
        ("add1", "add1", "nvdb_tpu/tools/tpu_sanity.py:28", hbm["add1_launches"],
         hbm["add1_err"], hbm["add1"]),
    ]
    say(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"nvdb_tpu_torch/kernels/csrc/{lib}.cu",
        "replaces": replaces,
        "launches": n_launch,
        "max_abs_err": err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t.get("library_ms"),
    } for name, lib, replaces, n_launch, err, t in rows]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
